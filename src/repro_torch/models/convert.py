"""Carry the reference's parameters into the port.

``from_reference`` turns the JAX package's ``init_params`` pytree — a
nested dict of arrays, the layer weights stacked over a leading layer
axis (``layers.attn.wq`` is ``(L, d, nh·hd)``) — into the port's params
on a given device: the same keys, shapes and dtypes, the same bits
(float32 in gives the same float32 out). ``to_numpy`` goes back. The
arrays are read through ``numpy.asarray``, so JAX arrays need no import
of JAX here. The tests use it so that both packages compute with the
same weights; the card run draws its own with ``init_params``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_reference(tree, *, device="cuda"):
    """Nested dict of arrays -> nested dict of tensors on ``device``,
    bit for bit."""
    dev = resolve_device(device, "from_reference")
    return {k: from_reference(v, device=dev) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in tree.items()}


def to_numpy(params):
    """Nested dict of tensors -> nested dict of numpy arrays, bit for
    bit."""
    return {k: to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in params.items()}
