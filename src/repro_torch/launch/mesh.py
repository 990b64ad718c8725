"""Production mesh construction, over ``torch.distributed``.

The port of ``src/repro/launch/mesh.py``: functions, not module-level
constants, so importing touches no process group. Single pod: (16, 16) =
256 devices as ``("data", "model")``; multi-pod: (2, 16, 16) with a
leading ``"pod"`` axis (data parallelism across pods; params replicated
pod-wise, gradients reduced over ``("pod", "data")``).

The caller initialises the default process group, with one rank a
device: NCCL on the cards, gloo for the CPU tests, the fake backend for
the dry run (``fake_world``). Each function raises ``ValueError`` when
the group's world size is not the mesh's size.
"""

from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape, axes, device_type: str):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    default process group."""
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{n} ranks; the default group has {world or 'none'}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with
    ``"pod"`` in front, on ``device`` (``"cuda"``, the default, raises
    without a card; the dry run passes ``"cpu"``)."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, resolve_device(device, "mesh").type)


def make_host_mesh(data: int = 2, model: int = 4):
    """Small ``("data", "model")`` mesh on the CPU, for the multi-process
    CPU tests (gloo)."""
    return make_mesh((data, model), ("data", "model"), "cpu")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks in this one
    process, whose collectives move nothing (PyTorch's fake backend, from
    its internal testing package: the one route to a 256-rank mesh in
    one process). This process is rank 0. The group is destroyed on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
