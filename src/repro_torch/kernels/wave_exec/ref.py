"""Plain torch version of the wave-step kernel (``csrc/wave_exec.cu``).

Same signature and result as ``kernel.wave_step``/``kernel.wave_loop``:
a clipped gather against the pre-step image, then a masked
``index_copy_`` of the write lanes. The tests run it on the CPU against
the JAX package's kernel; on the card it is what the CUDA kernel is
compared with. Nothing on the main path calls it when a card is present.
"""

from __future__ import annotations

import numpy as np
import torch


def wave_step_ref(mem, addr, write, sval):
    """One step over ``mem`` (``(M,)`` int64, updated in place): returns
    ``(mem, vals)`` with ``vals[i] = mem_pre[clip(addr[i], 0, M-1)]``.
    Write lanes (``write`` true) then store ``sval`` at ``addr``; a write
    lane whose address is outside ``[0, M)`` is dropped."""
    m = mem.shape[0]
    a = addr.long()
    vals = mem[a.clamp(0, m - 1)]
    sel = write & (a >= 0) & (a < m)
    mem.index_copy_(0, a[sel], sval[sel])
    return mem, vals


def wave_loop_ref(mem, addrs, writes, svals):
    """``S`` steps of ``wave_step_ref`` over ``(S, W)`` tables; returns
    ``(mem, vals)`` with ``vals`` of shape ``(S, W)``."""
    vals = torch.empty(addrs.shape, dtype=torch.int64, device=mem.device)
    for s in range(addrs.shape[0]):
        _, vals[s] = wave_step_ref(mem, addrs[s], writes[s], svals[s])
    return mem, vals


NAN_BITS = 0x7FF8000000000000  # a quiet NaN; payload bits are ORed in


def random_tables(rng, m, s, w):
    """Seeded inputs for holding the kernel against this plain version:
    an ``(M,)`` int64 image with NaN payloads in one word of eight, and
    ``S`` steps of ``W`` lanes as numpy ``(addrs int32, writes bool,
    svals int64)``, ``W >= 8``. A quarter of each step's lanes (at most
    ``M-1``) write, to unique
    in-range addresses (never the scratch word ``M-1``); about half of
    the other lanes load from that step's write addresses (the WAR pair
    of WavePlan contract 5); three load lanes per step are out of range,
    so the gather clips."""
    mem = rng.integers(-2**62, 2**62, size=m, dtype=np.int64)
    n_nan = m // 8
    mem[rng.choice(m, size=n_nan, replace=False)] = NAN_BITS | rng.integers(
        1, 2**40, size=n_nan
    )
    addrs = np.empty((s, w), dtype=np.int32)
    writes = np.zeros((s, w), dtype=bool)
    n_w = min(max(w // 4, 1), m - 1)
    for j in range(s):
        waddr = rng.choice(m - 1, size=n_w, replace=False)
        laddr = rng.integers(0, m - 1, size=w - n_w)
        alias = rng.random(w - n_w) < 0.5
        laddr[alias] = rng.choice(waddr, size=int(alias.sum()))
        laddr[:3] = (-5, m, m + 100)
        perm = rng.permutation(w)
        addrs[j] = np.concatenate([waddr, laddr])[perm]
        writes[j] = (np.arange(w) < n_w)[perm]
    svals = rng.integers(-2**62, 2**62, size=(s, w), dtype=np.int64)
    svals[:, ::7] = NAN_BITS | 12345
    return mem, addrs, writes, svals
