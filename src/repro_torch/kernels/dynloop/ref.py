"""Pure-numpy oracles for the load-dependent-trip and streaming kernels.

These recompute the final protected-array state of the speculative
kernels (``repro_torch.core.programs``: ``spmv_ldtrip``, ``bfs_front``,
``chase_sum``) and the cross-PE FIFO streaming kernels (``stream_dot``,
``filter_pipe``, ``stream_join`` — DESIGN.md §11) directly from their
inputs — independently of LoopIR — so tests can pin
``loopir.interpret`` (and therefore every engine, which is
differential-tested against the interpreter) to a second, hand-written
semantics.
"""

from __future__ import annotations

import numpy as np


def spmv_ldtrip_ref(deg, rp, cidx, val, x):
    """y[i] = sum_k val[rp[i]+k] * x[cidx[rp[i]+k]] over deg[i] entries;
    also returns the published rowlen array (= deg)."""
    rows = len(deg)
    y = np.zeros(rows, dtype=np.float64)
    for i in range(rows):
        for k in range(int(deg[i])):
            e = int(rp[i]) + k
            y[i] += val[e] * x[int(cidx[e])]
    return np.asarray(deg, dtype=np.float64).copy(), y


def bfs_front_ref(off0, front, nodeval, nodes):
    """visit[pos] = nodeval[front[pos]] + 1 for every frontier position;
    also returns the published foff array (= off0)."""
    visit = np.zeros(nodes, dtype=np.float64)
    levels = len(off0) - 1
    for t in range(levels):
        lo, hi = int(off0[t]), int(off0[t + 1])
        for pos in range(lo, hi):
            visit[pos] = nodeval[int(front[pos])] + 1.0
    return np.asarray(off0, dtype=np.float64).copy(), visit


def chase_sum_ref(nxt, w, steps):
    """out[i] = w[p] + p where p walks the ``nxt`` chain from node 0 for
    ``steps`` steps (``laps`` full traversals of the n-node cycle)."""
    out = np.zeros(steps, dtype=np.float64)
    cur = 0
    for i in range(steps):
        p = int(nxt[cur])
        out[i] = w[p] + p
        cur = p
    return out


def strided_scan_ref(ptr, w, n):
    """out[i] = w[i] + p where p walks ``ptr`` from 0 (p = ptr[p_prev],
    an arithmetic sequence stored in memory)."""
    out = np.zeros(n, dtype=np.float64)
    cur = 0
    for i in range(n):
        p = int(ptr[cur])
        out[i] = w[i] + p
        cur = p
    return out


def stream_dot_ref(a, bv, out0, nb, k):
    """out[b] = out0[b] + sum_j a[b*k+j] * bv[b*k+j] (streamed partial
    sum folded into the writer leaf's read-modify-write)."""
    out = np.array(out0, dtype=np.float64, copy=True)
    for b in range(nb):
        ps = 0.0
        for j in range(k):
            ps = ps + a[b * k + j] * bv[b * k + j]
        out[b] = out[b] + ps
    return out


def filter_pipe_ref(x, y0):
    """y[e] = tanh(x[e]) * 0.5 + 1.0 where tanh(x[e]) > 0, else y0[e]
    (the streamed token decides the guarded store's valid bit)."""
    y = np.array(y0, dtype=np.float64, copy=True)
    for e in range(len(x)):
        v = float(np.tanh(x[e]))
        if v > 0.0:
            y[e] = v * 0.5 + 1.0
    return y


def stream_join_ref(u, w, z0):
    """z[t] = z0[t] + (u[t]*2 + (w[t]+1)) — two producer streams joined
    by a memory-less PE, result streamed to the writer."""
    z = np.array(z0, dtype=np.float64, copy=True)
    for t in range(len(u)):
        z[t] = z[t] + (u[t] * 2.0 + (w[t] + 1.0))
    return z
