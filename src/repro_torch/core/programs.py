"""The paper's evaluation benchmarks (§7.2) expressed in LoopIR.

Table 1 lists nine kernels (the text says "ten benchmarks"; the table
has nine rows — we implement the nine of Table 1):

  RAWloop / WARloop / WAWloop — two sibling loops, one access each,
      forming the named cross-loop dependency (theoretical-speedup
      microbenchmarks),
  bnn        — sparse binarized NN layer: two loops with data-dependent
      CSR accesses, user-asserted monotonic (§3.3),
  pagerank   — CSR graph iteration; two regular loops separated by the
      irregular loop; wrap-around dependencies across outer iterations,
  fft        — stage loop with multiplicative-IVar (non-affine,
      monotonic) strides; middle loop unrolled by 2 into sibling nests,
  matpower   — sparse matrix power, outer loop unrolled by 2 into two
      chained SpMV nests,
  hist+add   — two histogram loops (data-dependent, *non*-monotonic
      stores) + an addition loop; STA can fuse the two histograms,
  tanh+spmv  — tanh with a store under an if-condition (§6 speculation)
      feeding a sorted-COO SpMV.

Each entry provides ``make(scale)`` returning (Program, arrays, params).
Sizes scale linearly so tests run tiny and benchmarks run larger.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.loopir import (
    Bin,
    Const,
    IVar,
    Load,
    LoadVal,
    Local,
    Loop,
    MonotonicHint,
    Param,
    Program,
    Read,
    SetLocal,
    Store,
    Un,
    Var,
)

V = Var
R = Read


@dataclasses.dataclass
class Bench:
    name: str
    make: Callable[[int], tuple[Program, dict[str, np.ndarray], dict[str, int]]]
    complexity: str
    default_scale: int
    # True for kernels whose AGU depends on protected load values: they
    # run only under simulate(speculation="auto") (DESIGN.md §10); the
    # DSE result identity folds the speculation axis for the rest
    speculative: bool = False
    # True for kernels that communicate scalars between PEs over bounded
    # cross-PE FIFO edges (core/fifo, DESIGN.md §11) — the streaming
    # benchmark set (benchmarks/bench_stream.py, fifo_depth DSE axis)
    streaming: bool = False


REGISTRY: dict[str, Bench] = {}


def _register(name, complexity, default_scale, speculative=False,
              streaming=False):
    def deco(fn):
        REGISTRY[name] = Bench(
            name, fn, complexity, default_scale, speculative, streaming
        )
        return fn

    return deco


# ---------------------------------------------------------------------------
# RAW / WAR / WAW microbenchmarks
# ---------------------------------------------------------------------------


@_register("RAWloop", "O(n)", 4000)
def raw_loop(scale: int):
    n = scale
    prog = Program(
        name="RAWloop",
        loops=(
            Loop("i", Param("n", 0, n), (
                Store("st_a", "A", V("i"), R("d0", V("i")) * 2.0),
            )),
            Loop("j", Param("n", 0, n), (
                Load("ld_a", "A", V("j")),
                Store("st_b", "B", V("j"), LoadVal("ld_a") + 1.0),
            )),
        ),
        params=("n",),
    )
    rng = np.random.default_rng(0)
    arrays = {
        "A": np.zeros(n, dtype=np.float64),
        "B": np.zeros(n, dtype=np.float64),
        "d0": rng.standard_normal(n),
    }
    return prog, arrays, {"n": n}


@_register("WARloop", "O(n)", 4000)
def war_loop(scale: int):
    n = scale
    prog = Program(
        name="WARloop",
        loops=(
            Loop("i", Param("n", 0, n), (
                Load("ld_a", "A", V("i")),
                Store("st_b", "B", V("i"), LoadVal("ld_a") * 2.0),
            )),
            Loop("j", Param("n", 0, n), (
                Store("st_a", "A", V("j"), R("d0", V("j"))),
            )),
        ),
        params=("n",),
    )
    rng = np.random.default_rng(1)
    arrays = {
        "A": rng.standard_normal(n),
        "B": np.zeros(n, dtype=np.float64),
        "d0": rng.standard_normal(n),
    }
    return prog, arrays, {"n": n}


@_register("WAWloop", "O(n)", 4000)
def waw_loop(scale: int):
    n = scale
    prog = Program(
        name="WAWloop",
        loops=(
            Loop("i", Param("n", 0, n), (
                Store("st_0", "A", V("i"), R("d0", V("i"))),
            )),
            Loop("j", Param("n", 0, n), (
                Store("st_1", "A", V("j"), R("d1", V("j")) + 0.5),
            )),
        ),
        params=("n",),
    )
    rng = np.random.default_rng(2)
    arrays = {
        "A": np.zeros(n, dtype=np.float64),
        "d0": rng.standard_normal(n),
        "d1": rng.standard_normal(n),
    }
    return prog, arrays, {"n": n}


# ---------------------------------------------------------------------------
# bnn: sparse binarized NN layer — data-dependent monotonic accesses
# ---------------------------------------------------------------------------


@_register("bnn", "O(n^2)", 64)
def bnn(scale: int):
    # layer 1 scatters activations through a sorted sparse index set;
    # layer 2 gathers them through another sorted index set. Both
    # data-dependent — static fusion is impossible; the programmer
    # asserts per-row monotonicity (§3.3).
    rows, width = scale, scale
    rng = np.random.default_rng(3)
    nnz_per_row = max(2, width // 4)

    def sorted_rows(nrows):
        rp = [0]
        idx = []
        for _ in range(nrows):
            cols = np.sort(
                rng.choice(width, size=nnz_per_row, replace=False)
            )
            idx.extend(cols.tolist())
            rp.append(len(idx))
        return np.array(rp, dtype=np.int64), np.array(idx, dtype=np.int64)

    rp1, idx1 = sorted_rows(rows)
    rp2, idx2 = sorted_rows(rows)
    hint = MonotonicHint(innermost_monotonic=True, non_monotonic_outer=None)

    prog = Program(
        name="bnn",
        loops=(
            Loop("i", Param("rows", 0, rows), (
                Loop("k", R("rp1", V("i") + 1) - R("rp1", V("i")), (
                    Store(
                        "st_act", "act",
                        R("idx1", R("rp1", V("i")) + V("k")),
                        Un("sign", R("w1", R("rp1", V("i")) + V("k"))),
                        hint=hint,
                    ),
                )),
            )),
            Loop("i2", Param("rows", 0, rows), (
                Loop("k2", R("rp2", V("i2") + 1) - R("rp2", V("i2")), (
                    Load(
                        "ld_act", "act",
                        R("idx2", R("rp2", V("i2")) + V("k2")),
                        hint=hint,
                    ),
                    Store(
                        "st_out", "out",
                        R("rp2", V("i2")) + V("k2"),
                        Un("relu", LoadVal("ld_act") + 0.25),
                    ),
                )),
            )),
        ),
        params=("rows",),
    )
    arrays = {
        "act": np.zeros(width, dtype=np.float64),
        "out": np.zeros(len(idx2), dtype=np.float64),
        "rp1": rp1, "idx1": idx1, "w1": rng.standard_normal(len(idx1)),
        "rp2": rp2, "idx2": idx2,
    }
    return prog, arrays, {"rows": rows}


# ---------------------------------------------------------------------------
# pagerank: two regular loops around an irregular CSR loop, repeated
# ---------------------------------------------------------------------------


@_register("pagerank", "O(iters*(nodes+edges))", 256)
def pagerank(scale: int):
    nodes = scale
    iters = 4
    rng = np.random.default_rng(4)
    deg = rng.integers(1, 6, size=nodes)
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    cidx = np.concatenate(
        [np.sort(rng.choice(nodes, size=d, replace=False)) for d in deg]
    ).astype(np.int64)
    hint_inner = MonotonicHint(True, None)  # sorted within each row

    prog = Program(
        name="pagerank",
        loops=(
            Loop("t", Param("iters", 0, iters), (
                # regular loop 1: contributions
                Loop("i", Param("nodes", 0, nodes), (
                    Load("ld_rank", "rank", V("i")),
                    Store(
                        "st_c", "contrib", V("i"),
                        LoadVal("ld_rank") * R("invdeg", V("i")),
                    ),
                    Store("st_z", "acc", V("i"), Const(0.0)),
                )),
                # irregular CSR loop: gather + accumulate in memory
                Loop("i2", Param("nodes", 0, nodes), (
                    Loop("e", R("rp", V("i2") + 1) - R("rp", V("i2")), (
                        Load(
                            "ld_c", "contrib",
                            R("cidx", R("rp", V("i2")) + V("e")),
                            hint=hint_inner,
                        ),
                        Load("ld_acc", "acc", V("i2")),
                        Store(
                            "st_acc", "acc", V("i2"),
                            LoadVal("ld_acc") + LoadVal("ld_c"),
                        ),
                    )),
                )),
                # regular loop 2: damping + rank update (wrap-around RAW
                # into the next outer iteration's ld_rank)
                Loop("i3", Param("nodes", 0, nodes), (
                    Load("ld_acc2", "acc", V("i3")),
                    Store(
                        "st_rank", "rank", V("i3"),
                        LoadVal("ld_acc2") * 0.85 + 0.15,
                    ),
                )),
            )),
        ),
        params=("iters", "nodes"),
    )
    arrays = {
        "rank": np.full(nodes, 1.0 / nodes),
        "contrib": np.zeros(nodes, dtype=np.float64),
        "acc": np.zeros(nodes, dtype=np.float64),
        "rp": rp, "cidx": cidx,
        "invdeg": (1.0 / np.maximum(deg, 1)).astype(np.float64),
    }
    return prog, arrays, {"iters": iters, "nodes": nodes}


# ---------------------------------------------------------------------------
# fft: multiplicative-stride stages, middle loop unrolled by two
# ---------------------------------------------------------------------------


@_register("fft", "O(n log n)", 1024)
def fft(scale: int):
    n = scale
    assert n & (n - 1) == 0, "fft size must be a power of two"
    stages = int(np.log2(n))
    rng = np.random.default_rng(5)

    def nest(tag: str, odd: int):
        """One unrolled half: nest 0 processes even global groups (2g),
        nest 1 odd groups (2g+1). Butterfly on x[base], x[base+half].
        The group stride 2*half comes from the multiplicative IVar — the
        paper's non-affine, monotonic {., ×, 2} chain of recurrences.
        """
        g, t = f"g{tag}", f"t{tag}"
        base = (Var(g) * 2 + odd) * (Var("half") * 2) + Var(t)
        partner = base + Var("half")
        ngroups = Param("n", 0, n) // (Var("half") * 2)
        trip = (ngroups + (1 - odd)) // 2  # ceil for even nest, floor for odd
        return Loop(
            g,
            trip,
            (
                Loop(t, Var("half"), (
                    Load(f"ld_top{tag}", "x", base),
                    Load(f"ld_bot{tag}", "x", partner),
                    Store(
                        f"st_top{tag}", "x", base,
                        LoadVal(f"ld_top{tag}")
                        + R("tw", Var(t)) * LoadVal(f"ld_bot{tag}"),
                    ),
                    Store(
                        f"st_bot{tag}", "x", partner,
                        LoadVal(f"ld_top{tag}")
                        - R("tw", Var(t)) * LoadVal(f"ld_bot{tag}"),
                    ),
                )),
            ),
        )

    stage = Loop(
        "s",
        Param("stages", 0, stages),
        (
            nest("0", 0),
            nest("1", 1),
        ),
        ivars=(IVar("half", Const(1), "*", Const(2)),),
    )
    prog = Program(name="fft", loops=(stage,), params=("n", "stages"))
    arrays = {
        "x": rng.standard_normal(n),
        "tw": rng.standard_normal(n),
    }
    return prog, arrays, {"n": n, "stages": stages}


# ---------------------------------------------------------------------------
# matpower: CSR sparse matrix power, outer loop unrolled by two
# ---------------------------------------------------------------------------


@_register("matpower", "O(p * nnz)", 128)
def matpower(scale: int):
    nodes = scale
    powers = 2  # unroll factor 2 -> two chained SpMV nests per power
    rng = np.random.default_rng(6)
    deg = rng.integers(1, 5, size=nodes)
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    cidx = np.concatenate(
        [np.sort(rng.choice(nodes, size=d, replace=False)) for d in deg]
    ).astype(np.int64)
    hint = MonotonicHint(True, None)

    def spmv(tag: str, src: str, dst: str):
        i, e = f"i{tag}", f"e{tag}"
        return Loop(i, Param("nodes", 0, nodes), (
            Store(f"st_z{tag}", dst, V(i), Const(0.0)),
            Loop(e, R("rp", V(i) + 1) - R("rp", V(i)), (
                Load(
                    f"ld_x{tag}", src,
                    R("cidx", R("rp", V(i)) + V(e)),
                    hint=hint,
                ),
                Load(f"ld_y{tag}", dst, V(i)),
                Store(
                    f"st_y{tag}", dst, V(i),
                    LoadVal(f"ld_y{tag}")
                    + R("val", R("rp", V(i)) + V(e)) * LoadVal(f"ld_x{tag}"),
                ),
            )),
        ))

    prog = Program(
        name="matpower",
        loops=(
            Loop("p", Param("powers", 0, powers), (
                spmv("a", "x", "y"),
                spmv("b", "y", "x"),  # wrap-around into next power
            )),
        ),
        params=("powers", "nodes"),
    )
    arrays = {
        "x": rng.standard_normal(nodes),
        "y": np.zeros(nodes, dtype=np.float64),
        "rp": rp, "cidx": cidx, "val": rng.standard_normal(len(cidx)),
    }
    return prog, arrays, {"powers": powers, "nodes": nodes}


# ---------------------------------------------------------------------------
# hist+add: two (non-monotonic!) histogram loops + an addition loop
# ---------------------------------------------------------------------------


@_register("hist+add", "O(n)", 2048)
def hist_add(scale: int):
    n = scale
    # few-bin histograms (the common case): store-to-load forwarding hits
    # the pending buffer most iterations, as in the paper's evaluation
    bins = 32
    rng = np.random.default_rng(7)
    prog = Program(
        name="hist+add",
        loops=(
            Loop("i", Param("n", 0, n), (
                Load("ld_h1", "h1", R("d1", V("i"), 0, bins - 1)),
                Store(
                    "st_h1", "h1", R("d1", V("i"), 0, bins - 1),
                    LoadVal("ld_h1") + 1.0,
                ),
            )),
            Loop("j", Param("n", 0, n), (
                Load("ld_h2", "h2", R("d2", V("j"), 0, bins - 1)),
                Store(
                    "st_h2", "h2", R("d2", V("j"), 0, bins - 1),
                    LoadVal("ld_h2") + 1.0,
                ),
            )),
            Loop("k", Param("bins", 0, bins), (
                Load("ld_a1", "h1", V("k")),
                Load("ld_a2", "h2", V("k")),
                Store(
                    "st_sum", "hsum", V("k"),
                    LoadVal("ld_a1") + LoadVal("ld_a2"),
                ),
            )),
        ),
        params=("n", "bins"),
    )
    arrays = {
        "h1": np.zeros(bins, dtype=np.float64),
        "h2": np.zeros(bins, dtype=np.float64),
        "hsum": np.zeros(bins, dtype=np.float64),
        "d1": rng.integers(0, bins, size=n),
        "d2": rng.integers(0, bins, size=n),
    }
    return prog, arrays, {"n": n, "bins": bins}


# ---------------------------------------------------------------------------
# tanh+spmv: speculated store under an if-condition + sorted-COO SpMV
# ---------------------------------------------------------------------------


@_register("tanh+spmv", "O(n + nnz)", 512)
def tanh_spmv(scale: int):
    n = scale
    nnz = scale * 2
    rng = np.random.default_rng(8)
    # sorted COO: rows non-decreasing (asserted monotonic)
    rows = np.sort(rng.integers(0, n, size=nnz)).astype(np.int64)
    cols = rng.integers(0, n, size=nnz).astype(np.int64)
    hint_rows = MonotonicHint(True, None)

    prog = Program(
        name="tanh+spmv",
        loops=(
            Loop("i", Param("n", 0, n), (
                Load("ld_v", "v", V("i")),
                # §6: the store executes only when the guard holds — the
                # request is speculated in the AGU, the CU tags validity
                Store(
                    "st_v", "v", V("i"),
                    Un("tanh", LoadVal("ld_v")),
                    guard=Bin(">", LoadVal("ld_v"), Const(0.0)),
                ),
            )),
            Loop("e", Param("nnz", 0, nnz), (
                Load("ld_vv", "v", R("cols", V("e"), 0, n - 1)),
                Load("ld_y", "y", R("rows", V("e"), 0, n - 1), hint=hint_rows),
                Store(
                    "st_y", "y", R("rows", V("e"), 0, n - 1),
                    LoadVal("ld_y") + R("val", V("e")) * LoadVal("ld_vv"),
                    hint=hint_rows,
                ),
            )),
        ),
        params=("n", "nnz"),
    )
    arrays = {
        "v": rng.standard_normal(n),
        "y": np.zeros(n, dtype=np.float64),
        "rows": rows, "cols": cols, "val": rng.standard_normal(nnz),
    }
    return prog, arrays, {"n": n, "nnz": nnz}


# ---------------------------------------------------------------------------
# loss-of-decoupling kernels (speculation="auto" only, DESIGN.md §10)
# ---------------------------------------------------------------------------


@_register("spmv_ldtrip", "O(nnz)", 128, speculative=True)
def spmv_ldtrip(scale: int):
    """SpMV whose row lengths are *computed* by a sibling loop and read
    back through a protected load — the inner trip count depends on
    ``LoadVal``, so ``dae.decouple`` loses decoupling and only the
    speculative AGU can fuse the two loops. Row lengths are mostly
    uniform, so the last-value predictor runs ahead across rows."""
    rows = scale
    rng = np.random.default_rng(9)
    base_len = 4
    deg = np.full(rows, base_len, dtype=np.int64)
    # ~1/8 of rows deviate: real mispredictions + squash traffic, but
    # enough regularity that run-ahead wins
    odd = rng.random(rows) < 0.125
    deg[odd] = rng.integers(0, 2 * base_len + 1, size=int(odd.sum()))
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    nnz = int(rp[-1])
    cidx = rng.integers(0, rows, size=nnz).astype(np.int64)

    prog = Program(
        name="spmv_ldtrip",
        loops=(
            # producer: publish the (runtime-computed) row lengths
            Loop("i", Param("rows", 0, rows), (
                Store("st_len", "rowlen", V("i"), R("deg", V("i"))),
            )),
            # consumer: SpMV whose trip loads what the producer stored
            Loop("i2", Param("rows", 0, rows), (
                Load("ld_len", "rowlen", V("i2")),
                Store("st_z", "y", V("i2"), Const(0.0)),
                Loop("k", LoadVal("ld_len"), (
                    Load("ld_x", "x", R("cidx", R("rp", V("i2")) + V("k"))),
                    Load("ld_y", "y", V("i2")),
                    Store(
                        "st_y", "y", V("i2"),
                        LoadVal("ld_y")
                        + R("val", R("rp", V("i2")) + V("k")) * LoadVal("ld_x"),
                    ),
                )),
            )),
        ),
        params=("rows",),
    )
    arrays = {
        "rowlen": np.zeros(rows, dtype=np.float64),
        "deg": deg.astype(np.float64),
        "x": rng.standard_normal(rows),
        "y": np.zeros(rows, dtype=np.float64),
        "rp": rp, "cidx": cidx, "val": rng.standard_normal(max(nnz, 1)),
    }
    return prog, arrays, {"rows": rows}


@_register("bfs_front", "O(nodes)", 256, speculative=True)
def bfs_front(scale: int):
    """Front-driven BFS-style frontier gather: per-level frontier
    offsets are published by a producer loop and loaded back — both the
    level trip count (``hi - lo``) and the frontier addresses
    (``lo + k``) depend on protected load values. Trip/address
    speculation squashes once per level and streams within it."""
    nodes = scale
    levels = 8
    rng = np.random.default_rng(10)
    # random partition of the nodes into level frontiers
    cuts = np.sort(rng.choice(nodes, size=levels - 1, replace=False))
    off0 = np.concatenate([[0], cuts, [nodes]]).astype(np.int64)
    front = rng.permutation(nodes).astype(np.int64)

    prog = Program(
        name="bfs_front",
        loops=(
            Loop("t", Param("levels1", 0, levels + 1), (
                Store("st_off", "foff", V("t"), R("off0", V("t"))),
            )),
            Loop("t2", Param("levels", 0, levels), (
                Load("ld_lo", "foff", V("t2")),
                Load("ld_hi", "foff", V("t2") + 1),
                Loop("k", LoadVal("ld_hi") - LoadVal("ld_lo"), (
                    Load("ld_n", "front", LoadVal("ld_lo") + V("k")),
                    Store(
                        "st_v", "visit",
                        LoadVal("ld_lo") + V("k"),
                        R("nodeval", LoadVal("ld_n")) + 1.0,
                    ),
                )),
            )),
        ),
        params=("levels", "levels1"),
    )
    arrays = {
        "foff": np.zeros(levels + 1, dtype=np.float64),
        "off0": off0,
        "front": front.astype(np.float64),
        "visit": np.zeros(nodes, dtype=np.float64),
        "nodeval": rng.standard_normal(nodes),
    }
    return prog, arrays, {"levels": levels, "levels1": levels + 1}


@_register("chase_sum", "O(laps * n)", 256, speculative=True)
def chase_sum(scale: int):
    """Repeated linked-list pointer chase (the lmbench latency idiom):
    ``nxt`` is one n-node cycle, walked ``laps`` times from node 0. The
    next address round-trips through an AGU local fed by the loaded
    value — the worst case for the last-value predictor (every
    occurrence mispredicts, delivery-gated sequential issue), but the
    context-table predictor learns node -> successor on the first lap
    and runs ahead on the rest; confidence gating keeps lap 1 cheap
    (wait gates instead of squash storms). The kernel the predictor
    zoo turns from a documented non-win into a speedup (DESIGN.md
    §10, BENCH_SPEC.json)."""
    n = scale
    laps = 3
    steps = laps * n
    rng = np.random.default_rng(11)
    # a single n-cycle: following nxt from any node visits every node
    order = rng.permutation(n).astype(np.int64)
    nxt = np.empty(n, dtype=np.int64)
    nxt[order] = np.roll(order, -1)

    prog = Program(
        name="chase_sum",
        loops=(
            Loop("o", Const(1), (
                SetLocal("cur", Const(0)),
                Loop("i", Param("steps", 0, steps), (
                    Load("ld_nxt", "nxt", Local("cur")),
                    SetLocal("cur", LoadVal("ld_nxt")),
                    Store(
                        "st_o", "out", V("i"),
                        R("w", LoadVal("ld_nxt")) + LoadVal("ld_nxt"),
                    ),
                )),
            )),
        ),
        params=("steps",),
    )
    arrays = {
        "nxt": nxt.astype(np.float64),
        "out": np.zeros(steps, dtype=np.float64),
        "w": rng.standard_normal(n),
    }
    return prog, arrays, {"steps": steps}


@_register("strided_scan", "O(n)", 256, speculative=True)
def strided_scan(scale: int):
    """AGU-local induction through memory: the next pointer is loaded
    from ``ptr[cur]`` where the stored values form an arithmetic
    sequence (``cur + stride``) — a software-pipelined sparse scan
    whose index increment lives in memory. Loss of decoupling like
    ``chase_sum``, but the value stream is affine: the stride predictor
    locks on after two occurrences and runs the whole scan ahead, while
    last-value mispredicts every occurrence (DESIGN.md §10)."""
    n = scale
    stride = 3
    rng = np.random.default_rng(13)
    # ptr[k] = k + stride: following ptr from 0 yields stride, 2*stride,
    # ... — an arithmetic value sequence only visible through memory
    ptr = (np.arange(n * stride, dtype=np.int64) + stride)

    prog = Program(
        name="strided_scan",
        loops=(
            Loop("o", Const(1), (
                SetLocal("cur", Const(0)),
                Loop("i", Param("n", 0, n), (
                    Load("ld_p", "ptr", Local("cur")),
                    SetLocal("cur", LoadVal("ld_p")),
                    Store(
                        "st_o", "out", V("i"),
                        R("w", V("i")) + LoadVal("ld_p"),
                    ),
                )),
            )),
        ),
        params=("n",),
    )
    arrays = {
        "ptr": ptr.astype(np.float64),
        "out": np.zeros(n, dtype=np.float64),
        "w": rng.standard_normal(n),
    }
    return prog, arrays, {"n": n}


# ---------------------------------------------------------------------------
# streaming kernels: cross-PE scalar FIFO edges (core/fifo, DESIGN.md §11)
# ---------------------------------------------------------------------------


@_register("stream_dot", "O(nb * k)", 256, streaming=True)
def stream_dot(scale: int):
    """Streaming blocked dot-reduction: a reducer leaf accumulates a
    per-block partial sum in a CU local and streams it over a FIFO edge
    to a writer leaf that folds it into ``out[b]``. The two leaves share
    no memory — the producer-before-consumer ordering is carried purely
    by the bounded FIFO token per block instance."""
    nb = scale
    k = 8
    rng = np.random.default_rng(12)
    prog = Program(
        name="stream_dot",
        loops=(
            Loop("b", Param("nb", 0, nb), (
                SetLocal("ps", Const(0.0)),
                Loop("k", Param("k", 0, k), (
                    Load("ld_a", "a", V("b") * k + V("k")),
                    Load("ld_b", "bv", V("b") * k + V("k")),
                    SetLocal(
                        "ps",
                        Local("ps") + LoadVal("ld_a") * LoadVal("ld_b"),
                    ),
                )),
                Loop("w", Const(1), (
                    Load("ld_o", "out", V("b")),
                    Store(
                        "st_o", "out", V("b"),
                        LoadVal("ld_o") + Local("ps"),
                    ),
                )),
            )),
        ),
        params=("nb", "k"),
    )
    arrays = {
        "a": rng.standard_normal(nb * k),
        "bv": rng.standard_normal(nb * k),
        "out": rng.standard_normal(nb),
    }
    return prog, arrays, {"nb": nb, "k": k}


@_register("filter_pipe", "O(n)", 1024, streaming=True)
def filter_pipe(scale: int):
    """Two-stage filter pipeline: stage 1 loads and transforms each
    element into a CU local, stage 2 consumes the streamed value in both
    the store *value* and its §6 *guard* — a guarded store fed entirely
    through a FIFO edge (the valid bit is decided by the popped token)."""
    n = scale
    rng = np.random.default_rng(13)
    prog = Program(
        name="filter_pipe",
        loops=(
            Loop("e", Param("n", 0, n), (
                SetLocal("v", Const(0.0)),
                Loop("p", Const(1), (
                    Load("ld_x", "x", V("e")),
                    SetLocal("v", Un("tanh", LoadVal("ld_x"))),
                )),
                Loop("c", Const(1), (
                    Store(
                        "st_y", "y", V("e"),
                        Local("v") * 0.5 + 1.0,
                        guard=Bin(">", Local("v"), Const(0.0)),
                    ),
                )),
            )),
        ),
        params=("n",),
    )
    arrays = {
        "x": rng.standard_normal(n),
        "y": np.zeros(n, dtype=np.float64),
    }
    return prog, arrays, {"n": n}


@_register("stream_join", "O(n)", 512, streaming=True)
def stream_join(scale: int):
    """Two producers feed a memory-less join PE (no loads, no stores —
    pure FIFO-in/FIFO-out compute) whose result streams to a writer:
    a 4-PE dataflow diamond exercising multi-edge fan-in and a
    chained producer→join→consumer FIFO path."""
    n = scale
    rng = np.random.default_rng(14)
    prog = Program(
        name="stream_join",
        loops=(
            Loop("t", Param("n", 0, n), (
                SetLocal("a", Const(0.0)),
                Loop("p1", Const(1), (
                    Load("ld_u", "u", V("t")),
                    SetLocal("a", LoadVal("ld_u") * 2.0),
                )),
                SetLocal("b", Const(0.0)),
                Loop("p2", Const(1), (
                    Load("ld_w", "w", V("t")),
                    SetLocal("b", LoadVal("ld_w") + 1.0),
                )),
                SetLocal("j", Const(0.0)),
                Loop("m", Const(1), (
                    SetLocal("j", Local("a") + Local("b")),
                )),
                Loop("c", Const(1), (
                    Load("ld_z", "z", V("t")),
                    Store(
                        "st_z", "z", V("t"),
                        LoadVal("ld_z") + Local("j"),
                    ),
                )),
            )),
        ),
        params=("n",),
    )
    arrays = {
        "u": rng.standard_normal(n),
        "w": rng.standard_normal(n),
        "z": rng.standard_normal(n),
    }
    return prog, arrays, {"n": n}


def get(name: str) -> Bench:
    return REGISTRY[name]


def all_names() -> list[str]:
    return list(REGISTRY)


# The nine Table-1 kernels, in the paper's order. Frozen as an explicit
# list (NOT tuple(REGISTRY)): registering new kernels — e.g. the
# speculative ones above — must never silently grow the paper's
# evaluation set (benchmarks/paper_table1.py, test_engine_diff, nightly
# benchmarks). tests/test_speculation.py guards REGISTRY ⊇ TABLE1.
TABLE1: tuple[str, ...] = (
    "RAWloop",
    "WARloop",
    "WAWloop",
    "bnn",
    "pagerank",
    "fft",
    "matpower",
    "hist+add",
    "tanh+spmv",
)

# the loss-of-decoupling kernels, in registration order (the
# speculation benchmark set: benchmarks/bench_speculation.py)
SPEC_KERNELS: tuple[str, ...] = tuple(
    name for name, b in REGISTRY.items() if b.speculative
)

# the cross-PE FIFO streaming kernels, in registration order (the
# streaming benchmark set: benchmarks/bench_stream.py, DESIGN.md §11)
STREAM_KERNELS: tuple[str, ...] = tuple(
    name for name, b in REGISTRY.items() if b.streaming
)
