"""The port's DSE sweep engine, result cache and calibration against the
JAX package's, on the CPU.

``repro_torch.dse`` is numpy and ``simulate()`` on the host, as the
reference's is. Held here:

  * ``sweep(...).rows()`` equal to the reference's, row for row, and
    every point's final arrays bit for bit, on ``tests/test_dse.py``'s
    grid for each of the nine Table-1 kernels (four modes, two sizings,
    both trace modes on the irregular kernels), the cycle engine, the
    STA engine fold and the SimParams projection;
  * every port row equal to the port's own standalone ``simulate()``;
  * the ``static_prune`` axis folding and caching as the reference's;
  * the result identity (``result_key``, ``result_projection``) equal
    to the reference's, with every ``RunConfig`` field keyed or inert;
  * the result cache: cold then warm, incremental growth, key
    sensitivity, and a code version over this package's own sources
    (so the port's keys differ from the reference's by design; rows are
    compared, never keys);
  * ``calibrate`` with small scales and coarse grids: the same fitted
    fields, fit curves and per-kernel cycles per iteration.
"""

import dataclasses
import hashlib
import os

import numpy as np
import pytest

from repro import dse as ref_dse
from repro.core import programs as ref_programs
from repro.dse import cache as ref_cachelib
from repro_torch import dse
from repro_torch.core import loopir as ir
from repro_torch.core import programs, simulator
from repro_torch.core.config import RunConfig
from repro_torch.dse import cache as cachelib

from test_torch_parity import canon

# tests/test_dse.py's scales and sizings
SCALES = {
    "RAWloop": 32, "WARloop": 32, "WAWloop": 32, "bnn": 16,
    "pagerank": 24, "fft": 64, "matpower": 16, "hist+add": 64,
    "tanh+spmv": 24,
}
SIZINGS = {"base": {}, "narrow": {"burst_size": 4, "dram_latency": 64}}
# kernels whose interp trace mode is also swept (CSR gathers,
# non-monotonic stores, multiplicative ivars)
INTERP_KERNELS = ("bnn", "hist+add", "fft")
VOLATILE = ("cached", "run_wall_s")


def _rows(res):
    return [{k: v for k, v in r.items() if k not in VOLATILE}
            for r in res.rows()]


def _assert_results_equal(got, want):
    """Rows equal (timing fields aside) and every point's arrays equal
    bit for bit."""
    assert canon(_rows(got)) == canon(_rows(want))
    assert len(got.points) == len(want.points)
    for pg, pw in zip(got.points, want.points):
        assert (pg is None) == (pw is None)
        if pg is None:
            continue
        assert sorted(pg.result.arrays) == sorted(pw.result.arrays)
        for k in pw.result.arrays:
            np.testing.assert_array_equal(
                pg.result.arrays[k], pw.result.arrays[k],
                err_msg=f"{pg.point}: array {k} differs from the reference",
            )


def _assert_point_matches_standalone(pr):
    p = pr.point
    prog, arrays, params = programs.get(p.kernel).make(p.scale)
    base = simulator.simulate(
        prog, arrays, params, mode=p.mode, sim=p.sim_params(),
        engine=p.engine, trace_mode=p.trace_mode,
    )
    got = pr.result
    assert (got.cycles, got.dram_bursts, got.dram_requests, got.forwards) \
        == (base.cycles, base.dram_bursts, base.dram_requests,
            base.forwards), p
    assert set(got.arrays) == set(base.arrays), p
    for k in base.arrays:
        np.testing.assert_array_equal(got.arrays[k], base.arrays[k],
                                      err_msg=f"{p}: array {k}")


def _both(*, sweep_kw=None, **spec_kw):
    sweep_kw = sweep_kw or {}
    want = ref_dse.sweep(ref_dse.SweepSpec(**spec_kw), **sweep_kw)
    got = dse.sweep(dse.SweepSpec(**spec_kw), **sweep_kw)
    _assert_results_equal(got, want)
    assert (got.n_points, got.n_unique_runs) == \
        (want.n_points, want.n_unique_runs)
    return got, want


@pytest.mark.parametrize("kernel", ref_programs.TABLE1)
def test_sweep_rows_match_reference_and_standalone(kernel):
    """Four modes x two sizings (x two trace modes on the irregular
    kernels): rows equal to the reference's sweep, and each point equal
    to the port's standalone ``simulate()``."""
    tms = ("auto", "interp") if kernel in INTERP_KERNELS else ("auto",)
    got, _want = _both(
        kernels=[kernel], scales=SCALES,
        modes=("STA", "LSQ", "FUS1", "FUS2"), trace_modes=tms,
        sizings=SIZINGS,
    )
    assert got.n_points == 8 * len(tms) and got.n_unique_runs == 8
    # trace modes fold onto one run: check each unique run once
    for pr in got.points:
        if pr.point.trace_mode == "auto":
            _assert_point_matches_standalone(pr)


def test_sweep_matches_reference_cycle_engine():
    """The cycle engine through the batch runner (the LSQ instance
    window with a shared rank table)."""
    got, _ = _both(kernels=["RAWloop"], scales=SCALES, modes=("LSQ", "FUS2"),
                   engines=("cycle",), sizings=SIZINGS)
    for pr in got.points:
        _assert_point_matches_standalone(pr)


def test_sta_engine_fold_matches_reference():
    got, _ = _both(kernels=["WAWloop"], scales=SCALES, modes=("STA",),
                   engines=("event", "cycle"))
    assert got.n_points == 2 and got.n_unique_runs == 1
    a, b = got.points
    assert a.result is b.result
    _assert_point_matches_standalone(a)


@pytest.mark.parametrize("modes,sizings,unique", [
    (("FUS1",), {"base": {}, "fwd9": {"forward_latency": 9}}, 1),
    (("LSQ",), {"base": {}, "b32": {"burst_size": 32}}, 1),
    (("STA", "FUS2"), {"base": {}, "cal": {"sta_mem_dep_ii": 99}}, 3),
])
def test_sim_param_projection_matches_reference(modes, sizings, unique):
    """Overrides a mode never reads fold onto one run, as in the
    reference, and the shared result equals a standalone call carrying
    the override."""
    got, _ = _both(kernels=["RAWloop"], scales=SCALES, modes=modes,
                   sizings=sizings)
    assert got.n_unique_runs == unique
    for pr in got.points:
        _assert_point_matches_standalone(pr)


def test_forward_slack_profile_matches_reference():
    kw = dict(kernels=["hist+add", "pagerank"], scales=SCALES,
              modes=("FUS2",), sizings=SIZINGS)
    want = ref_dse.sweep(ref_dse.SweepSpec(**kw), profile=True)
    got = dse.sweep(dse.SweepSpec(**kw), profile=True)
    assert got.profile
    assert canon(got.profile) == canon(want.profile)
    for row in got.profile:
        assert len(row["slack_frac"]) == 2
        assert all(0.0 <= f <= 1.0 for f in row["slack_frac"])


def test_static_prune_axis_folds_and_caches(tmp_path):
    """STA folds the axis, FUS2 keys the variants apart, both variants
    give equal cycles and arrays, and a second sweep is all cache hits
    (as tests/test_deps.py holds the reference)."""
    kw = dict(kernels=("tanh+spmv",), scales={"tanh+spmv": 48},
              modes=("STA", "FUS2"), static_prunes=(False, True))
    pts = dse.SweepSpec(**kw).points()
    assert len(pts) == 4
    assert len({p.result_key for p in pts}) == 3
    assert [p.result_key for p in pts] == \
        [p.result_key for p in ref_dse.SweepSpec(**kw).points()]
    got, _ = _both(sweep_kw={"cache_dir": str(tmp_path / "c")}, **kw)
    assert got.n_unique_runs == 3
    by = {}
    for pr in got.points:
        by.setdefault(pr.point.mode, {})[pr.point.static_prune] = pr.result
    for mode, d in by.items():
        assert d[False].cycles == d[True].cycles, mode
        for k in d[False].arrays:
            np.testing.assert_array_equal(d[False].arrays[k],
                                          d[True].arrays[k])
    again = dse.sweep(dse.SweepSpec(**kw), cache_dir=str(tmp_path / "c"))
    assert again.n_cache_hits == 3
    prog, arrays, params = programs.get("tanh+spmv").make(48)
    keys = {cachelib.result_cache_key(prog, arrays, params, "FUS2", "event",
                                      (), static_prune=c)
            for c in ("-", "prune")}
    assert len(keys) == 2


def test_strict_compiled_point_raises_like_standalone():
    """A compiled-mode point outside the compiled subset raises
    ``SweepGroupError`` naming its group, chained from the same
    ``TraceCompileError`` that standalone ``simulate()`` raises."""
    from repro_torch.core.schedule import TraceCompileError

    prog = ir.Program(
        "local_addr",
        loops=(
            ir.Loop("i", ir.Param("n", 0, 16), (
                ir.SetLocal("bin", ir.Read("d", ir.Var("i"), 0, 7)),
                ir.Load("ld_h", "h", ir.Local("bin")),
                ir.Store(
                    "st_h", "h", ir.Local("bin"), ir.LoadVal("ld_h") + 1.0
                ),
            )),
        ),
        params=("n",),
    )
    rng = np.random.default_rng(3)
    data = {
        "h": np.zeros(8),
        "d": rng.integers(0, 8, size=16).astype(np.float64),
    }
    with pytest.raises(TraceCompileError) as standalone:
        simulator.simulate(prog, data, {"n": 16}, mode="FUS2",
                           trace_mode="compiled")
    programs.REGISTRY["_carried_test"] = programs.Bench(
        "_carried_test", lambda s: (prog, data, {"n": 16}), "O(n)", 16,
    )
    try:
        pt = dse.SweepPoint("_carried_test", 8, mode="FUS2",
                            trace_mode="compiled")
        with pytest.raises(dse.SweepGroupError) as ei:
            dse.sweep([pt])
        assert "_carried_test" in str(ei.value)
        assert isinstance(ei.value.__cause__, TraceCompileError)
        assert str(ei.value.__cause__) == str(standalone.value)
        res = dse.sweep([dse.SweepPoint("_carried_test", 8, mode="FUS2")])
        _assert_point_matches_standalone(res.points[0])
    finally:
        del programs.REGISTRY["_carried_test"]


# ---------------------------------------------------------------------------
# result identity
# ---------------------------------------------------------------------------


def test_result_keys_match_reference():
    kw = dict(
        kernels=("RAWloop", "bnn", "chase_sum"),
        scales={"RAWloop": 32, "bnn": 16, "chase_sum": 32},
        modes=("STA", "LSQ", "FUS1", "FUS2"), engines=("event", "cycle"),
        trace_modes=("auto", "interp"), speculations=("off", "auto"),
        sizings={"base": {}, "deep": {"sta_mem_dep_ii": 99, "fifo_depth": 2},
                 "fwd": {"forward_latency": 3}},
    )
    got = dse.SweepSpec(**kw).points()
    want = ref_dse.SweepSpec(**kw).points()
    assert [(p.point_id, p.result_key) for p in got] == \
        [(p.point_id, p.result_key) for p in want]
    for pt in got:
        assert pt.result_key == dse.result_projection(
            pt.kernel, pt.scale, pt.config, pt.sim
        )
    a = dse.SweepPoint("RAWloop", 32, sim={"burst_size": 4})
    c = dse.SweepPoint("RAWloop", 32, sim=simulator.SimParams(burst_size=4))
    assert a.sim == c.sim == (("burst_size", 4),)
    assert dse.SweepPoint("RAWloop", 32, sim={"burst_size": 16}).sim == ()


def test_every_config_field_keyed_or_inert():
    """Every ``RunConfig`` field moves ``result_projection`` or is listed
    in ``RESULT_INERT_FIELDS``. ``backend`` stays inert, so the port's
    default ``"torch"`` and the host replay share result keys."""
    assert dse.RESULT_INERT_FIELDS == ref_dse.RESULT_INERT_FIELDS
    kernel, scale = "chase_sum", 32
    base = RunConfig(mode="FUS2", speculation="auto")
    probes = {
        "mode": "LSQ", "engine": "cycle", "trace_mode": "interp",
        "speculation": "off", "predictor": "stride", "spec_runahead": 3,
        "fifo_depth": 2, "fifo_latency": 5, "static_prune": True,
        "validate_hints": True, "backend": "numpy", "batch_waves": False,
        "symbolic_admission": False,
    }
    fields = {f.name for f in dataclasses.fields(RunConfig)}
    assert set(probes) == fields, "probe table out of date"
    want = dse.result_projection(kernel, scale, base)
    inert = {name for name, probe in probes.items()
             if dse.result_projection(
                 kernel, scale, dataclasses.replace(base, **{name: probe})
             ) == want}
    assert inert == set(dse.RESULT_INERT_FIELDS)
    assert base.backend == "torch"


# ---------------------------------------------------------------------------
# result cache
# ---------------------------------------------------------------------------

CACHE_SPEC = dict(kernels=["RAWloop"], scales={"RAWloop": 48},
                  modes=("STA", "FUS2"))


def test_sweep_cold_then_warm(tmp_path):
    spec = dse.SweepSpec(**CACHE_SPEC,
                         sizings={"base": {}, "n4": {"burst_size": 4}})
    cold = dse.sweep(spec, cache_dir=str(tmp_path))
    assert cold.n_cache_hits == 0
    warm = dse.sweep(spec, cache_dir=str(tmp_path))
    assert warm.n_cache_hits == warm.n_unique_runs == cold.n_unique_runs
    _assert_results_equal(warm, cold)
    _assert_point_matches_standalone(warm.points[-1])


def test_partial_warm_on_new_sizing(tmp_path):
    dse.sweep(dse.SweepSpec(**CACHE_SPEC), cache_dir=str(tmp_path))
    grown = dse.SweepSpec(**CACHE_SPEC,
                          sizings={"base": {}, "n4": {"burst_size": 4}})
    res = dse.sweep(grown, cache_dir=str(tmp_path))
    assert res.n_unique_runs == 4
    assert res.n_cache_hits == 2


def test_key_sensitivity():
    prog, arrays, params = programs.get("RAWloop").make(32)
    key = cachelib.result_cache_key
    base = key(prog, arrays, params, "FUS2", "event", ())
    others = [
        key(prog, arrays, {**params, "n": 16}, "FUS2", "event", ()),
        key(prog, {**arrays, "d0": arrays["d0"] + 1.0}, params, "FUS2",
            "event", ()),
        key(prog, arrays, params, "FUS2", "event", (("burst_size", 4),)),
        key(prog, arrays, params, "FUS1", "event", ()),
        key(prog, arrays, params, "FUS2", "cycle", ()),
        key(prog, arrays, params, "FUS2", "event", (), version="other"),
        key(prog, arrays, params, "FUS2", "event", (), speculation="auto"),
    ]
    assert base not in others and len(set(others)) == len(others)


def test_corrupt_entry_is_a_miss(tmp_path):
    cache = cachelib.ResultCache(str(tmp_path))
    prog, arrays, params = programs.get("RAWloop").make(32)
    key = cachelib.result_cache_key(prog, arrays, params, "FUS2", "event", ())
    (tmp_path / f"{key}.npz").write_bytes(b"not an npz")
    assert cache.get(key) is None
    res = simulator.simulate(prog, arrays, params, mode="FUS2")
    cache.put(key, res)
    got = cache.get(key)
    assert got is not None and got.cycles == res.cycles
    for k in res.arrays:
        np.testing.assert_array_equal(got.arrays[k], res.arrays[k])


def test_code_version_hashes_this_package():
    """The code version is a sha256 over this package's core, analysis
    and dse sources, so it differs from the reference's by design."""
    import repro_torch.analysis
    import repro_torch.core
    import repro_torch.dse

    h = hashlib.sha256()
    for pkg in (repro_torch.core, repro_torch.analysis, repro_torch.dse):
        root = os.path.dirname(pkg.__file__)
        for fn in sorted(os.listdir(root)):
            if fn.endswith(".py"):
                with open(os.path.join(root, fn), "rb") as f:
                    h.update(fn.encode())
                    h.update(f.read())
    assert cachelib.code_version() == h.hexdigest()
    assert cachelib.code_version() != ref_cachelib.code_version()


def test_code_version_change_invalidates(tmp_path, monkeypatch):
    spec = dse.SweepSpec(**CACHE_SPEC)
    first = dse.sweep(spec, cache_dir=str(tmp_path))
    monkeypatch.setattr(cachelib, "_CODE_VERSION", "f" * 64)
    again = dse.sweep(spec, cache_dir=str(tmp_path))
    assert again.n_cache_hits == 0
    _assert_results_equal(again, first)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def test_iteration_count_matches_reference():
    for name in ref_programs.TABLE1:
        rprog, arrays, params = ref_programs.get(name).make(SCALES[name])
        prog, _a, _p = programs.get(name).make(SCALES[name])
        assert dse.iteration_count(prog, arrays, params) == \
            ref_dse.iteration_count(rprog, arrays, params), name


def test_calibrate_matches_reference():
    """A small fit (coarse grids, small scales): fitted fields, every
    grid point's error and cycles per iteration, per-kernel results and
    the mean relative error all equal the reference's."""
    kw = dict(scales={"hist+add": 64, "pagerank": 16, "tanh+spmv": 32},
              sta_grid=(128, 224), dram_grid=(150, 200), fwd_grid=(1, 2))
    got = dse.calibrate(**kw)
    want = ref_dse.calibrate(**kw)
    assert canon(got) == canon(want)
    assert set(got.fitted) == {"sta_mem_dep_ii", "dram_latency",
                               "forward_latency"}
    assert got.params == simulator.SimParams(**{
        **dataclasses.asdict(simulator.SimParams()), **got.fitted})
