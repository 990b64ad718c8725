"""The port's sweep service against the JAX package's, on the CPU:
shard and merge, workers, streaming, resume, retry, and the sweep
summaries of ``launch.analysis``.

``SPEC`` is ``tests/test_sweep_service.py``'s: four kernels (chase_sum
speculates, so both speculation classes are live) x STA/FUS2 x two
sizings. Held here:

  * the port's rows and arrays equal to the reference's sweep, and to
    the port's standalone ``simulate()``;
  * shard plans equal to the reference's, and shard plus merge for 2
    and 3 shards equal to a single host;
  * ``workers=2`` equal to ``workers=1`` (spawned worker processes);
  * streaming (``on_point``, ``iter_points``) delivering every point
    once with the batch's results;
  * a warm resume executing nothing, a corrupt journal entry skipped
    and counted, a SIGKILLed sweep (a child process importing only
    ``repro_torch.dse``) resuming bit-identical to an unbroken one;
  * a transient failure retried, a permanent one naming its group and
    the surviving cache;
  * ``harmonic_mean``, ``sweep_speedups``, ``pareto_front``,
    ``ParetoTracker`` prefixes and ``summarize_sweep`` equal to the
    reference's on the same rows.
"""

import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from repro import dse as ref_dse
from repro.launch import analysis as ref_analysis
from repro_torch import dse
from repro_torch.core import programs, simulator
from repro_torch.dse import runner as runner_mod
from repro_torch.launch import analysis

from test_torch_parity import canon

ROOT = pathlib.Path(__file__).resolve().parents[1]

SPEC_KW = dict(
    kernels=("RAWloop", "hist+add", "tanh+spmv", "chase_sum"),
    scales={"RAWloop": 64, "hist+add": 48, "tanh+spmv": 16,
            "chase_sum": 32},
    modes=("STA", "FUS2"),
    speculations=("auto",),
    sizings={"base": {}, "narrow": {"burst_size": 4}},
)
SPEC = dse.SweepSpec(**SPEC_KW)
VOLATILE = ("cached", "run_wall_s")


def _rows(res):
    return canon([{k: v for k, v in r.items() if k not in VOLATILE}
                  for r in res.rows()])


def _sig(pr):
    if pr is None:
        return None
    return (
        pr.result.cycles, pr.result.dram_bursts,
        tuple(sorted(
            (k, v.tobytes()) for k, v in pr.result.arrays.items()
        )),
    )


def _same(a, b):
    assert len(a.points) == len(b.points)
    for pa, pb in zip(a.points, b.points):
        assert _sig(pa) == _sig(pb)
    assert _rows(a) == _rows(b)


@pytest.fixture(scope="module")
def whole():
    return dse.sweep(SPEC)


@pytest.fixture(scope="module")
def ref_whole():
    return ref_dse.sweep(ref_dse.SweepSpec(**SPEC_KW))


def test_rows_match_reference_and_standalone(whole, ref_whole):
    _same(whole, ref_whole)
    assert whole.stats.n_unique_runs == ref_whole.stats.n_unique_runs
    for pr in whole.points:
        p = pr.point
        prog, arrays, params = programs.get(p.kernel).make(p.scale)
        base = simulator.simulate(
            prog, arrays, params, mode=p.mode, sim=p.sim_params(),
            engine=p.engine, trace_mode=p.trace_mode,
            speculation=p.speculation, predictor=p.predictor,
        )
        assert (pr.result.cycles, pr.result.dram_bursts, pr.result.forwards,
                pr.result.squashed) == (base.cycles, base.dram_bursts,
                                        base.forwards, base.squashed), p
        for k in base.arrays:
            np.testing.assert_array_equal(pr.result.arrays[k],
                                          base.arrays[k])


# -- shard planning and merge ------------------------------------------------


@pytest.mark.parametrize("n_shards", (2, 3))
def test_shard_plan_matches_reference(n_shards):
    got = dse.shard_plan(SPEC, n_shards)
    assert got == dse.shard_plan(SPEC, n_shards)  # deterministic
    want = ref_dse.shard_plan(ref_dse.SweepSpec(**SPEC_KW), n_shards)
    assert canon(got) == canon(want)
    owned = [i for s in range(n_shards) for i in got.groups_for(s)]
    assert sorted(owned) == list(range(len(got.assignment)))
    assert max(got.loads) - min(got.loads) <= max(
        len(g.runs) for g in dse.plan(SPEC.points())
    )
    with pytest.raises(ValueError):
        got.groups_for(n_shards)


@pytest.mark.parametrize("n_shards", (2, 3))
def test_merge_equals_single_host(tmp_path, whole, n_shards):
    shards = [
        dse.sweep_shard(SPEC, i, n_shards, cache_dir=str(tmp_path / f"s{i}"))
        for i in range(n_shards)
    ]
    merged = dse.merge_results(shards)
    _same(merged, whole)
    assert merged.stats.shard is None
    assert merged.stats.n_unique_runs == whole.stats.n_unique_runs
    assert [g["class_key"] for g in merged.groups] == [
        g["class_key"] for g in whole.groups
    ]


def test_merge_rejects_duplicate_and_missing_shards():
    shards = [dse.sweep_shard(SPEC, i, 2) for i in range(2)]
    with pytest.raises(ValueError, match="duplicate shard"):
        dse.merge_results([shards[0], shards[0]])
    with pytest.raises(ValueError):
        dse.merge_results([shards[0]])
    with pytest.raises(ValueError):
        dse.merge_results([])


def test_merge_caches_serve_the_whole_sweep(tmp_path, whole):
    a, b, dst = (str(tmp_path / d) for d in ("a", "b", "dst"))
    dse.sweep_shard(SPEC, 0, 2, cache_dir=a)
    dse.sweep_shard(SPEC, 1, 2, cache_dir=b)
    assert dse.merge_caches(dst, a, b) > 0
    res = dse.sweep(SPEC, cache_dir=dst, resume=True)
    assert res.stats.n_executed == 0
    assert res.stats.n_cache_hits == res.stats.n_unique_runs
    _same(res, whole)


def test_workers_do_not_change_results(whole):
    _same(dse.sweep(SPEC, workers=2), whole)


# -- streaming ---------------------------------------------------------------


def test_on_point_and_iter_points_stream_everything(whole):
    seen = []
    res = dse.sweep(SPEC, on_point=seen.append)
    assert len(seen) == len(res.points)
    assert {id(p) for p in seen} == {id(p) for p in res.points}
    iterated = list(dse.iter_points(SPEC))
    assert len(iterated) == len(seen)
    by_id = {pr.point.point_id: _sig(pr) for pr in iterated}
    for pr in whole.points:
        assert by_id[pr.point.point_id] == _sig(pr)


# -- stats, resume, journal --------------------------------------------------


def test_stats_cohere_and_warm_resume_executes_nothing(tmp_path, whole):
    cache = str(tmp_path / "cache")
    cold = dse.sweep(SPEC, cache_dir=cache)
    st = cold.stats
    assert st.n_points == len(cold.points)
    assert st.n_executed == st.n_unique_runs and st.n_cache_hits == 0
    assert st.journal_entries == 0 and st.journal_corrupt == 0
    warm = dse.sweep(SPEC, cache_dir=cache, resume=True)
    wst = warm.stats
    assert wst.n_executed == 0
    assert wst.n_cache_hits == wst.n_resumed_runs == wst.n_unique_runs
    assert wst.journal_entries == st.n_unique_runs
    _same(warm, whole)


def test_resume_requires_cache_dir():
    with pytest.raises(ValueError, match="cache_dir"):
        dse.sweep(SPEC, resume=True)


def test_corrupt_journal_entry_skipped_not_fatal(tmp_path, whole):
    cache = str(tmp_path / "cache")
    cold = dse.sweep(SPEC, cache_dir=cache)
    with open(os.path.join(cache, dse.SweepJournal.FILENAME), "a") as f:
        f.write("{truncated json\n")
        f.write("[1, 2, 3]\n")  # parseable but not a dict: also corrupt
    with pytest.warns(UserWarning, match="journal"):
        res = dse.sweep(SPEC, cache_dir=cache, resume=True)
    assert res.stats.journal_corrupt == 2
    assert res.stats.journal_entries == cold.stats.n_unique_runs
    assert res.stats.n_executed == 0
    _same(res, whole)


KILL_CHILD = textwrap.dedent("""
    import sys
    from repro_torch import dse
    spec = dse.SweepSpec(**eval(sys.argv[2]))
    dse.sweep(spec, cache_dir=sys.argv[1], workers=1)
""")


def test_kill_resume_bit_identical(tmp_path, whole):
    """SIGKILL a child sweep once its journal shows progress; the
    resumed run computes only the missing runs and equals the unbroken
    result bit for bit."""
    cache = str(tmp_path / "cache")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    child = subprocess.Popen(
        [sys.executable, "-c", KILL_CHILD, cache, repr(SPEC_KW)],
        env=env, cwd=str(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    journal = os.path.join(cache, dse.SweepJournal.FILENAME)
    deadline = time.time() + 60.0
    while time.time() < deadline and child.poll() is None:
        if os.path.exists(journal):
            with open(journal) as f:
                if sum(1 for _ in f) >= 2:
                    break
        time.sleep(0.02)
    finished_early = child.poll() is not None
    if not finished_early:
        child.send_signal(signal.SIGKILL)
    child.wait()
    res = dse.sweep(SPEC, cache_dir=cache, resume=True)
    st = res.stats
    assert st.n_cache_hits + st.n_executed == st.n_unique_runs
    assert st.n_resumed_runs >= 2  # the journal had two lines
    if not finished_early:
        assert st.n_executed >= 1
    _same(res, whole)


# -- retry and failure naming ------------------------------------------------


def test_transient_failure_retries_with_backoff(monkeypatch, whole):
    calls = {"n": 0}
    orig = runner_mod._run_group_task

    def flaky(args):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient spawn failure")
        return orig(args)

    monkeypatch.setattr(runner_mod, "_run_group_task", flaky)
    res = dse.sweep(SPEC, retries=2, backoff_s=0.01)
    assert res.stats.n_retries == 1
    rec = res.stats.retries[0]
    assert rec["error"].startswith("OSError") and rec["attempt"] == 1
    _same(res, whole)


def test_permanent_failure_names_group_and_cache(tmp_path, monkeypatch):
    cache = str(tmp_path / "cache")
    dse.sweep(SPEC, cache_dir=cache)
    orig = runner_mod._run_group_task

    def doomed(args):
        if args[0].kernel == "tanh+spmv":
            raise ValueError("engine exploded")
        return orig(args)

    monkeypatch.setattr(runner_mod, "_run_group_task", doomed)
    # differential=True changes the run signature against the cached
    # rows, forcing real execution through the doomed path
    with pytest.raises(dse.SweepGroupError) as ei:
        dse.sweep(SPEC, cache_dir=cache, differential=True, retries=0,
                  backoff_s=0.0)
    msg = str(ei.value)
    for part in ("kernel='tanh+spmv'", "scale=16", "spec_class=", "cache"):
        assert part in msg
    assert isinstance(ei.value.__cause__, ValueError)


# -- sweep summaries ---------------------------------------------------------


def test_sweep_summaries_match_reference(whole, ref_whole):
    rows, ref_rows = whole.rows(), ref_whole.rows()
    for objectives in (("cycles", "dram_bursts"), ("cycles",),
                       ("dram_requests", "cycles")):
        assert analysis.pareto_front(rows, objectives) == \
            ref_analysis.pareto_front(ref_rows, objectives)
    for base_modes in (("STA", "LSQ"), ("STA",)):
        assert analysis.sweep_speedups(rows, base_modes) == \
            ref_analysis.sweep_speedups(ref_rows, base_modes)
    got = analysis.summarize_sweep(rows)
    assert got == ref_analysis.summarize_sweep(ref_rows)
    assert set(got["pareto_fus2"]) == set(SPEC_KW["kernels"])
    assert analysis.summarize_sweep([]) == ref_analysis.summarize_sweep([])
    xs = [r["cycles"] / 7.0 for r in rows] + [0.0, -1.0]
    assert analysis.harmonic_mean(xs) == ref_analysis.harmonic_mean(xs)
    assert analysis.harmonic_mean([]) == 0.0


def test_pareto_tracker_prefixes_match_reference():
    rng = np.random.default_rng(7)
    tracker = analysis.ParetoTracker()
    ref_tracker = ref_analysis.ParetoTracker()
    rows = []
    for i in range(200):
        row = {"cycles": int(rng.integers(1, 40)),
               "dram_bursts": int(rng.integers(1, 40)), "i": i}
        rows.append(row)
        assert tracker.update(row) == ref_tracker.update(row), i
        batch = [rows[j] for j in analysis.pareto_front(rows)]
        assert tracker.front() == batch == ref_tracker.front(), f"prefix {i}"
    assert tracker.n_seen == ref_tracker.n_seen == 200
