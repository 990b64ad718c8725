"""The port's spans and counters (``repro_torch.tracing``), on the CPU.

- off (the default): ``span`` hands out one shared object, records
  nothing and calls nothing in torch, even under an active profiler;
- on: parents by thread, the step's identifier, counters over each
  outermost span, ``take`` clearing the buffer, the bound counting what
  it dropped;
- the clock: each span's start beside its ``record_function`` annotation
  in a CPU ``torch.profiler`` trace;
- the instrumented program (``mamba_apply``, ``decode_step``, the train
  step, ``FaultTolerantLoop.run``) gives the same bits with recording on
  and off, and records the spans that name its parts;
- ``_build.load`` keeps a build's seconds.
"""

import dataclasses
import statistics
import threading

import pytest
import torch

from repro_torch import _build, tracing
from repro_torch.configs import base as configs
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.distributed.fault import FaultConfig, FaultTolerantLoop
from repro_torch.kernels.attention import kernel as k67
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def _names(spans):
    return [s.name for s in spans]


def _fail(*a, **k):
    raise AssertionError("torch was called while recording is off")


def test_off_hands_out_one_object_and_calls_no_torch(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _fail)
    monkeypatch.setattr(torch.profiler, "record_function", _fail)
    monkeypatch.setattr(tracing, "launch_counts", _fail)
    a, b = tracing.span("serve.step"), tracing.span("mamba.scan")
    assert a is b
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu):
        for _ in range(3):
            with tracing.span("serve.step") as s, tracing.span("x"):
                assert s is a
    with tracing.recording() as rec:
        pass
    assert rec.take() == {"spans": [], "counts": {}, "dropped": 0}


def test_on_records_nesting_parents_and_the_step():
    with tracing.recording() as rec:
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.span("b"):
                pass
        with tracing.span("d"):
            pass
    spans = rec.take()["spans"]
    assert _names(spans) == ["a", "b", "c", "b", "d"]
    assert [s.parent for s in spans] == [None, 0, 1, 0, None]
    assert [s.step for s in spans] == [0, 0, 0, 0, 4]
    assert all(s.start_ns <= s.end_ns for s in spans)
    a, b, c, b2, d = spans
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= b2.start_ns <= b2.end_ns <= a.end_ns <= d.start_ns
    assert {s.thread for s in spans} == {threading.get_ident()}


def test_a_second_thread_keeps_its_own_stack():
    """Spans entered on another thread while the caller waits inside its
    step (as autograd's device thread runs the backward) nest on their own
    thread and belong to the caller's step."""
    def work():
        with tracing.span("recompute"):
            with tracing.span("inner"):
                pass

    with tracing.recording() as rec:
        with tracing.span("step"):
            with tracing.span("backward"):
                t = threading.Thread(target=work)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
        t = threading.Thread(target=work)  # no step open: its own
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    spans = rec.take()["spans"]
    assert _names(spans) == ["step", "backward", "recompute", "inner",
                             "recompute", "inner"]
    assert [s.parent for s in spans] == [None, 0, 0, 2, None, 4]
    assert [s.step for s in spans] == [0, 0, 0, 0, 4, 4]
    assert spans[2].thread == spans[3].thread != spans[0].thread


def test_take_clears_and_the_bound_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 3)
    with tracing.recording() as rec:
        for _ in range(5):
            with tracing.span("x"):
                pass
        first = rec.take()
        with tracing.span("y"):
            with tracing.span("z"):
                pass
    assert _names(first["spans"]) == ["x"] * 3 and first["dropped"] == 2
    second = rec.take()
    assert _names(second["spans"]) == ["y", "z"] and second["dropped"] == 0
    assert second["spans"][1].parent == second["spans"][0].step == 3
    assert rec.take() == {"spans": [], "counts": {}, "dropped": 0}


def test_recording_is_one_block_at_a_time_and_off_after_it():
    with tracing.recording():
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
    assert tracing.span("x") is tracing.span("y")


def test_taps_reach_the_sinks_of_a_tapping_block_and_nothing_else():
    a, b = [], []
    tracing.tap("a", 1)  # outside a block: dropped
    with tracing.tapping({"a": a.append, "b": b.append}):
        tracing.tap("a", 2)
        tracing.tap("c", 3)
        tracing.tap("a", 4)
        with pytest.raises(RuntimeError):
            with tracing.tapping({"c": b.append}):
                pass
    tracing.tap("a", 5)
    assert a == [2, 4] and b == []


def test_the_moe_layers_tap_their_experts_without_changing_a_step(
        monkeypatch):
    """A reduced moonlight's serve step taps each MoE layer's experts,
    ``(batch, top_k)``, in layer order: the same tensors ``ops.route``
    gives from the layer's router, and the same logits as untapped."""
    cfg = dataclasses.replace(configs.get("moonlight-16b-a3b").reduced(),
                              n_layers=3)
    params = T.init_params(torch.Generator().manual_seed(5), cfg, L.FP32,
                           device="cpu")
    tokens = torch.randint(3, cfg.vocab, (3, 1),
                           generator=torch.Generator().manual_seed(6))
    step = steps.make_serve_step(cfg, L.FP32)

    def once():
        cache = T.init_cache(cfg, 3, 2, L.FP32, device="cpu")
        return step(params, tokens, cache, torch.zeros(3, dtype=torch.int32))

    plain, *_ = once()
    seen = []
    real = L._route

    def spy(p, logits, c):
        out = real(p, logits, c)
        seen.append(out[1])
        return out

    monkeypatch.setattr(L, "_route", spy)
    taps = []
    with tracing.tapping({"moe.route": taps.append}):
        tapped, *_ = once()
    assert torch.equal(plain, tapped)
    assert len(taps) == cfg.n_layers - cfg.n_dense_layers
    assert all(a is b for a, b in zip(taps, seen))
    assert taps[0].shape == (3, cfg.top_k)


def test_launch_counts_read_the_wrappers(monkeypatch):
    got = tracing.launch_counts()
    assert set(got) == {f"K{i}" for i in range(1, 11)}
    assert got["K6"] == k67.flash_attention.launches
    assert got["K7"] == k67.decode_attention.launches
    monkeypatch.setattr(k67.flash_attention, "launches",
                        k67.flash_attention.launches + 5)
    assert tracing.launch_counts()["K6"] == got["K6"] + 5
    assert {k: v for k, v in tracing.launch_counts().items() if k != "K6"} \
        == {k: v for k, v in got.items() if k != "K6"}


def test_counters_change_over_each_outermost_span(monkeypatch):
    monkeypatch.setattr(k67.flash_attention, "launches", 0)
    with tracing.recording() as rec:
        for n in (2, 0, 3):
            with tracing.span("train.step"):
                with tracing.span("train.forward"):
                    k67.flash_attention.launches += n
    assert rec.take()["counts"] == {0: {"K6": 2}, 2: {}, 4: {"K6": 3}}


def _clock_gaps():
    """Each recorded span's start less its annotation's, in ns, for eight
    spans under a CPU profiler (the first annotation of a trace is slow
    to open, and is not compared); and whether each ends inside it."""
    prof_api = torch.profiler
    with tracing.recording() as rec:
        with tracing.span("before"):
            pass
        with prof_api.profile(activities=[prof_api.ProfilerActivity.CPU]) as p:
            with tracing.span("warm-up"):
                pass
            for i in range(8):
                with tracing.span(f"s{i}"):
                    torch.ones(64).sum()
    spans = {s.name: s for s in rec.take()["spans"]}
    t0 = p.profiler.kineto_results.trace_start_ns()
    marks = {e.name: e for e in p.events() if e.is_user_annotation}
    assert "before" not in marks and "warm-up" in marks
    return [(spans[f"s{i}"].start_ns - (t0 + marks[f"s{i}"].time_range.start
                                         * 1e3),
             spans[f"s{i}"].end_ns <= t0 + marks[f"s{i}"].time_range.end
             * 1e3 + 50e3) for i in range(8)]


def test_spans_sit_on_the_profilers_clock():
    """Under a CPU profiler each recorded span opens its annotation; the
    median of the eight recorded starts less their annotations' lies
    within 50 µs, in epoch ns, and every span ends inside its annotation
    (the median, since the scheduler may stall one span between the two
    clocks' reads; a wrong offset between the clocks moves all eight)."""
    got = _clock_gaps()
    assert abs(statistics.median(d for d, _ in got)) < 50e3, got
    assert all(inside for _, inside in got), got


# -- the instrumented program: the same bits, and its spans ------------------

def _recorded(fn):
    """``fn()`` with recording off and on: both results and the spans."""
    off = fn()
    with tracing.recording() as rec:
        on = fn()
    return off, on, rec.take()


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
@pytest.mark.parametrize("s", [1, 12])
def test_mamba_apply_is_unchanged_and_spanned(arch, s):
    cfg = dataclasses.replace(configs.get(arch).reduced(), ssm_chunk=4)
    gen = torch.Generator().manual_seed(3)
    p = S.mamba_init(gen, cfg, L.FP32, "cpu")
    x = torch.randn(2, s, cfg.d_model, generator=gen)
    state = S.mamba_init_state(cfg, 2, device="cpu")
    state["h"].normal_(generator=gen)
    state["conv"].normal_(generator=gen)

    off, on, taken = _recorded(lambda: S.mamba_apply(p, x, cfg, state=state))
    _same(off, on)
    assert _names(taken["spans"]) == ["mamba.in_proj", "mamba.scan",
                                      "mamba.out_proj"]


def _decode_case():
    cfg = configs.get("falcon-mamba-7b").reduced()
    params = T.init_params(torch.Generator().manual_seed(5), cfg, L.FP32,
                           device="cpu")
    tokens = torch.randint(3, cfg.vocab, (3, 4),
                           generator=torch.Generator().manual_seed(6))
    return cfg, params, tokens


def test_serve_steps_are_unchanged_and_spanned():
    cfg, params, tokens = _decode_case()
    serve_step = steps.make_serve_step(cfg, L.FP32)

    def decode():
        cache = T.init_cache(cfg, 3, 8, L.FP32, device="cpu")
        lens = torch.zeros(3, dtype=torch.int32)
        out = []
        for t in range(tokens.shape[1]):
            logits, cache, lens = serve_step(params, tokens[:, t:t + 1],
                                             cache, lens)
            out.append(logits)
        return out, cache, lens

    off, on, taken = _recorded(decode)
    _same(off, on)
    spans = taken["spans"]
    per_layer = ["mamba.in_proj", "mamba.scan", "mamba.out_proj",
                 "decode.state_write"]
    step = ["serve.step"] + per_layer * cfg.n_layers + ["decode.head"]
    assert _names(spans) == step * tokens.shape[1]
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["serve.step"] * 4
    assert all(s.step == max(r for r in roots if r <= i)
               for i, s in enumerate(spans))
    assert taken["counts"] == {r: {} for r in roots}


def test_moonlight_decode_spans_sit_under_the_serve_step():
    """A reduced moonlight's serve step (MLA without a query LoRA, a dense
    layer, dropless MoE layers with a sigmoid router): the same logits
    with recording on, and each layer's ``mla.attend`` and each MoE
    layer's ``moe.route``, ``moe.experts`` and ``moe.shared`` children of
    ``serve.step``."""
    cfg = dataclasses.replace(configs.get("moonlight-16b-a3b").reduced(),
                              n_layers=3)
    params = T.init_params(torch.Generator().manual_seed(5), cfg, L.FP32,
                           device="cpu")
    tokens = torch.randint(3, cfg.vocab, (3, 3),
                           generator=torch.Generator().manual_seed(6))
    serve_step = steps.make_serve_step(cfg, L.FP32)

    def decode():
        cache = T.init_cache(cfg, 3, 4, L.FP32, device="cpu")
        lens = torch.zeros(3, dtype=torch.int32)
        return [serve_step(params, tokens[:, t:t + 1], cache, lens)[0]
                for t in range(tokens.shape[1])]

    off, on, taken = _recorded(decode)
    _same(off, on)
    spans = taken["spans"]
    moe = ["mla.attend", "moe.route", "moe.experts", "moe.shared"]
    step = (["serve.step", "mla.attend"] + moe * (cfg.n_layers - 1)
            + ["decode.head"])
    assert _names(spans) == step * tokens.shape[1]
    for i, s in enumerate(spans):
        if s.name != "serve.step":
            assert spans[s.parent].name == "serve.step", (i, s)


def _train_loop(tmp_path, cfg, params):
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = steps.make_train_step(cfg, opt_cfg, L.FP32)
    loader = ShardedLoader(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=2, seed=7))

    def step_fn(state, batch):
        bt = {k: torch.from_numpy(v) for k, v in batch.items()}
        p, o, metrics = step(state["params"], state["opt"], bt)
        return {"params": p, "opt": o}, {k: float(v)
                                         for k, v in metrics.items()}

    state = {"params": params, "opt": adamw.init_state(params)}
    return FaultTolerantLoop(step_fn, state, loader, FaultConfig(
        checkpoint_dir=str(tmp_path), checkpoint_every=10 ** 9))


@pytest.mark.parametrize("arch", ["minicpm3-4b", "falcon-mamba-7b"])
def test_train_steps_through_the_loop_are_unchanged_and_spanned(tmp_path,
                                                                 arch):
    cfg = configs.get(arch).reduced()

    runs = iter(("off", "on"))

    def train():
        params = T.init_params(torch.Generator().manual_seed(9), cfg,
                               L.FP32, device="cpu")
        loop = _train_loop(tmp_path / next(runs), cfg, params)
        metrics = loop.run(2)
        return metrics, loop.state

    off, on, taken = _recorded(train)
    _same(off, on)
    spans = taken["spans"]
    top = [s for s in spans if s.parent is None]
    assert _names(top) == ["train.data", "train.step"] * 2
    for root in (i for i, s in enumerate(spans) if s.name == "train.step"):
        kids = [s.name for s in spans if s.parent == root]
        assert kids == ["train.forward", "train.backward",
                        "train.optimizer"]
    if arch == "falcon-mamba-7b":  # the layers' spans, and the recompute's
        names = _names(spans)
        assert names.count("mamba.scan") > names.count("train.step")


def test_build_load_keeps_a_builds_seconds(monkeypatch):
    """A kernel that ``nvcc`` built keeps its seconds; one built already
    (``build`` gives 0.0) keeps none."""
    took = {"ssm_scan": 1.5, "attention": 0.0}
    monkeypatch.setattr(_build, "build", took.__getitem__)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    _build.load.cache_clear()
    try:
        _build.load("ssm_scan")
        _build.load("attention")
    finally:
        _build.load.cache_clear()
    assert _build.BUILD_SECONDS == {"ssm_scan": 1.5}
