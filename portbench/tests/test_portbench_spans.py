"""The program's spans in a traced run (``portbench/spans.py``) and the
readers of the metrics built on them, on synthetic records; on the card,
the attribution rule on a real trace. The card tests skip without one."""

from types import SimpleNamespace

import pytest

import pb_cases  # noqa: F401  (the import path)

from portbench import harness, spans
from repro_torch import _build, tracing


def _op(name, launch, start, end):
    return (name, launch, start, end)


def test_device_time_goes_to_the_span_its_launch_started_in():
    """Launch time decides, not when the device ran the operation: a
    kernel launched inside ``b`` and run after ``b`` closed is ``b``'s; one
    launched from another thread inside ``a``'s interval is ``a``'s; one
    launched outside every span is no one's; a launch without a call in
    the trace counts nowhere."""
    occ = [("a", 0.0, 100.0), ("b", 10.0, 20.0), ("b", 40.0, 50.0),
           ("a", 200.0, 300.0)]
    ops = [_op("k1", 5.0, 30.0, 40.0),      # a
           _op("k2", 15.0, 40.0, 70.0),     # a, b (runs after b closed)
           _op("k3", 45.0, 70.0, 71.0),     # a, b
           _op("bwd", 60.0, 71.0, 171.0),   # a: another thread's launch
           _op("k4", 150.0, 171.0, 180.0),  # outside every span
           _op("k5", None, 180.0, 181.0),   # no launching call
           _op("k6", 300.0, 301.0, 302.0)]  # a's end is inside
    got = spans.device_seconds(ops, occ)
    assert got == pytest.approx({"a": (10 + 30 + 1 + 100 + 1) * 1e-6,
                                 "b": (30 + 1) * 1e-6})


def test_nested_occurrences_of_one_name_count_once():
    occ = [("s", 0.0, 50.0), ("s", 10.0, 20.0), ("s", 40.0, 60.0)]
    got = spans.device_seconds([_op("k", 15.0, 100.0, 110.0),
                                _op("k", 55.0, 110.0, 111.0)], occ)
    assert got == pytest.approx({"s": 11e-6})
    assert spans.device_seconds([], occ) == {"s": 0.0}


def _ev(name, eid, start, end, cuda=False, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, id=eid, is_user_annotation=annotation,
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end))


def test_launched_ops_link_each_operation_to_its_call():
    """By correlation id, the call on any thread; an operator's own id
    (another counter's, which may equal a call's) links nothing."""
    events = [
        _ev("aten::mm", 101, 0.0, 30.0),
        _ev("cudaLaunchKernel", 101, 5.0, 8.0),
        _ev("gemm", 101, 40.0, 90.0, cuda=True),
        _ev("cuLaunchKernel", 102, 12.0, 13.0),  # a second thread's
        _ev("triton_k", 102, 90.0, 95.0, cuda=True),
        _ev("fill", 103, 95.0, 96.0, cuda=True),  # no call traced
        _ev("aten::zero_", 103, 94.0, 95.0),
        _ev("serve.step", 3, 0.0, 120.0, annotation=True),
        _ev("serve.step", 3, 40.0, 97.0, cuda=True, annotation=True),
    ]
    assert spans.launched_ops(events) == [
        ("gemm", 5.0, 40.0, 90.0), ("triton_k", 12.0, 90.0, 95.0),
        ("fill", None, 95.0, 96.0)]


def _taken():
    """Three decode steps' spans as ``Recorder.take`` gives them, the middle
    one profiled; times in ns."""
    S = tracing.Span
    rows, counts, t = [], {}, 0
    for k in range(3):
        root = len(rows) + 10
        rows.append(S("serve.step", None, 1, t, t + 1000 * (k + 1), root))
        rows.append(S("mamba.scan", root, 1, t + 100, t + 300, root))
        rows.append(S("mamba.scan", root, 1, t + 400, t + 500, root))
        counts[root] = {"K6": k} if k else {}
        t += 10_000
    rows.append(S("serve.step", None, 1, t, None, len(rows) + 10))  # open
    return {"spans": rows, "counts": counts, "dropped": 0}


def test_per_step_sums_a_steps_spans_and_skips_the_profiled_steps():
    got = spans.per_step(_taken())
    assert got["host_s"] == {"serve.step": pytest.approx([1e-6, 2e-6, 3e-6]),
                             "mamba.scan": pytest.approx([3e-7] * 3)}
    assert got["counts"] == {"serve.step": [{}, {"K6": 1}, {"K6": 2}]}
    skipped = spans.per_step(_taken(), skip=[(10_500, 10_600)])
    assert skipped["host_s"]["serve.step"] == pytest.approx([1e-6, 3e-6])
    assert skipped["counts"] == {"serve.step": [{}, {"K6": 2}]}


def test_occurrences_place_spans_on_the_traces_microseconds():
    S = tracing.Span
    got = spans.occurrences([S("a", None, 1, 5_000, 9_000, 0),
                             S("b", 0, 1, 6_000, None, 0)], 1_000)
    assert got == [("a", 4.0, 8.0)]


def test_per_step_of_a_real_recording():
    with tracing.recording() as rec:
        for _ in range(2):
            with tracing.span("train.data"):
                pass
            with tracing.span("train.step"):
                with tracing.span("train.forward"):
                    pass
    got = spans.per_step(rec.take())
    assert sorted(got["host_s"]) == ["train.data", "train.forward",
                                     "train.step"]
    assert all(len(v) == 2 for v in got["host_s"].values())
    assert got["counts"] == {"train.data": [{}, {}], "train.step": [{}, {}]}


# -- the readers ------------------------------------------------------------

def _read(metric, rec):
    return harness.reader(metric)(rec)


def _decode_rec(**over):
    rec = {"steady_step_s": 0.25, "profile": {"steps": 4, "program_device_s": {
        "mamba.scan": 0.3, "decode.state_write": 0.1, "mamba.in_proj": 0.2,
        "mamba.out_proj": 0.15, "decode.head": 0.05, "serve.step": 0.98}},
        "program": {"host_s": {"serve.step": [0.27, 0.25, 0.26]},
                    "counts": {"serve.step": [{}, {}, {}]}}}
    rec.update(over)
    return rec


def _train_rec(**over):
    rec = {"step_s": [5.0, 5.4, 5.2], "profile": {"steps": 2,
           "program_device_s": {"train.forward": 2.08, "train.backward": 7.28,
                                "train.optimizer": 0.78,
                                "train.step": 10.2}},
           "program": {"host_s": {"train.data": [0.001, 0.003, 0.002]},
                       "counts": {"train.step": [{"K6": 124}] * 3,
                                  "train.data": [{}] * 3}}}
    rec.update(over)
    return rec


@pytest.mark.parametrize("metric, want", [
    ("mamba_step_share.decode", 40.0),
    ("projection_share.decode", 40.0),
    ("serve_step_host_ms.decode", 260.0),
])
def test_decode_readers(metric, want):
    assert _read(metric, _decode_rec()) == pytest.approx(want)
    assert _read(metric, {"steady_step_s": None, "profile": None}) is None
    assert _read(metric, _decode_rec(profile=None, program=None,
                                     steady_step_s=0.25)) is None
    # a record whose program keeps no spans (the parent's): nothing to read
    bare = _decode_rec()
    bare["profile"] = {"steps": 4, "span_device_s": {}}
    del bare["program"]
    assert _read(metric, bare) is None


@pytest.mark.parametrize("metric, want", [
    ("forward_share.train", 20.0), ("backward_share.train", 70.0),
    ("adamw_share.train", 7.5), ("data_wait_ms.train", 2.0),
    ("k6_launches.train", 124),
])
def test_train_readers(metric, want):
    assert _read(metric, _train_rec()) == pytest.approx(want)
    assert _read(metric, _train_rec(step_s=[], profile=None,
                                    program=None)) is None
    bare = _train_rec()
    bare["profile"] = {"steps": 2, "span_device_s": {}}
    del bare["program"]
    assert _read(metric, bare) is None


def test_kernel_build_s_reads_the_programs_tally(monkeypatch):
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    assert _read("kernel_build_s", {}) == 0
    monkeypatch.setattr(_build, "BUILD_SECONDS",
                        {"attention": 19.5, "ssm_scan": 2.25})
    assert _read("kernel_build_s", {}) == 21.75
    monkeypatch.delattr(_build, "BUILD_SECONDS")
    assert _read("kernel_build_s", {}) is None


def test_kernel_build_s_is_reported_in_every_cell():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        names = [m["name"] for m in harness.cell_metrics(spec, w["name"],
                                                         True)]
        assert "kernel_build_s" in names, w["name"]


# -- on the card: the rule on a real trace ----------------------------------

@pytest.mark.cuda
def test_the_backwards_kernels_fall_under_its_span_on_the_card():
    """Autograd launches the backward's kernels from its device thread while
    the caller waits inside ``train.backward``: the launch-time rule gives
    them to that span, and every device operation of the trace is linked
    to its launching call."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    w = torch.randn(2048, 2048, device=dev, requires_grad=True)
    x = torch.randn(512, 2048, device=dev, requires_grad=True)
    torch.autograd.grad((x @ w).square().sum(), [x, w])  # warm up
    torch.cuda.synchronize()
    with tracing.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            with tracing.span("train.step"):
                with tracing.span("train.forward"):
                    loss = (x @ w).square().sum()
                with tracing.span("train.backward"):
                    torch.autograd.grad(loss, [x, w])  # two products
            torch.cuda.synchronize()
    ops = spans.launched_ops(p.events())
    assert ops and all(t is not None for _, t, _, _ in ops)
    got = spans.device_seconds(ops, spans.occurrences(
        rec.take()["spans"], p.profiler.kineto_results.trace_start_ns()))
    total = sum(e - s for _, _, s, e in ops) * 1e-6
    assert got["train.step"] == pytest.approx(total)
    assert got["train.forward"] + got["train.backward"] == pytest.approx(
        total)
    assert got["train.backward"] > 1.5 * got["train.forward"] > 0
