"""The Mamba-1 decode-step kernel's plain version and its dispatch, on the
CPU (``kernels/mamba_step``, K10).

``mamba_step_ref`` holds the model's plain step (its conv, ``_mamba1_step``,
the skip and the gate) bit for bit, several steps in a row with the window
and state carried in place. ``models.ssm.mamba_apply`` hands a Mamba-1 step
to the kernel only where ``kernel.takes`` admits it: a plain float32 tensor
on the card with no input requiring grad under grad mode. On the CPU, on
``meta``, on DTensors and under grad it takes the plain step, with no
launch. With the CPU admitted as a card (``kernel.DEVICE_TYPES``) the
wrapper runs the plain version, so the gate itself is held here too: the
step engages exactly where it should, with the plain path's bits.
"""

import dataclasses

import pytest
import torch
from torch.distributed.tensor import Replicate, distribute_tensor

from repro_torch import tracing
from repro_torch.configs import base as configs
from repro_torch.kernels.mamba_step import kernel as k10
from repro_torch.kernels.mamba_step.ref import mamba_step_ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers as L, ssm as S, transformer as T

CFG = configs.get("falcon-mamba-7b").reduced()


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _layer(seed=0, cfg=CFG):
    """A Mamba-1 layer with every bias and skip drawn (none left at its
    init's zeros or ones), and a random state."""
    g = torch.Generator().manual_seed(seed)
    p = S.mamba_init(g, cfg, L.FP32, "cpu")
    for k in ("conv_b", "dt_bias", "d_skip"):
        p[k] = 0.3 * torch.randn(p[k].shape, generator=g)
    p["a_log"] = p["a_log"] + 0.1 * torch.randn(p["a_log"].shape, generator=g)
    return p, g


def _state(g, b, cfg=CFG):
    st = S.mamba_init_state(cfg, b, device="cpu")
    st["h"].normal_(generator=g)
    st["conv"].normal_(generator=g)
    return st


def _xs(g, b, steps, cfg=CFG):
    return torch.randn(steps, b, 1, cfg.d_model, generator=g)


@pytest.mark.parametrize("b", [1, 3])
def test_plain_version_is_the_models_step(b):
    """Three steps in a row: the model's plain step (which returns new
    window and state) against ``mamba_step_ref`` on the input projection
    (which overwrites them in place), bit for bit."""
    p, g = _layer(1)
    st = _state(g, b)
    cache = {k: v.clone() for k, v in st.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    for x in _xs(g, b, 3):
        y, st = S.mamba_apply(p, x, CFG, state=st)
        xz = (x @ p["w_in"])[:, 0]
        got = mamba_step_ref(xz, cache["conv"], cache["h"],
                             *(p[k] for k in k10.PARAMS))
        _same(got[:, None] @ p["w_out"], y)
        _same(cache["conv"], st["conv"])
        _same(cache["h"], st["h"])
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs


def test_wrapper_on_the_cpu_is_the_plain_version():
    p, g = _layer(2)
    st = _state(g, 2)
    want = {k: v.clone() for k, v in st.items()}
    xz = torch.randn(2, 2 * CFG.expand * CFG.d_model, generator=g)
    before = k10.mamba_step.launches
    got = k10.mamba_step(xz, st["conv"], st["h"],
                         *(p[k] for k in k10.PARAMS))
    _same(got, mamba_step_ref(xz, want["conv"], want["h"],
                              *(p[k] for k in k10.PARAMS)))
    _same(st["conv"], want["conv"])
    _same(st["h"], want["h"])
    assert k10.mamba_step.launches == before


def test_wrapper_checks_shapes():
    p, g = _layer(3)
    st = _state(g, 2)
    xz = torch.randn(2, 2 * CFG.expand * CFG.d_model + 1, generator=g)
    with pytest.raises(ValueError, match="xz must be"):
        k10.mamba_step(xz, st["conv"], st["h"], *(p[k] for k in k10.PARAMS))


class _Spy:
    """The kernel's wrapper, recording each call; its launch counter is
    the wrapper's."""

    def __init__(self, wrapped):
        self.wrapped, self.calls = wrapped, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.wrapped(*args)

    @property
    def launches(self):
        return self.wrapped.launches


@pytest.fixture
def spy(monkeypatch):
    """The model's calls of the kernel's wrapper."""
    rec = _Spy(k10.mamba_step)
    monkeypatch.setattr(k10, "mamba_step", rec)
    return rec.calls


def test_dispatch_on_the_cpu_takes_the_plain_step(spy):
    p, g = _layer(4)
    st = _state(g, 3)
    x = _xs(g, 3, 1)[0]
    before = tracing.launch_counts()["K10"]
    y, new = S.mamba_apply(p, x, CFG, state=st)
    assert spy == [] and tracing.launch_counts()["K10"] == before
    assert new["h"] is not st["h"]  # the plain step's new state
    cfg, params, tokens = _decode_case()
    cache = T.init_cache(cfg, 3, 8, L.FP32, device="cpu")
    T.decode_step(params, tokens[:, :1], cache,
                  torch.zeros(3, dtype=torch.int32), cfg, L.FP32)
    assert spy == [] and tracing.launch_counts()["K10"] == before


def _decode_case():
    params = T.init_params(torch.Generator().manual_seed(5), CFG, L.FP32,
                           device="cpu")
    tokens = torch.randint(3, CFG.vocab, (3, 2),
                           generator=torch.Generator().manual_seed(6))
    return CFG, params, tokens


def test_dispatch_on_meta_takes_the_plain_step(spy):
    p, g = _layer(5)
    st = _state(g, 2)
    x = _xs(g, 2, 1)[0]
    meta = lambda t: t.to("meta")
    before = tracing.launch_counts()["K10"]
    y, new = S.mamba_apply({k: meta(v) for k, v in p.items()}, meta(x), CFG,
                           state={k: meta(v) for k, v in st.items()})
    assert spy == [] and tracing.launch_counts()["K10"] == before
    assert y.device.type == "meta" and tuple(y.shape) == tuple(x.shape)
    assert tuple(new["h"].shape) == tuple(st["h"].shape)


def test_dispatch_on_dtensors_takes_the_plain_step(spy, monkeypatch):
    """Replicated DTensors on a one-rank mesh, with the CPU admitted as a
    card: still the plain step, equal to it on plain tensors."""
    monkeypatch.setattr(k10, "DEVICE_TYPES", ("cuda", "cpu"))
    p, g = _layer(6)
    st = _state(g, 2)
    x = _xs(g, 2, 1)[0]
    with monkeypatch.context() as m:
        m.setattr(k10, "DEVICE_TYPES", ("cuda",))
        want, want_st = S.mamba_apply(p, x, CFG,
                                      state={k: v.clone()
                                             for k, v in st.items()})
    before = tracing.launch_counts()["K10"]
    with mesh_lib.fake_world(1):
        mesh = mesh_lib.make_mesh((1,), ("data",), "cpu")
        dt = lambda t: distribute_tensor(t, mesh, [Replicate()])
        y, new = S.mamba_apply({k: dt(v) for k, v in p.items()}, dt(x), CFG,
                               state={k: dt(v) for k, v in st.items()})
        y, h = y.full_tensor(), new["h"].full_tensor()
    assert spy == [] and tracing.launch_counts()["K10"] == before
    _same(y, want)
    _same(h, want_st["h"])


def test_dispatch_under_grad_takes_the_plain_step(spy, monkeypatch):
    """A parameter requiring grad under grad mode, with the CPU admitted
    as a card: the plain step, whose graph reaches the parameter; under
    ``no_grad`` the same inputs engage the kernel's wrapper."""
    monkeypatch.setattr(k10, "DEVICE_TYPES", ("cuda", "cpu"))
    p, g = _layer(7)
    p["w_bc"].requires_grad_()
    st = _state(g, 2)
    x = _xs(g, 2, 1)[0]
    before = tracing.launch_counts()["K10"]
    y, _ = S.mamba_apply(p, x, CFG, state={k: v.clone()
                                          for k, v in st.items()})
    assert spy == [] and tracing.launch_counts()["K10"] == before
    (gw,) = torch.autograd.grad(y.sum(), [p["w_bc"]])
    assert gw.abs().sum() > 0
    with torch.no_grad():
        y2, _ = S.mamba_apply(p, x, CFG, state={k: v.clone()
                                               for k, v in st.items()})
    assert len(spy) == 1 and tracing.launch_counts()["K10"] == before
    _same(y2, y.detach())


def _widened(**kw):
    return dataclasses.replace(CFG, **kw)


@pytest.mark.parametrize("case,engages", [
    ("plain", True),
    ("bfloat16", False),
    ("param_float64", False),
    ("state_32", False),
    ("conv_5", False),
    ("no_state", False),
    ("two_positions", False),
    ("strided_state", False),
])
def test_the_gate_engages_exactly_where_it_admits(spy, monkeypatch, case,
                                                  engages):
    """With the CPU admitted as a card, ``mamba_apply`` hands the step to
    the wrapper (the plain version on the CPU) only for float32, n <= 16,
    K <= 4, a step (S = 1) from a contiguous state; either way the bits are
    the plain step's."""
    monkeypatch.setattr(k10, "DEVICE_TYPES", ("cuda", "cpu"))
    cfg = {"state_32": _widened(ssm_state=32),
           "conv_5": _widened(d_conv=5)}.get(case, CFG)
    p, g = _layer(8, cfg)
    b = 2
    st = _state(g, b, cfg)
    x = torch.randn(b, 2 if case == "two_positions" else 1, cfg.d_model,
                    generator=g)
    if case == "bfloat16":  # the model's low-precision layout: h float32
        p = {k: v if k in ("a_log", "dt_bias", "d_skip") else v.bfloat16()
             for k, v in p.items()}
        st["conv"], x = st["conv"].bfloat16(), x.bfloat16()
    if case == "param_float64":
        p["d_skip"] = p["d_skip"].double()
    if case == "strided_state":
        st["h"] = st["h"].transpose(1, 2).contiguous().transpose(1, 2)
    state = None if case == "no_state" else st
    copy = lambda s: None if s is None else {k: v.clone() for k, v in s.items()}
    y, new = S.mamba_apply(p, x, cfg, state=copy(state))
    assert len(spy) == int(engages)
    with monkeypatch.context() as m:
        m.setattr(k10, "DEVICE_TYPES", ("cuda",))
        want, want_st = S.mamba_apply(p, x, cfg, state=copy(state))
    _same(y, want)
    _same(new["h"], want_st["h"])
    _same(new["conv"], want_st["conv"])


def test_the_gate_admits_only_float32_cuda_tensors():
    p, g = _layer(9)
    st = _state(g, 2)
    xz = torch.randn(2, 2 * CFG.expand * CFG.d_model, generator=g)
    args = (xz, st["conv"], st["h"], *(p[k] for k in k10.PARAMS))
    assert not k10.takes(*args)
    meta = [t.to("meta") for t in args]
    assert not k10.takes(*meta)
