"""The port's LM serving path (``repro_torch.configs``, ``models``,
``launch``) against the JAX package's, on the CPU.

Both packages compute with the same weights: the reference's
``init_params`` draws them and ``models/convert.py`` carries them across
bit for bit. Inputs are made with numpy from a seed. The model checks use
the reference's own tolerance for decode against forward,
``atol=2e-3, rtol=1e-3`` (``tests/test_arch_smoke.py``): the two packages
sum in different orders, and the flash loop and the decode attention
differ from each other in the same way.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.launch import serve as ref_serve
from repro.models import layers as ref_L
from repro.models import transformer as ref_T
from repro_torch.configs import base as configs
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.launch import serve, steps
from repro_torch.models import convert, layers as L, transformer as T

TOL = dict(atol=2e-3, rtol=1e-3)
SERVED = ["qwen3-14b", "starcoder2-7b", "internvl2-76b", "falcon-mamba-7b",
          "phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b", "zamba2-7b",
          "gemma3-4b", "minicpm3-4b", "whisper-tiny"]
# prefill and teacher-forced decode compute one function only without
# experts: an MoE layer's capacity (1.25·T·k/E) differs between a prompt
# of B·S tokens and a decode step of B, so decode drops other tokens
TEACHER_FORCED = [n for n in SERVED if not configs.get(n).is_moe]
NEW_FAMILIES = ["falcon-mamba-7b", "phi3.5-moe-42b-a6.6b",
                "moonshot-v1-16b-a3b"]
# the Mamba-2 hybrid and the sliding-window decoder
HYBRID_AND_WINDOWED = ["zamba2-7b", "gemma3-4b"]
# the MLA decoder and the encoder-decoder
MLA_AND_ENC_DEC = ["minicpm3-4b", "whisper-tiny"]
# the reduced MLA has a value head dim equal to q's and k's (16 = 8 + 8);
# this one gives V a dim of its own, as minicpm3's 64 against 96
MLA_OWN_DV = {"v_head_dim": 24}


@functools.cache
def _models(name, **depth):
    """(reference cfg, reference params, port cfg, port params) of the
    reduced ``name``, with the same weights; ``depth`` replaces fields of
    the reduced config (``n_layers``, ``shared_attn_every``)."""
    cfg_r = dataclasses.replace(ref_configs.get(name).reduced(), **depth)
    params_r = ref_T.init_params(jax.random.PRNGKey(0), cfg_r, ref_L.FP32)
    params = convert.from_reference(jax.tree.map(np.asarray, params_r),
                                    device="cpu")
    cfg = dataclasses.replace(configs.get(name).reduced(), **depth)
    return cfg_r, params_r, cfg, params


def _tokens(seed, cfg, b, s):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _frontend(cfg, b):
    """The stub frontend's embeddings, scaled as the reference's tests
    scale them: vision patches (internvl2) or audio frames (whisper, whose
    encoder needs them)."""
    if cfg.frontend not in ("vision", "audio"):
        return None
    return (np.random.default_rng(7).standard_normal(
        (b, cfg.frontend_len, cfg.d_model)) * 0.02).astype(np.float32)


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _enc_out(params, cfg, fe):
    """whisper's encoder output over the frames ``fe``, None elsewhere."""
    return T._encode(params, torch.from_numpy(fe), cfg) if cfg.enc_dec else (
        None)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_registry_names_match():
    """The port has every config of the reference, and of its own
    moonlight-16b-a3b alone."""
    assert set(ref_configs.all_names()) <= set(configs.all_names())
    assert len(ref_configs.all_names()) == 10
    assert set(configs.all_names()) - set(ref_configs.all_names()) == {
        "moonlight-16b-a3b"}


@pytest.mark.parametrize("name", ref_configs.all_names())
def test_arch_config_matches_reference(name):
    for mine, theirs in ((configs.get(name), ref_configs.get(name)),
                         (configs.get(name).reduced(),
                          ref_configs.get(name).reduced())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.n_params() == theirs.n_params()
        assert mine.n_active_params() == theirs.n_active_params()
        for prop in ("resolved_head_dim", "is_moe", "is_attention_free",
                     "supports_long_context"):
            assert getattr(mine, prop) == getattr(theirs, prop), prop


def test_qwen3_14b_size():
    """The card run's model: 14.77 B parameters, 59.07 GB in float32."""
    cfg = configs.get("qwen3-14b")
    assert cfg.n_params() == 14_767_882_240
    assert cfg.n_params() * 4 / 1e9 == pytest.approx(59.07, abs=0.005)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab) == (
        40, 5120, 40, 8, 128, 17408, 151936)


def _f32_gb(cfg):
    """Gigabytes of the reference's parameters for ``cfg`` in float32,
    from their shapes alone (nothing is allocated)."""
    shapes = jax.eval_shape(
        lambda k: ref_T.init_params(k, cfg, ref_L.FP32), jax.random.PRNGKey(0))
    return sum(a.size for a in jax.tree.leaves(shapes)) * 4 / 1e9


def test_falcon_mamba_and_phi35_moe_sizes():
    """The card run's new models: falcon-mamba-7b whole (28.02 GB in
    float32), phi3.5-moe at 5.20 GB a layer, so 12 of its 32 layers
    (63.47 GB) fit one 80 GB card."""
    fm = ref_configs.get("falcon-mamba-7b")
    assert _f32_gb(fm) == pytest.approx(28.02, abs=0.005)
    assert (fm.n_layers, fm.d_model, fm.expand * fm.d_model, fm.ssm_state,
            fm.vocab) == (64, 4096, 8192, 16, 65024)
    phi = ref_configs.get("phi3.5-moe-42b-a6.6b")
    one, cut = (_f32_gb(dataclasses.replace(phi, n_layers=n))
                for n in (1, 12))
    assert (cut - one) / 11 == pytest.approx(5.20, abs=0.005)
    assert cut == pytest.approx(63.47, abs=0.005)


def test_zamba2_and_gemma3_sizes():
    """The card run's new models whole: zamba2-7b (81 Mamba-2 layers of
    77.98 M parameters, the shared block, embedding and head) is 27.00 GB
    in float32 and gemma3-4b 15.52 GB: each fits one 80 GB card at full
    depth."""
    z = ref_configs.get("zamba2-7b")
    assert _f32_gb(z) == pytest.approx(27.00, abs=0.005)
    assert (z.n_layers, z.d_model, z.expand * z.d_model, z.ssm_state,
            z.shared_attn_every, z.resolved_head_dim) == (
        81, 3584, 7168, 64, 6, 112)
    one, two = (_f32_gb(dataclasses.replace(z, n_layers=n)) for n in (1, 2))
    assert (two - one) * 1e9 / 4 == pytest.approx(77_977_424, abs=1)
    g = ref_configs.get("gemma3-4b")
    assert _f32_gb(g) == pytest.approx(15.52, abs=0.005)
    assert (g.n_layers, g.sliding_window, g.local_global_ratio,
            g.resolved_head_dim, g.vocab, g.tie_embeddings) == (
        34, 1024, 5, 256, 262144, True)


# ---------------------------------------------------------------------------
# layers and the weight carry-over
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    pos = np.arange(5)[None, :].repeat(2, 0).astype(np.int32) + 11
    np.testing.assert_allclose(
        L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
        ref_L.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6),
        atol=1e-6, rtol=1e-6)
    for theta in (1e4, 1e5, 1e6):
        np.testing.assert_allclose(
            L.rope(torch.from_numpy(x), torch.from_numpy(pos)[:, :, None],
                   theta),
            ref_L.rope(jnp.asarray(x), jnp.asarray(pos)[:, :, None], theta),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["qwen3-14b", "starcoder2-7b"])
def test_mlp_matches_reference(name):
    """SwiGLU (qwen3) and the tanh-approximated GELU MLP (starcoder2)."""
    cfg_r, params_r, cfg, params = _models(name)
    x = np.random.default_rng(2).standard_normal(
        (2, 4, cfg.d_model)).astype(np.float32)
    lp_r = jax.tree.map(lambda a: a[0], params_r["layers"]["mlp"])
    lp = T.layer_params(params["layers"], 0)["mlp"]
    np.testing.assert_allclose(
        L.mlp_apply(lp, torch.from_numpy(x), cfg),
        ref_L.mlp_apply(lp_r, jnp.asarray(x), cfg_r), atol=1e-5, rtol=1e-5)


def test_convert_round_trips_bit_for_bit():
    _, params_r, cfg, params = _models("qwen3-14b")
    want = jax.tree.map(np.asarray, params_r)
    got = convert.to_numpy(params)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, a), (_, b) in zip(flat_w, flat_g):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert params["layers"]["attn"]["wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)


@pytest.mark.parametrize("name", NEW_FAMILIES + ["zamba2-7b"])
def test_convert_carries_the_nested_ssm_and_moe_dicts(name):
    """The Mamba (``layers.ssm``) and MoE (``layers.moe``, moonshot's
    ``moe.shared``) dicts and zamba2's ``shared_attn`` block go across
    leaf by leaf, bit for bit."""
    _, params_r, _, params = _models(name)
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, params_r))
    got = jax.tree_util.tree_leaves_with_path(convert.to_numpy(params))
    assert [p for p, _ in want] == [p for p, _ in got]
    for (_, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    group = "ssm" if configs.get(name).ssm else "moe"
    assert isinstance(params["layers"][group], dict)
    if name == "zamba2-7b":
        assert set(params["shared_attn"]) == {"attn_norm", "attn",
                                              "mlp_norm", "mlp"}


@pytest.mark.parametrize("name", SERVED)
def test_init_params_has_the_reference_structure(name):
    cfg_r, params_r, cfg, _ = _models(name)
    mine = T.init_params(torch.Generator().manual_seed(0), cfg, L.FP32,
                         device="cpu")
    want = jax.tree_util.tree_leaves_with_path(params_r)
    got = jax.tree_util.tree_leaves_with_path(convert.to_numpy(mine))
    assert [(p, a.shape, str(a.dtype)) for p, a in want] == [
        (p, a.shape, str(a.dtype)) for p, a in got]
    group, key = (("ssm", "w_in") if cfg.ssm else
                  ("attn", "wq_a") if cfg.attn_type == "mla" else
                  ("attn", "wq"))
    wq = mine["layers"][group][key]
    assert not torch.equal(wq[0], wq[1])  # each layer drawn anew
    std = wq.std().item() * cfg.d_model ** 0.5
    assert 0.9 < std < 1.1
    again = T.init_params(torch.Generator().manual_seed(0), cfg, L.FP32,
                          device="cpu")
    assert torch.equal(again["embed"], mine["embed"])


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SERVED)
def test_forward_and_prefill_match_reference(name):
    cfg_r, params_r, cfg, params = _models(name)
    # the reference's Mamba scan needs S to divide by its chunk (16)
    b, s = 2, 32 if cfg.ssm else 24
    tok = _tokens(3, cfg, b, s)
    fe = _frontend(cfg, b)
    want = ref_T.forward_hidden(params_r, jnp.asarray(tok), cfg_r, ref_L.FP32,
                                frontend=None if fe is None
                                else jnp.asarray(fe))
    got = T.forward_hidden(params, torch.from_numpy(tok), cfg, L.FP32,
                           frontend=None if fe is None
                           else torch.from_numpy(fe))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    want_l, want_c = ref_T.prefill(params_r, jnp.asarray(tok), cfg_r,
                                   ref_L.FP32, frontend=_jnp(fe), max_seq=40)
    prefill_step = steps.make_prefill_step(cfg, L.FP32, max_seq=40)
    batch = {"tokens": torch.from_numpy(tok)}
    if fe is not None:
        batch["frontend"] = torch.from_numpy(fe)
    got_l, got_c = prefill_step(params, batch)
    assert got_l.shape == (b, cfg.vocab)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    # the reference's prefill returns a fresh cache; so does the port's
    want_leaves = jax.tree_util.tree_leaves_with_path(want_c)
    got_leaves = jax.tree_util.tree_leaves_with_path(got_c)
    assert [p for p, _ in want_leaves] == [p for p, _ in got_leaves]
    for (_, a), (_, c) in zip(want_leaves, got_leaves):
        assert c.shape == a.shape and not c.any()


@pytest.mark.parametrize("name", SERVED)
def test_decode_step_matches_reference(name):
    cfg_r, params_r, cfg, params = _models(name)
    b, cap = 2, 32
    rng = np.random.default_rng(4)
    lengths = np.array([3, 7], np.int32)
    tok = _tokens(5, cfg, b, 1)
    # a random cache of the reference's structure: K/V (gemma3's rings and
    # global layers, zamba2's shared block), Mamba conv windows and states
    cache = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        ref_T.init_cache(cfg_r, b, cap, ref_L.FP32))
    want_l, want_c = ref_T.decode_step(
        params_r, jnp.asarray(tok), jax.tree.map(jnp.asarray, cache),
        jnp.asarray(lengths), cfg_r, ref_L.FP32)
    got_l, got_c = T.decode_step(
        params, torch.from_numpy(tok),
        jax.tree.map(lambda a: torch.from_numpy(a.copy()), cache),
        torch.from_numpy(lengths), cfg, L.FP32)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    assert sorted(got_c) == sorted(want_c)
    for mine, theirs in zip(jax.tree.leaves(got_c), jax.tree.leaves(want_c)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), **TOL)
    for key in ("kv", "local_kv", "global_kv", "shared_kv"):
        for mine, before in zip(got_c.get(key, ()), cache.get(key, ())):
            if not before.shape[0]:  # gemma3's reduced 2 layers are local
                continue
            changed = (mine.numpy() != before).any(axis=(0, 3, 4))
            assert changed.tolist() == [[i == 3 for i in range(cap)],
                                        [i == 7 for i in range(cap)]], key
    for mine, before in zip(got_c.get("mla", ()), cache.get("mla", ())):
        changed = (mine.numpy() != before).any(axis=(0, 3))
        assert changed.tolist() == [[i == 3 for i in range(cap)],
                                    [i == 7 for i in range(cap)]]
    for mine, before in zip(got_c.get("cross_kv", ()),
                            cache.get("cross_kv", ())):  # never written
        assert (mine.numpy() == before).all()


@pytest.mark.parametrize("name", TEACHER_FORCED)
def test_teacher_forced_decode_matches_forward(name):
    """Decode over the prompt, one token a step, gives the forward pass's
    last-token logits, in the port and against the reference's forward
    (whisper's steps attend to the encoder's output over the forward's
    frames)."""
    _check_teacher_forced(*_models(name))


def _check_teacher_forced(cfg_r, params_r, cfg, params):
    b, s = 2, 12
    tok = _tokens(6, cfg, b, s)
    # the decode steps see tokens alone: frames only feed whisper's encoder
    fe = _frontend(cfg, b) if cfg.enc_dec else None
    ref_logits, _ = ref_T.prefill(params_r, jnp.asarray(tok), cfg_r,
                                  ref_L.FP32, frontend=_jnp(fe))
    fwd, _ = T.prefill(params, torch.from_numpy(tok), cfg, L.FP32,
                       frontend=_torch(fe))
    enc_out = _enc_out(params, cfg, fe)
    serve_step = steps.make_serve_step(cfg, L.FP32)
    cache = T.init_cache(cfg, b, 16, L.FP32, device="cpu")
    lens = torch.zeros(b, dtype=torch.int32)
    for t in range(s):
        logits, cache, lens = serve_step(params, torch.from_numpy(
            tok[:, t:t + 1]), cache, lens, enc_out)
    assert lens.tolist() == [s, s]
    np.testing.assert_allclose(logits.numpy(), fwd.numpy(), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)


def test_serve_batch_tokens_match_reference():
    _check_serve_batch("qwen3-14b")


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_serve_batch_tokens_match_reference_ssm_and_moe(name):
    _check_serve_batch(name)


def _check_serve_batch(name, seed=8, **depth):
    """Greedy tokens equal the reference's. Equality means something only
    where the step's top-2 logit margin exceeds twice the logit
    tolerance, so the margins along the reference's own greedy path are
    computed first (teacher-forced through the port), and each row's
    tokens are held equal up to its first step below that margin (the
    whole row where there is none)."""
    cfg_r, params_r, cfg, params = _models(name, **depth)
    b, p, max_new = 2, 8, 8
    prompts = _tokens(seed, cfg, b, p)
    prompts[0, -2:] = 0  # zero pads are fed as tokens, as the reference does
    want = np.asarray(ref_serve.serve_batch(
        cfg_r, params_r, jnp.asarray(prompts), max_new=max_new,
        max_seq=p + max_new + 1))
    step = steps.make_serve_step(cfg, L.FP32)
    cache = T.init_cache(cfg, b, p + max_new + 1, L.FP32, device="cpu")
    lens = torch.zeros(b, dtype=torch.int32)
    feed = np.concatenate([prompts, want], axis=1)
    sure = np.zeros((b, max_new), bool)  # margin above twice the tolerance
    for t in range(p + max_new - 1):
        logits, cache, lens = step(params, torch.from_numpy(feed[:, t:t + 1]),
                                   cache, lens)
        if t >= p - 1:
            top = torch.topk(logits, 2, dim=-1).values
            tol = TOL["atol"] + TOL["rtol"] * top[:, 0].abs()
            sure[:, t - p + 1] = (top[:, 0] - top[:, 1] > 2 * tol).numpy()
    checked = [int(np.argmin(r)) if not r.all() else max_new for r in sure]
    assert min(checked) >= max_new // 2, sure  # most of each row is decided
    got = serve.serve_batch(cfg, params, torch.from_numpy(prompts),
                            max_new=max_new, max_seq=p + max_new + 1)
    assert got.dtype == torch.int32 and got.shape == (b, max_new)
    for row, n in enumerate(checked):
        assert got[row, :n].tolist() == want[row, :n].tolist(), row


@pytest.mark.parametrize("name,seed", [("zamba2-7b", 9), ("gemma3-4b", 8),
                                       ("minicpm3-4b", 8),
                                       ("whisper-tiny", 8)])
def test_serve_batch_tokens_match_reference_hybrid_and_windowed(name, seed):
    """zamba2's prompts come from seed 9: at seed 8 (the other families')
    its first row meets a top-2 margin under twice the tolerance at its
    third token, which leaves too little of the row decided to compare
    (its eight tokens equal the reference's all the same)."""
    _check_serve_batch(name, seed=seed)


@pytest.mark.parametrize("arch,layers", [
    *((a, 1) for a in NEW_FAMILIES[:2]), ("zamba2-7b", 3), ("gemma3-4b", 6),
    ("minicpm3-4b", 2), ("whisper-tiny", 2),
])
def test_serve_main_runs_the_new_families_on_the_cpu(arch, layers, capsys):
    """``serve.main`` on each family's cut: zamba2 at 3 layers (one
    segment of 2, the shared block, one more), gemma3 at 6 (its first
    global layer), minicpm3 and whisper whole (2 layers reduced)."""
    toks = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--max-new", "3",
                       "--n-layers", str(layers)])
    assert toks.shape == (2, 3) and toks.dtype == torch.int32
    assert ((toks >= 0) & (toks < 256)).all()
    assert f"layers={layers} " in capsys.readouterr().out


# ---------------------------------------------------------------------------
# depths the reduced configs miss
# ---------------------------------------------------------------------------


def test_zamba2_two_segments_and_a_remainder_match_reference():
    """zamba2 at 5 layers with the shared block every 2: two segments,
    each followed by the shared block (two K/V caches), and one layer
    after them. Forward, prefill, a decode step from a random state and
    cache, and 32 teacher-forced steps against the forward."""
    cfg_r, params_r, cfg, params = _models("zamba2-7b", n_layers=5,
                                           shared_attn_every=2)
    b, s = 2, 32
    tok = _tokens(40, cfg, b, s)
    want = ref_T.forward_hidden(params_r, jnp.asarray(tok), cfg_r,
                                ref_L.FP32)
    got = T.forward_hidden(params, torch.from_numpy(tok), cfg, L.FP32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_l, _ = ref_T.prefill(params_r, jnp.asarray(tok), cfg_r, ref_L.FP32)
    fwd, _ = T.prefill(params, torch.from_numpy(tok), cfg, L.FP32)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(want_l), **TOL)

    rng = np.random.default_rng(41)
    cache = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        ref_T.init_cache(cfg_r, b, s + 1, ref_L.FP32))
    assert cache["shared_kv"][0].shape[0] == 2
    lengths = np.array([4, 9], np.int32)
    want_d, want_c = ref_T.decode_step(
        params_r, jnp.asarray(tok[:, :1]), jax.tree.map(jnp.asarray, cache),
        jnp.asarray(lengths), cfg_r, ref_L.FP32)
    got_d, got_c = T.decode_step(
        params, torch.from_numpy(tok[:, :1]),
        jax.tree.map(lambda a: torch.from_numpy(a.copy()), cache),
        torch.from_numpy(lengths), cfg, L.FP32)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)
    for mine, theirs in zip(jax.tree.leaves(got_c), jax.tree.leaves(want_c)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), **TOL)

    step = steps.make_serve_step(cfg, L.FP32)
    cache = T.init_cache(cfg, b, s + 1, L.FP32, device="cpu")
    lens = torch.zeros(b, dtype=torch.int32)
    for t in range(s):
        logits, cache, lens = step(params, torch.from_numpy(tok[:, t:t + 1]),
                                   cache, lens)
    np.testing.assert_allclose(logits.numpy(), fwd.numpy(), **TOL)


def test_gemma3_ring_wraps_against_reference():
    """gemma3 at 6 layers (5 local at window 32, then 1 global) over 80
    tokens, 48 past the window, so the local rings of 32 positions wrap:
    every teacher-forced step's logits and the final caches against the
    reference's ``decode_step``, and the last step's logits against both
    packages' forward."""
    cfg_r, params_r, cfg, params = _models("gemma3-4b", n_layers=6)
    assert T._window_schedule(cfg) == [32] * 5 + [0]
    b, s = 2, 80
    tok = _tokens(42, cfg, b, s)
    ref_step = jax.jit(lambda p, t, c, n: ref_T.decode_step(
        p, t, c, n, cfg_r, ref_L.FP32))
    cache_r = ref_T.init_cache(cfg_r, b, s + 1, ref_L.FP32)
    cache = T.init_cache(cfg, b, s + 1, L.FP32, device="cpu")
    assert cache["local_kv"][0].shape == (5, b, 32, cfg.n_kv_heads, 16)
    assert cache["global_kv"][0].shape == (1, b, s + 1, cfg.n_kv_heads, 16)
    step = steps.make_serve_step(cfg, L.FP32)
    lens = torch.zeros(b, dtype=torch.int32)
    for t in range(s):
        want, cache_r = ref_step(params_r, jnp.asarray(tok[:, t:t + 1]),
                                 cache_r, jnp.full((b,), t, jnp.int32))
        logits, cache, lens = step(params, torch.from_numpy(tok[:, t:t + 1]),
                                   cache, lens)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    for key in ("local_kv", "global_kv"):
        for mine, theirs in zip(cache[key], cache_r[key]):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       **TOL)
    want_f, _ = ref_T.prefill(params_r, jnp.asarray(tok), cfg_r, ref_L.FP32)
    fwd, _ = T.prefill(params, torch.from_numpy(tok), cfg, L.FP32)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(want_f), **TOL)
    np.testing.assert_allclose(logits.numpy(), fwd.numpy(), **TOL)
    # the window binds: without it the forward differs
    full = dataclasses.replace(cfg, sliding_window=0, local_global_ratio=0)
    unwindowed, _ = T.prefill(params, torch.from_numpy(tok), full, L.FP32)
    assert not np.allclose(unwindowed.numpy(), fwd.numpy(), **TOL)


def test_serve_main_runs_on_the_cpu():
    before = attn_kernel.decode_attention.launches
    toks = serve.main(["--arch", "starcoder2-7b", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "4",
                       "--max-new", "3", "--seed", "5"])
    assert toks.shape == (2, 3) and toks.device.type == "cpu"
    assert ((toks >= 0) & (toks < 256)).all()
    assert attn_kernel.decode_attention.launches == before  # no card here


# ---------------------------------------------------------------------------
# MLA and the encoder-decoder
# ---------------------------------------------------------------------------


def test_minicpm3_and_whisper_sizes():
    """The card run's last two models whole: minicpm3-4b (62 MLA layers,
    latent 256, q/k heads of 64 + 32, v heads of 64) is 16.30 GB in
    float32 (``n_params``, which leaves out the norms, 16.29) and
    whisper-tiny (4 + 4 layers of 384, the decoder's with cross
    attention) 0.146 GB."""
    m = ref_configs.get("minicpm3-4b")
    assert _f32_gb(m) == pytest.approx(16.30, abs=0.005)
    assert m.n_params() * 4 / 1e9 == pytest.approx(16.29, abs=0.005)
    assert (m.n_layers, m.d_model, m.n_heads, m.kv_lora_rank, m.qk_nope_dim,
            m.qk_rope_dim, m.v_head_dim) == (62, 2560, 40, 256, 64, 32, 64)
    w = ref_configs.get("whisper-tiny")
    assert _f32_gb(w) == pytest.approx(0.146, abs=0.0005)
    assert (w.n_layers, w.n_enc_layers, w.d_model, w.n_heads,
            w.resolved_head_dim, w.vocab, w.frontend_len) == (
        4, 4, 384, 6, 64, 51865, 1500)


@pytest.mark.parametrize("name", MLA_AND_ENC_DEC)
def test_convert_carries_the_encoder_and_mla_keys(name):
    """whisper's ``enc_layers``, ``enc_norm`` and the decoder's ``cross``
    weights, and minicpm3's MLA keys, go across leaf by leaf, bit for
    bit."""
    _, params_r, _, params = _models(name)
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, params_r))
    got = jax.tree_util.tree_leaves_with_path(convert.to_numpy(params))
    assert [p for p, _ in want] == [p for p, _ in got]
    for (_, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if name == "whisper-tiny":
        assert {"enc_layers", "enc_norm"} <= set(params)
        assert set(params["layers"]) == {"attn_norm", "attn", "cross_norm",
                                         "cross", "mlp_norm", "mlp"}
        assert set(params["enc_layers"]) == {"attn_norm", "attn", "mlp_norm",
                                             "mlp"}
    else:
        assert set(params["layers"]["attn"]) == {
            "wq_a", "wq_b", "wkv_a", "wkv_b", "wo", "q_a_norm", "kv_a_norm"}


def _gqa_layer(name):
    """Layer 0's attention of the reduced ``name``: the reference's and
    the port's weights (the same bits), and the configs."""
    cfg_r, params_r, cfg, params = _models(name)
    return (cfg_r, jax.tree.map(lambda a: a[0], params_r["layers"]["attn"]),
            cfg, T.layer_params(params["layers"], 0)["attn"])


@pytest.mark.parametrize("name", ["whisper-tiny", "qwen3-14b"])
@pytest.mark.parametrize("branch", ["cross", "encoder", "causal", "window",
                                    "one_token", "offset", "kv_cache"])
def test_gqa_apply_branches_match_reference(name, branch):
    """Each branch of ``gqa_apply`` against the reference's, with whisper's
    heads (no qk norm) and qwen3's (qk norm): cross attention to an
    encoder output of 11 frames, the encoder's non-causal attention, causal
    without a cache (with a window of 3 too; one token at position 5 over
    itself, whisper's serving quirk; positions counting up from an offset),
    and the cached branch that no path calls, from a random cache at
    lengths 3 and 7, its cache written in place."""
    cfg_r, p_r, cfg, p = _gqa_layer(name)
    rng = np.random.default_rng(50)
    b, s = 2, 1 if branch == "one_token" else 6
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    kw = {}
    if branch == "cross":
        kw = {"kv_source": rng.standard_normal((b, 11, cfg.d_model)).astype(
            np.float32), "use_rope": False}
    elif branch == "encoder":
        kw = {"causal": False, "use_rope": False}
    elif branch == "window":
        kw = {"window": 3}
    elif branch == "one_token":
        pos[:] = 5
        kw = {"use_rope": False}
    elif branch == "offset":
        pos += np.array([[4], [9]], np.int32)
    elif branch == "kv_cache":
        pos[:, :] = np.array([[3], [7]]) + np.arange(s)
        shape = (b, 16, cfg.n_kv_heads, cfg.resolved_head_dim)
        kw = {"kv_cache": tuple(rng.standard_normal(shape).astype(np.float32)
                                for _ in "kv"),
              "cache_len": np.array([3, 7], np.int32)}
    want = ref_L.gqa_apply(
        p_r, jnp.asarray(x), cfg_r, positions=jnp.asarray(pos), eps=1e-6,
        **{k: (tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else
               jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    mine_kw = {k: (tuple(torch.from_numpy(a.copy()) for a in v)
                   if isinstance(v, tuple) else
                   torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
    got = L.gqa_apply(p, torch.from_numpy(x), cfg,
                      positions=torch.from_numpy(pos), eps=1e-6, **mine_kw)
    if branch == "kv_cache":
        (want, want_c), (got, got_c) = want, got
        assert got_c[0] is mine_kw["kv_cache"][0]  # written in place
        for mine, theirs in zip(got_c, want_c):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       **TOL)
    assert got.shape == (b, s, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("part", ["forward", "decode_step", "teacher_forced",
                                  "serve_batch"])
def test_mla_with_its_own_value_dim_matches_reference(part):
    """minicpm3 reduced with ``v_head_dim=24`` against q's and k's 16 (8
    + 8), so the prefill's flash attention takes a value head dim of its
    own (K6's plain version here) and the absorbed decode a wider W_uv:
    the forward and prefill, a decode step from a random latent cache,
    teacher-forced decode against the forward, and ``serve_batch``'s
    tokens, each against the reference."""
    cfg_r, params_r, cfg, params = _models("minicpm3-4b", **MLA_OWN_DV)
    assert params["layers"]["attn"]["wo"].shape[1] == 4 * 24
    if part == "teacher_forced":
        _check_teacher_forced(cfg_r, params_r, cfg, params)
    elif part == "serve_batch":
        _check_serve_batch("minicpm3-4b", **MLA_OWN_DV)
    elif part == "forward":
        tok = _tokens(51, cfg, 2, 20)
        want = ref_T.forward_hidden(params_r, jnp.asarray(tok), cfg_r,
                                    ref_L.FP32)
        got = T.forward_hidden(params, torch.from_numpy(tok), cfg, L.FP32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        want_l, _ = ref_T.prefill(params_r, jnp.asarray(tok), cfg_r,
                                  ref_L.FP32)
        got_l, _ = T.prefill(params, torch.from_numpy(tok), cfg, L.FP32)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    else:
        rng = np.random.default_rng(52)
        cache = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            ref_T.init_cache(cfg_r, 2, 24, ref_L.FP32))
        tok, lengths = _tokens(53, cfg, 2, 1), np.array([0, 23], np.int32)
        want_l, want_c = ref_T.decode_step(
            params_r, jnp.asarray(tok), jax.tree.map(jnp.asarray, cache),
            jnp.asarray(lengths), cfg_r, ref_L.FP32)
        got_l, got_c = T.decode_step(
            params, torch.from_numpy(tok),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), cache),
            torch.from_numpy(lengths), cfg, L.FP32)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
        for mine, theirs in zip(got_c["mla"], want_c["mla"]):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       **TOL)


def test_whisper_decode_step_with_enc_out_matches_reference():
    """whisper's decode step with the encoder's output (``_cross_decode``:
    the cross K/V recomputed from it every step) against the reference's,
    from a random cache; without it the step differs, so the encoder
    really feeds it."""
    cfg_r, params_r, cfg, params = _models("whisper-tiny")
    b = 2
    rng = np.random.default_rng(54)
    fe = _frontend(cfg, b)
    enc_r = ref_T._encode(params_r, jnp.asarray(fe), cfg_r, ref_L.FP32)
    enc = T._encode(params, torch.from_numpy(fe), cfg)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_r), **TOL)
    cache = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        ref_T.init_cache(cfg_r, b, 16, ref_L.FP32))
    tok, lengths = _tokens(55, cfg, b, 1), np.array([2, 9], np.int32)
    want, _ = ref_T.decode_step(
        params_r, jnp.asarray(tok), jax.tree.map(jnp.asarray, cache),
        jnp.asarray(lengths), cfg_r, ref_L.FP32, enc_out=enc_r)
    step = steps.make_serve_step(cfg, L.FP32)
    got, _, lens = step(params, torch.from_numpy(tok),
                        jax.tree.map(lambda a: torch.from_numpy(a.copy()),
                                     cache),
                        torch.from_numpy(lengths), enc)
    assert lens.tolist() == [3, 10]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    without, _ = T.decode_step(
        params, torch.from_numpy(tok),
        jax.tree.map(lambda a: torch.from_numpy(a.copy()), cache),
        torch.from_numpy(lengths), cfg, L.FP32)
    assert not np.allclose(without.numpy(), got.numpy(), **TOL)


def test_whisper_serve_batch_runs_without_the_encoder():
    """The reference's quirk, reproduced: ``serve_batch`` passes no
    encoder output, so each decoder layer's cross attention attends the
    token to itself (its output is the cross value projection of the
    token alone), and the ``"cross_kv"`` cache stays zeros. Its tokens are
    those of teacher-forced steps without ``enc_out`` (and equal the
    reference's, ``test_serve_batch_tokens_match_reference_hybrid_and_
    windowed``), not those with it."""
    cfg_r, _, cfg, params = _models("whisper-tiny")
    lp = T.layer_params(params["layers"], 0)["cross"]
    h = torch.from_numpy(np.random.default_rng(56).standard_normal(
        (2, 1, cfg.d_model)).astype(np.float32))
    self_only = L.gqa_apply(lp, h, cfg, positions=torch.tensor([[4], [7]]),
                            use_rope=False)
    np.testing.assert_allclose(self_only.numpy(),
                               (h @ lp["wv"] @ lp["wo"]).numpy(), atol=1e-5)

    b, p, max_new = 2, 6, 4
    prompts = torch.from_numpy(_tokens(57, cfg, b, p))
    got = serve.serve_batch(cfg, params, prompts, max_new=max_new,
                            max_seq=p + max_new + 1)
    step = steps.make_serve_step(cfg, L.FP32)
    enc = _enc_out(params, cfg, _frontend(cfg, b))
    feeds = {}
    for key, enc_out in (("without", None), ("with", enc)):
        cache = T.init_cache(cfg, b, p + max_new + 1, L.FP32, device="cpu")
        lens = torch.zeros(b, dtype=torch.int32)
        for t in range(p):
            logits, cache, lens = step(params, prompts[:, t:t + 1], cache,
                                       lens, enc_out)
        feeds[key] = logits
        assert not cache["cross_kv"][0].any() and not cache["cross_kv"][1].any()
    assert got[:, 0].tolist() == feeds["without"].argmax(-1).tolist()
    assert not np.allclose(feeds["with"].numpy(), feeds["without"].numpy(),
                           **TOL)


def test_check_supported_rejects_attention_without_code():
    """All ten configs are served; an attention type that neither package
    has code for (``"none"`` without a Mamba stack) raises, naming it."""
    for name in configs.all_names():
        T.check_supported(configs.get(name))
    cfg = dataclasses.replace(configs.get("qwen3-14b").reduced(),
                              attn_type="none")
    for call in (lambda: T.check_supported(cfg),
                 lambda: T.init_params(torch.Generator(), cfg, device="cpu"),
                 lambda: T.init_cache(cfg, 1, 8, device="cpu")):
        with pytest.raises(ValueError, match="attn_type 'none'"):
            call()


def test_whisper_forward_needs_its_frames():
    cfg = configs.get("whisper-tiny").reduced()
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    with pytest.raises(ValueError, match="frontend"):
        T.forward_hidden(params, torch.zeros(1, 4, dtype=torch.int32), cfg)


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = configs.get("qwen3-14b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_reference({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-14b", "--reduced"])

