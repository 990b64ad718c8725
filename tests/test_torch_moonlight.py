"""moonlight-16b-a3b, the port's own config, against the benchmark's plain
reference (``portbench/reference/mla_moe_lm.py``, plain torch that imports
nothing of the port), on the CPU at a reduced size with the same
mechanisms: MLA without a query LoRA, one dense layer, then two MoE layers
of 8 experts, top-2, with 2 shared experts and a sigmoid router with a
correction bias and a routed scale, served dropless (``moe_dropless``).
Weights are drawn from a seed by the reference (``draw_weights``), in the
program's layout, with the bias drawn too, so its choices are seen.

Tolerances. Both sides compute in float32; they differ in the order of
their sums (the decode attends in latent space, absorbed, where the
reference expands each head's keys; the program's experts go through the
sorted grouped products, the reference's one expert at a time): 4.3e-6
of logits up to 4.2 here. ``ATOL`` 1e-4 leaves that twentyfold, and is
tight enough that the reference with its products' operands rounded to
TF32 (8.9e-3 off) misses it, as each test of logits checks.

The cell's check (``portbench/kinds/serve_routed.py``) hands the
program's routing to the reference, which takes it only within a tie:
tested here on the reference, on the runner's map from tapped steps to
batches, and through whole runs of the cell at the reduced size, one with
a router that drops its bias."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench.reference import mla_moe_lm as R
from repro_torch.configs import base as configs
from repro_torch.kernels.moe_group_mm.ops import moe_ffn, route
from repro_torch.launch import serve, steps
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

SIZES = {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
         "d_ff": 128, "vocab": 256, "q_lora_rank": 0, "kv_lora_rank": 16,
         "qk_nope_dim": 8, "qk_rope_dim": 8, "v_head_dim": 16,
         "rope_theta": 50000.0, "n_experts": 8, "top_k": 2, "moe_d_ff": 32,
         "n_shared_experts": 2, "n_dense_layers": 1, "router_score": "sigmoid",
         "router_bias": True, "routed_scale": 2.446, "norm_eps": 1e-5,
         "tie_embeddings": False}
ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(configs.get("moonlight-16b-a3b"), **SIZES)
    return cfg, R.draw_weights(SIZES, 2**31 + 5, "cpu")


def _tokens(b, s, seed=1):
    return torch.randint(3, SIZES["vocab"], (b, s),
                         generator=torch.Generator().manual_seed(seed))


def _gap(a, b):
    return float((a - b).abs().max())


def test_the_full_config_is_the_published_model():
    """The config the cell serves: every size of the benchmark's
    configuration file, 15.96 B parameters (63.84 GB in float32)."""
    cfg = configs.get("moonlight-16b-a3b")
    sizes = json.loads((Path(__file__).resolve().parents[1] / "portbench"
                        / "configs" / "moonlight-16b-a3b.json").read_text())
    assert {k: getattr(cfg, k) for k in sizes["sizes"]} == sizes["sizes"]
    assert cfg.n_params() == 15_959_983_744
    assert cfg.n_active_params() == 2_914_649_728


def test_the_reference_lays_out_the_programs_weights():
    cfg = dataclasses.replace(configs.get("moonlight-16b-a3b"), **SIZES)
    mine = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}.")
            else:
                yield f"{pre}{k}", tuple(v.shape)

    assert sorted(flat(mine)) == sorted(
        (path, tuple(shape)) for path, shape, _ in R.leaves(SIZES))


def test_prefill_logits_match_the_reference(model):
    cfg, w = model
    tok = _tokens(3, 20)
    got, _ = T.prefill(w, tok, cfg)
    want = R.logits(w, tok, SIZES, first=19)[:, 0]
    assert _gap(got, want) <= ATOL
    hidden = T.forward_hidden(w, tok, cfg, inference=True)
    every = R.logits(w, tok, SIZES)
    assert _gap(hidden @ w["lm_head"], every) <= ATOL
    assert _gap(R.logits(w, tok, SIZES, tf32=True), every) > ATOL


def test_prefill_then_decode_through_the_cache_match_the_reference(model):
    """The prefill's last logits, then the serve step through the cache:
    the prompt fed a position a step, then greedy tokens, as
    ``serve_batch`` does; every step's logits against the reference's
    full forward over the same tokens."""
    cfg, w = model
    prompt, n_new = _tokens(2, 12, seed=2), 10
    pre, _ = T.prefill(w, prompt, cfg)
    step = steps.make_serve_step(cfg, L.FP32)
    cache = T.init_cache(cfg, 2, prompt.shape[1] + n_new + 1, device="cpu")
    lens = torch.zeros(2, dtype=torch.int32)
    seq, out = prompt, []
    for t in range(prompt.shape[1] + n_new - 1):
        logits, cache, lens = step(w, seq[:, t:t + 1], cache, lens)
        out.append(logits)
        if t >= prompt.shape[1] - 1:
            seq = torch.cat([seq, logits.argmax(-1, keepdim=True)], dim=1)
    got = torch.stack(out, dim=1)
    want = R.logits(w, seq[:, :-1], SIZES)
    assert _gap(got[:, prompt.shape[1] - 1], pre) <= ATOL
    assert _gap(got, want) <= ATOL
    assert _gap(R.logits(w, seq[:, :-1], SIZES, tf32=True), want) > ATOL
    served = serve.serve_batch(cfg, w, prompt, max_new=n_new,
                               max_seq=prompt.shape[1] + n_new + 1)
    assert served.tolist() == seq[:, prompt.shape[1]:].tolist()


def test_the_router_is_the_plain_formula():
    """Ids and gates of ``route`` against the formula: s = sigmoid(l), the
    top-k of s + b, gates s over their sum times the scale. Rows whose
    k-th and (k+1)-th s + b lie within 1e-6 are left out (a tie)."""
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(512, 16, generator=g)
    bias = 0.1 * torch.randn(16, generator=g)
    top_p, top_e = route(logits, 6, score="sigmoid", bias=bias, scale=2.446)
    s = torch.sigmoid(logits)
    order = torch.argsort(s + bias, dim=-1, descending=True)
    srt = (s + bias).gather(-1, order)
    clear = (srt[:, 5] - srt[:, 6]) > 1e-6
    assert clear.float().mean() > 0.99
    want_e = order[:, :6]
    assert torch.equal(top_e[clear], want_e[clear])
    chosen = s.gather(-1, want_e)
    want_p = chosen / chosen.sum(-1, keepdim=True) * 2.446
    torch.testing.assert_close(top_p[clear], want_p[clear], rtol=1e-6,
                               atol=0)
    assert torch.allclose(top_p.sum(-1), torch.full((512,), 2.446))


def test_moe_ffn_with_the_sigmoid_router_matches_a_per_token_loop():
    """The dropless FFN (monotonic dispatch, the grouped products' plain
    version) against each token's experts summed one by one."""
    g = torch.Generator().manual_seed(6)
    t, d, ff, e, k = 40, 32, 24, 8, 2
    x = torch.randn(t, d, generator=g)
    logits = torch.randn(t, e, generator=g)
    bias = 0.1 * torch.randn(e, generator=g)
    w_in, w_gate = (torch.randn(e, d, ff, generator=g) * d ** -0.5
                    for _ in range(2))
    w_out = torch.randn(e, ff, d, generator=g) * ff ** -0.5
    got = moe_ffn(x, logits, w_in, w_gate, w_out, top_k=k, block_t=8,
                  score="sigmoid", bias=bias, scale=2.446)
    s = torch.sigmoid(logits)
    want = torch.zeros_like(x)
    for i in range(t):
        ids = torch.topk(s[i] + bias, k).indices
        gates = s[i, ids] / s[i, ids].sum() * 2.446
        for gate, j in zip(gates, ids):
            h = torch.nn.functional.silu(x[i] @ w_gate[j]) * (x[i] @ w_in[j])
            want[i] += gate * (h @ w_out[j])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cached", [False, True])
def test_mla_without_a_query_lora_matches_the_reference_layer(model, cached):
    """``mla_apply`` with a direct ``wq``: over the whole sequence (the
    prefill branch, the latent expanded per head), and a position a step
    through its latent cache (the decode branch, absorbed), against the
    reference's attention."""
    cfg, w = model
    p = T.layer_params(w["layers"], 1)["attn"]
    x = torch.randn(2, 10, SIZES["d_model"],
                    generator=torch.Generator().manual_seed(7))
    pos = torch.arange(10)[None].expand(2, 10)
    want = R.attention(p, x, pos, SIZES, False)
    if cached:
        cache = (torch.zeros(2, 11, SIZES["kv_lora_rank"]),
                 torch.zeros(2, 11, SIZES["qk_rope_dim"]))
        got = torch.cat([L.mla_apply(p, x[:, i:i + 1], cfg,
                                     positions=pos[:, i:i + 1],
                                     kv_cache=cache,
                                     cache_len=torch.full((2,), i),
                                     eps=cfg.norm_eps)[0]
                         for i in range(10)], dim=1)
    else:
        got = L.mla_apply(p, x, cfg, positions=pos, eps=cfg.norm_eps)
    assert _gap(got, want) <= 1e-5
    assert "wq_a" not in p and "q_a_norm" not in p


def test_the_reference_takes_routes_only_within_the_tie(model):
    """``logits(..., routes=, tie=)``: its own choices change nothing;
    another expert for one token is taken only where it scores within
    ``tie`` of the reference's own top-k, and then that token's row
    changes from that position on, and the rest only by the order of
    their sums (the experts' products see other rows)."""
    _, w = model
    tok = _tokens(2, 9, seed=8)
    used = []
    plain = R.logits(w, tok, SIZES, chosen=used)
    mine = torch.stack([top for top, _ in used], dim=2)  # (2, 9, 2, 2)
    assert torch.equal(R.logits(w, tok, SIZES, routes=mine, tie=0.0), plain)
    other = mine.clone()
    e = int(other[1, 4, 0, 1])
    other[1, 4, 0, 1] = next(x for x in range(SIZES["n_experts"])
                             if x not in other[1, 4, 0].tolist())
    used = []
    held = R.logits(w, tok, SIZES, routes=other, tie=1e-6, chosen=used)
    assert torch.equal(held, plain)
    slack = used[0][1]
    assert slack[1, 4] > 1e-6 and float(slack.abs().sum() - slack[1, 4]) == 0
    taken = R.logits(w, tok, SIZES, routes=other, tie=float("inf"))
    assert _gap(taken[0], plain[0]) <= 1e-5
    assert _gap(taken[1, :4], plain[1, :4]) <= 1e-5
    assert _gap(taken[1, 4:], plain[1, 4:]) > 1e-2
    assert e != other[1, 4, 0, 1]


def test_routes_map_each_tapped_step_to_its_batch_and_position():
    """``serve_routed.Routes``: tapped step ``first + t`` holds position
    ``t`` of the batch, one tensor a MoE layer, kept through the buffer's
    growth."""
    from portbench.kinds import serve_routed

    n_moe, batch, k = 2, 5, 3
    kept = serve_routed.Routes(3, batch, k, "cpu")
    for step in range(7):
        for layer in range(n_moe):
            kept(torch.full((batch, k), 20 * step + layer)
                 + torch.arange(batch)[:, None] * 5)
    assert kept.n == 14 and len(kept.buf) == 24
    got = kept.rows(n_moe, 2, 4, [3, 1])
    assert got.shape == (2, 4, n_moe, k)
    for i, r in enumerate([3, 1]):
        for t in range(4):
            for layer in range(n_moe):
                assert (got[i, t, layer] == 20 * (2 + t) + layer + 5 * r
                        ).all()


CELL = "moonlight-16b-a3b.decode-b1024-p64n24"


def _run_cell():
    """The cell at ``SIZES`` with 4 rows, 2-token prompts and 3 new tokens
    a batch, so that a window of seconds on a busy CPU serves tokens."""
    from portbench import harness

    out = harness.run_cell(CELL, 2**31 + 3, 4.0, False, device="cpu",
                           sizes=SIZES, traffic={"batch": 4,
                                                 "batches": [[2, 3]]})
    assert out["attempted"] >= 4
    return out


def test_the_cell_runs_through_the_serve_step_and_checks_correct(capsys):
    """The cell's runner at a reduced size on the CPU: the check correct,
    and every routing choice of the program the reference's own (the taps
    mapped to their batches and positions)."""
    out = _run_cell()
    assert out["checks"]["logit_gap"]["value"] == 0.0 and out["correct"]
    err = capsys.readouterr().err
    assert " 0 beyond route_tie" in err and " 0 other than" in err


def test_a_router_that_drops_its_bias_fails_the_check(monkeypatch, capsys):
    """The program's experts chosen without the correction bias lie beyond
    the tie, the reference keeps its own, and the served tokens part from
    its best by more than the limit."""
    monkeypatch.setattr(L, "_routing", lambda p, cfg, bias=None: {
        "score": cfg.router_score, "scale": cfg.routed_scale, "bias": None})
    out = _run_cell()
    assert out["checks"]["logit_gap"]["value"] > 0.1 and not out["correct"]
    assert " 0 beyond route_tie" not in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_the_dry_run_accounts_the_serve_steps_on_a_fake_mesh(kind):
    """The reduced config's prefill and decode steps on ``meta`` shards of
    a fake 2x4 mesh: the dropless MoE on each rank's tokens
    (``layers._dropless_sharded``, K9's plain version on ``meta``) with the
    sigmoid router and its bias."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.shapes import ShapeSpec

    cfg = dataclasses.replace(configs.get("moonlight-16b-a3b").reduced(),
                              n_layers=3)
    shape = ShapeSpec(f"{kind}_32k", 128, 8, kind)
    with mesh_lib.fake_world(8):
        res = dryrun.lower_cell(cfg, shape, mesh_lib.make_host_mesh(2, 4))
    assert res["n_devices"] == 8
    assert res["roofline"]["flops_per_device"] > 0
