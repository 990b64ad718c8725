#!/usr/bin/env python3
"""How far zamba2-7b's random float32 stack amplifies rounding, on the card.

``chip_smoke.py`` holds zamba2-7b's prefill logits against 128
teacher-forced decode steps within ``HYBRID_GAP_LIMIT`` times the decode
tolerance (atol 2e-3, rtol 1e-3), not within the tolerance itself. This
script measures what that limit rests on, at the hybrid path's shapes and
seeds (zamba2-7b whole, 4 prompts of 128 tokens, weights from seed 0,
prompts from seed 1), each as the error over that tolerance:

- ``gap``: the prefill's last-token logits against the teacher-forced
  decode's (what ``chip_smoke.py`` checks);
- ``half_ulp_floor``: the prefill with every embedding element moved by a
  relative N(0, 2**-24), about half an ulp, against the prefill itself:
  what the stack makes of rounding alone;
- ``stepwise_prefill``: a prefill whose SSD steps position by position
  (``_mamba2_step``) in place of the chunked form, against the decode;
- ``units``: the last position's hidden state after each of the 94 units
  (Mamba-2 layer or shared-block application), prefill against the
  decode's own trajectory (each unit's decode fed the previous unit's
  decode output): the max abs gap after the first and the last unit, and
  the hidden state's rms there.

Run from the repo root on a card: ``python3 zamba2_rounding.py``. Prints
one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

ARCH, B, P = "zamba2-7b", 4, 128
MAX_SEQ = P + 32 + 1
ATOL, RTOL = 2e-3, 1e-3


def over_tol(got, want) -> float:
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max()
                 .item())


def stepwise_chunked(S):
    """``_mamba2_chunked``'s signature, stepping the SSD one position at a
    time."""
    def run(p, x_resid, xi, cfg, h0, chunk):
        b, s, di = xi.shape
        nh = di // S.MAMBA2_HEAD
        h, ys = h0, []
        for t in range(s):
            y, h = S._mamba2_step(p, x_resid[:, t],
                                  xi[:, t].reshape(b, nh, S.MAMBA2_HEAD), h,
                                  cfg.ssm_state)
            ys.append(y.reshape(b, di))
        return torch.stack(ys, dim=1), h
    return run


def unit_trajectories(T, L, cfg, params, prompts):
    """Each unit's output at the last position: the prefill's, and the
    decode's along its own trajectory."""
    b, p_len = prompts.shape
    plan = T.layer_plan(cfg)
    weights = [T._layer_weights(params, layer) for layer in plan]
    pos = torch.arange(p_len, device="cuda")[None, :].expand(b, p_len)
    x = params["embed"][prompts.long()]
    pre = []
    for layer, lp in zip(plan, weights):
        x = T._layer_forward(layer, lp, x, cfg, pos)
        pre.append(x[:, -1])
    cache = T.init_cache(cfg, b, MAX_SEQ, L.FP32, device="cuda")
    lens = torch.zeros(b, dtype=torch.int32, device="cuda")
    for t in range(p_len):
        x = params["embed"][prompts[:, t:t + 1].long()]
        dec = []
        for layer, lp in zip(plan, weights):
            x = T._layer_decode(layer, lp, x, cfg, cache, lens,
                                lens[:, None])
            dec.append(x[:, 0])
        lens += 1
    gaps = [float((d - q).abs().max().item()) for d, q in zip(dec, pre)]
    rms = [float(q.pow(2).mean().sqrt().item()) for q in pre]
    return {"count": len(plan), "first_gap": gaps[0], "last_gap": gaps[-1],
            "max_gap": max(gaps), "first_rms": rms[0], "last_rms": rms[-1]}


def main() -> int:
    if not torch.cuda.is_available():
        print("zamba2_rounding: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import base as configs
    from repro_torch.launch import steps
    from repro_torch.models import layers as L, ssm as S, transformer as T

    t0 = time.perf_counter()
    cfg = configs.get(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(gen, cfg, L.FP32, device="cuda")
    gen.manual_seed(1)
    prompts = torch.randint(3, cfg.vocab, (B, P), generator=gen,
                            device="cuda", dtype=torch.int32)
    fwd, _ = T.prefill(params, prompts, cfg, L.FP32, max_seq=MAX_SEQ)
    step = steps.make_serve_step(cfg, L.FP32)
    cache = T.init_cache(cfg, B, MAX_SEQ, L.FP32, device="cuda")
    lens = torch.zeros(B, dtype=torch.int32, device="cuda")
    for t in range(P):
        dec, cache, lens = step(params, prompts[:, t:t + 1], cache, lens)
    del cache
    g = torch.Generator(device="cuda").manual_seed(2)
    emb = params["embed"]
    noisy = emb + torch.randn(emb.shape, generator=g, device="cuda") * (
        2.0**-24 * emb.abs())
    floor, _ = T.prefill({**params, "embed": noisy}, prompts, cfg, L.FP32,
                         max_seq=MAX_SEQ)
    saved = S._mamba2_chunked
    S._mamba2_chunked = stepwise_chunked(S)
    try:
        stepwise, _ = T.prefill(params, prompts, cfg, L.FP32,
                                max_seq=MAX_SEQ)
    finally:
        S._mamba2_chunked = saved
    out = {
        "arch": ARCH, "batch": B, "prompt_len": P, "dtype": "float32",
        "gap": over_tol(dec, fwd),
        "half_ulp_floor": over_tol(floor, fwd),
        "stepwise_prefill": over_tol(dec, stepwise),
        "gap_max_abs": float((dec - fwd).abs().max().item()),
        "half_ulp_floor_max_abs": float((floor - fwd).abs().max().item()),
        "stepwise_prefill_max_abs": float((dec - stepwise).abs().max()
                                          .item()),
        "units": unit_trajectories(T, L, cfg, params, prompts),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "seconds": time.perf_counter() - t0,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
