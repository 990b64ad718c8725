#!/usr/bin/env python3
"""K6 (flash prefill) and K7 (decode attention), and on request K1 (wave
steps), K3 (guarded forwarding), K8 (selective scan) and K9 (grouped
expert matmul), timed on one card, for the ``repro_torch`` of any source
tree.

Run from the repository root on a machine with a CUDA card::

    python3 time_attention.py [--src DIR] [--label NAME] [--kernels K1,K3,K6,K6bits,K7,K8,K9]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two commits can be timed side by
side in one run on one card: unpack the other with ``git archive`` into
a git-ignored directory and run the script once for each tree. The
timing protocol is ``chip_smoke.py``'s (``_call_times``: the whole
wrapper call, the median of 7 runs of 20 calls; the card's time alone;
the host's microseconds a call), on the same shapes and seeds:

- K1 at ``chip_smoke.K1_SHAPES``: the kernel phase's image of 2**24 + 1
  words (S=8, W=2**20), an L2-resident one (2**18 + 1, S=64, W=2**18),
  and the launches of bnn (the main path's largest), RAWloop, hist+add,
  filter_pipe, WARloop and stream_dot, each with the path it took and
  the barrier cost of that path beside its bounds;
- K3 at S=D=2**20 over a float64 memory of 2**24 + 1 words,
  ``lookback=min_lookback(src)``, beside its bytes and sector-aware
  bounds;
- K6 causal at qwen3-14b's heads (H=40 over Hk=8, D=128): the serve
  path's prefill, B=4, S=128, and the kernel phase's B=1, S=4096;
- K7 at the same heads: the serve path's B=4 over 161 positions at
  frontier 160, and decode_32k cut to B=32 over 8192 positions;
- K8 at falcon-mamba-7b's widths (di=8192, n=16): the SSM path's
  prefill, B=4, S=128, and the kernel phase's B=4, S=4096;
- K9 at phi3.5-moe's prefill (T_pad=3072, block_t=128): w_in (4096 ->
  6400) and w_out (6400 -> 4096);
- ``K6bits``: no timing, the SHA-256 of K6's float32 output bytes at one
  head dim for q, k and v (``K6_DIGEST_CASES``: qwen3's serve prefill,
  zamba2's D=112, gemma3's D=256 with its window, whisper's encoder and
  one query over 1500 keys), so that two trees run on one card can be
  shown to give the same bits; where the tree's K6 writes its rows'
  log-sum-exp on request (``return_lse``), also of the output of that
  call, which must equal the other.

``--kernels`` names the kernels to time (default ``K6,K7``). Each case
is also held against its plain version (``ATTN_ATOL``, ``SCAN_ATOL``,
``_gmm_err``'s bounds). Where the tree's K6 launcher picks its tile from
the SM count (``kernel.sm_count``), the serve prefill is timed under
both tiles too, with the SM count replaced by one that forces each.
Prints one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import sys

import torch

import chip_smoke as cs


def _k6_cases():
    return [("serve", cs.SERVE_B, cs.SERVE_P), ("kernel", cs.K6_B, cs.K6_S)]


# (name, B, S, S_kv, H, Hk, D, causal, window), one head dim for q, k, v
K6_DIGEST_CASES = [
    ("qwen3 serve prefill", 4, 128, 128, 40, 8, 128, True, 0),
    ("zamba2 serve prefill", 4, 128, 128, 32, 32, 112, True, 0),
    ("gemma3 ring prefill", 2, 1088, 1088, 8, 4, 256, True, 1024),
    ("whisper encoder", 4, 1500, 1500, 6, 6, 64, False, 0),
    ("whisper cross decode", 4, 1, 1500, 6, 6, 64, False, 0),
]


def k6_digests(kernel) -> dict:
    """SHA-256 (first 16 hex digits) of K6's output bytes at
    ``K6_DIGEST_CASES``, inputs from seed 16; where the tree's K6 can
    write its rows' log-sum-exp (``return_lse``), also of the output of
    the call that writes it, under the case's name plus " (lse)"."""
    digest = lambda t: hashlib.sha256(  # noqa: E731
        t.cpu().numpy().tobytes()).hexdigest()[:16]
    has_lse = "return_lse" in inspect.signature(
        kernel.flash_attention_gqa).parameters
    out = {}
    for name, b, s, s_kv, h, hk, d, causal, window in K6_DIGEST_CASES:
        g = torch.Generator(device="cuda").manual_seed(16)
        q = cs._randn(g, b, s, h, d)
        k, v = (cs._randn(g, b, s_kv, hk, d) for _ in "kv")
        got = kernel.flash_attention_gqa(q, k, v, causal=causal,
                                         window=window)
        out[name] = digest(got)
        if has_lse:
            got, _ = kernel.flash_attention_gqa(
                q, k, v, causal=causal, window=window, return_lse=True)
            out[name + " (lse)"] = digest(got)
    return out


def time_k1() -> dict:
    from repro_torch.kernels.wave_exec import kernel
    from repro_torch.kernels.wave_exec.ref import random_tables, wave_loop_ref

    return {name: cs.time_wave_case(kernel, wave_loop_ref, random_tables,
                                    20 + seed, m, s, w, plain=False)
            for seed, (name, (m, s, w)) in enumerate(cs.K1_SHAPES.items())}


def time_k3() -> dict:
    from repro_torch.kernels.fused_stream import kernel
    from repro_torch.kernels.fused_stream.ops import min_lookback
    from repro_torch.kernels.fused_stream.ref import fused_stream_ref

    return cs.time_forward_case(kernel, fused_stream_ref, min_lookback,
                                plain=False)


def time_k6(kernel, flash_gqa_ref) -> dict:
    out = {}
    for name, b, s in _k6_cases():
        g = torch.Generator(device="cuda").manual_seed(11)
        q = cs._randn(g, b, s, cs.K6_H, cs.K6_D)
        k, v = (cs._randn(g, b, s, cs.K6_HK, cs.K6_D) for _ in "kv")
        want = flash_gqa_ref(q, k, v, causal=True)
        err = cs._within(kernel.flash_attention_gqa(q, k, v), want,
                         f"K6 {name}")
        bound = cs._flash_bounds(b, s, cs.K6_H, cs.K6_HK, cs.K6_D)["bound_ms"]
        row = {"B": b, "S": s, "max_abs_err": err, **cs._call_times(
            lambda: kernel.flash_attention_gqa(q, k, v), bound)}
        if name == "serve" and hasattr(kernel, "sm_count"):
            row["tiles"] = _k6_tiles(kernel, q, k, v, want, bound)
        out[name] = row
    return out


def _k6_tiles(kernel, q, k, v, want, bound) -> dict:
    """The serve prefill under each tile, the launcher's SM count replaced
    for the call: an SM count of 1 makes any grid fill the card (8 warps
    of 16 rows), one of 10**6 none (4 warps)."""
    tiles = {}
    sm_count = kernel.sm_count
    try:
        for warps, sms in (("8_warps", 1), ("4_warps", 10**6)):
            kernel.sm_count = lambda index, sms=sms: sms
            call = lambda: kernel.flash_attention_gqa(q, k, v)  # noqa: E731
            out = call()
            torch.cuda.synchronize()
            tiles[warps] = {
                "max_abs_err": cs._within(out, want, f"K6 {warps}"),
                **cs._call_times(call, bound)}
    finally:
        kernel.sm_count = sm_count
    return tiles


def time_k7(kernel, decode_gqa_ref) -> dict:
    scale = cs.K7_D ** -0.5
    g = torch.Generator(device="cuda").manual_seed(12)
    q = cs._randn(g, cs.K7_B, cs.K7_H, cs.K7_D)
    kc, vc = (cs._randn(g, cs.K7_B, cs.K7_C, cs.K7_HK, cs.K7_D)
              for _ in "kv")
    lengths = torch.randint(1, cs.K7_C + 1, (cs.K7_B,), generator=g,
                            device="cuda", dtype=torch.int32)
    lengths[0], lengths[1] = 1, cs.K7_C
    last = cs.SERVE_P + cs.SERVE_NEW
    qs = cs._randn(g, cs.SERVE_B, cs.K7_H, cs.K7_D)
    ks, vs = (cs._randn(g, cs.SERVE_B, cs.SERVE_MAX_SEQ, cs.K7_HK, cs.K7_D)
              for _ in "kv")
    lens = torch.full((cs.SERVE_B,), last, dtype=torch.int32, device="cuda")
    cases = {
        "serve": (qs, ks, vs, lens, cs.SERVE_B * last),
        "kernel": (q, kc, vc, lengths,
                   int(lengths.clamp(max=cs.K7_C).sum().item())),
    }
    out = {}
    for name, (q_, k_, v_, l_, committed) in cases.items():
        call = lambda: kernel.decode_attention_gqa(  # noqa: E731
            q_, k_, v_, l_, sm_scale=scale)
        err = cs._within(call(), decode_gqa_ref(q_, k_, v_, l_,
                                                sm_scale=scale), f"K7 {name}")
        bound = cs._decode_bound_bytes_ms(q_.shape[0], cs.K7_H, cs.K7_HK,
                                          cs.K7_D, committed)
        out[name] = {"B": q_.shape[0], "C": k_.shape[1], "max_abs_err": err,
                     **cs._call_times(call, bound)}
    return out


def time_k8(kernel, selective_scan_ref) -> dict:
    cases = {"serve": (cs.SERVE_B, cs.SERVE_P, 33), "kernel": (cs.K8_B,
                                                               cs.K8_S, 30)}
    out = {}
    for name, (b, s, seed) in cases.items():
        args = cs.scan_inputs(seed, b, s, cs.K8_DI, cs.K8_N)
        y, h = kernel.selective_scan(*args)
        y_ref, h_ref = selective_scan_ref(*args)
        err = max(cs._scan_err(y, y_ref, f"K8 {name} y"),
                  cs._scan_err(h, h_ref, f"K8 {name} h_final"))
        bound = cs._scan_bounds(b, s, cs.K8_DI, cs.K8_N)["bound_ms"]
        out[name] = {"B": b, "S": s, "max_abs_err": err, **cs._call_times(
            lambda: kernel.selective_scan(*args), bound)}
        del args, y, h, y_ref, h_ref
    return out


def time_k9(kernel, group_matmul_ref) -> dict:
    x, w_in, w_out, h, be, experts = cs.gmm_inputs(40, cs.K9_BLOCK_T)
    out = {}
    for name, (a, w) in {"w_in": (x, w_in), "w_out": (h, w_out)}.items():
        call = lambda: kernel.group_matmul(  # noqa: E731
            a, w, be, block_t=cs.K9_BLOCK_T)
        want = group_matmul_ref(a, w, be, block_t=cs.K9_BLOCK_T)
        err, share = cs._gmm_err(a, w, be, cs.K9_BLOCK_T, call(), want,
                                 f"K9 {name}")
        del want
        bounds = cs._gmm_bounds(a.shape[0], w.shape[1], w.shape[2], experts)
        out[name] = {"T_pad": a.shape[0], "d_in": w.shape[1],
                     "d_out": w.shape[2], "max_abs_err": err,
                     "tf32_limit_share": share,
                     "f32_cuda_core_bound_ms":
                         bounds["f32_cuda_core_bound_ms"],
                     **cs._call_times(call, bounds["bound_ms"])}
    dense = w_in[0]
    out["dense_product_ms"] = cs._time_ms(lambda: x @ dense, cs.REPS,
                                          cs.TRIALS)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(cs.ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--kernels", default="K6,K7",
                    help="comma-separated subset of K1,K3,K6,K6bits,K7,K8,K9")
    a = ap.parse_args(argv)
    wanted = a.kernels.split(",")
    if not set(wanted) <= {"K1", "K3", "K6", "K6bits", "K7", "K8", "K9"}:
        ap.error(f"--kernels: unknown kernels in {a.kernels}")
    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.src))
    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ref import decode_gqa_ref, flash_gqa_ref
    from repro_torch.kernels.moe_group_mm import kernel as k9
    from repro_torch.kernels.moe_group_mm.ref import group_matmul_ref
    from repro_torch.kernels.ssm_scan import kernel as k8
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    timers = {
        "K1": time_k1,
        "K3": time_k3,
        "K6": lambda: time_k6(kernel, flash_gqa_ref),
        "K6bits": lambda: k6_digests(kernel),
        "K7": lambda: time_k7(kernel, decode_gqa_ref),
        "K8": lambda: time_k8(k8, selective_scan_ref),
        "K9": lambda: time_k9(k9, group_matmul_ref),
    }
    row = {"label": a.label, "src": os.path.abspath(a.src),
           "card": cs._card_line(), "kernel_file": kernel.__file__}
    for name in wanted:
        row[name] = timers[name]()
        torch.cuda.empty_cache()
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
