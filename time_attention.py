#!/usr/bin/env python3
"""K6 (flash prefill) and K7 (decode attention) timed on one card, for
the ``repro_torch`` of any source tree.

Run from the repository root on a machine with a CUDA card::

    python3 time_attention.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two commits can be timed side by
side in one run on one card: unpack the other with ``git archive`` into
a git-ignored directory and run the script once for each tree. The
timing protocol is ``chip_smoke.py``'s (``_call_times``: the whole
wrapper call, the median of 7 runs of 20 calls; the card's time alone;
the host's microseconds a call), on the same shapes and seeds:

- K6 causal at qwen3-14b's heads (H=40 over Hk=8, D=128): the serve
  path's prefill, B=4, S=128, and the kernel phase's B=1, S=4096;
- K7 at the same heads: the serve path's B=4 over 161 positions at
  frontier 160, and decode_32k cut to B=32 over 8192 positions.

Each case is also held against its plain version (``ATTN_ATOL``). Where
the tree's K6 launcher picks its tile from the SM count
(``kernel.sm_count``), the serve prefill is timed under both tiles too,
by passing the launcher an SM count that forces each. Prints one JSON
line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

import chip_smoke as cs


def _k6_cases():
    return [("serve", cs.SERVE_B, cs.SERVE_P), ("kernel", cs.K6_B, cs.K6_S)]


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
    """The serve prefill through the raw launcher under each tile: an SM
    count of 1 makes any grid fill the card (8 warps of 16 rows), one of
    10**6 none (4 warps)."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    out = torch.empty_like(q)
    tiles = {}
    for warps, sms in (("8_warps", 1), ("4_warps", 10**6)):
        def call(sms=sms):
            rc = kernel.device.launch(
                q.device, kernel._lib().flash_attention_launch, 0,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                s, s, h, hk, d, 1, d ** -0.5, sms)
            if rc:
                raise RuntimeError(f"K6 launch failed: {rc}")
        call()
        torch.cuda.synchronize()
        tiles[warps] = {
            "max_abs_err": cs._within(out, want, f"K6 {warps}"),
            **cs._call_times(call, bound)}
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(cs.ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.src))
    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ref import decode_gqa_ref, flash_gqa_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({
        "label": a.label, "src": os.path.abspath(a.src),
        "card": cs._card_line(), "kernel_file": kernel.__file__,
        "K6": time_k6(kernel, flash_gqa_ref),
        "K7": time_k7(kernel, decode_gqa_ref),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
