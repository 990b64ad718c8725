"""Serving: batched prefill + decode with the monotonic KV-cache
frontier (DESIGN.md §3.2).

The port of ``src/repro/launch/serve.py``. The cache ``lengths`` vector
is the per-sequence RAW frontier — append (store at t) / attend (load
<= t) — and each decode step advances every frontier by one; on the
card each step launches the decode kernel K7 once per layer (gemma3-4b's
local layers over a ring of 1024 positions). A Mamba-1 stack
(falcon-mamba-7b) carries a recurrent state per layer instead and
launches no attention kernel; zamba2-7b's Mamba-2 layers carry theirs
and its shared attention block launches K7 once per application (13 a
step). minicpm3-4b's MLA layers decode in latent space in plain torch
(no kernel). whisper-tiny's decoder launches K7 and, for its cross
attention, K6 once a layer a step: ``serve_batch`` passes no encoder
output, as the reference's does, so that layer attends each token to
itself (ROADMAP queue 3). Greedy sampling, for determinism.

Run on the card (``PYTHONPATH=src``)::

    python -m repro_torch.launch.serve --arch qwen3-14b --batch 4 \\
        --prompt-len 128 --max-new 32
    python -m repro_torch.launch.serve --arch falcon-mamba-7b --batch 4 \\
        --prompt-len 128 --max-new 32
    python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b \\
        --n-layers 12 --batch 4 --prompt-len 128 --max-new 32
    python -m repro_torch.launch.serve --arch zamba2-7b --batch 4 \\
        --prompt-len 128 --max-new 32
    python -m repro_torch.launch.serve --arch gemma3-4b --batch 4 \\
        --prompt-len 128 --max-new 32
    python -m repro_torch.launch.serve --arch minicpm3-4b --batch 4 \\
        --prompt-len 128 --max-new 32
    python -m repro_torch.launch.serve --arch whisper-tiny --batch 4 \\
        --prompt-len 128 --max-new 32

zamba2-7b (27.00 GB in float32), gemma3-4b (15.52 GB), minicpm3-4b
(16.30 GB) and whisper-tiny (0.146 GB) run whole.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import base as configs
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def serve_batch(cfg, params, prompts, *, max_new: int, max_seq: int,
                dt=L.FP32):
    """prompts: ``(B, P)`` int token ids on the params' device. Returns
    the generated tokens ``(B, max_new)`` int32.

    As in the reference, the prompt is fed by teacher-forced decode, one
    step per position (``prefill`` returns an empty cache), and every
    position is fed, zero pads included (the reference computes the
    nonzero-prefix lengths and never uses them; ROADMAP queue 3)."""
    b, p_len = prompts.shape
    dev = prompts.device
    cache = T.init_cache(cfg, b, max_seq, dt, device=dev)
    serve_step = steps_lib.make_serve_step(cfg, dt)

    lens = torch.zeros(b, dtype=torch.int32, device=dev)
    for t in range(p_len):
        logits, cache, lens = serve_step(params, prompts[:, t:t + 1], cache,
                                         lens)

    out = []
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    for _ in range(max_new):
        out.append(tok)
        logits, cache, lens = serve_step(params, tok, cache, lens)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to this many layers (0 keeps the "
                         "config's): phi3.5-moe in float32 fits one 80 GB "
                         "card at 12 of its 32")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions, "
                         "for tests)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights; the prompts take seed + 1")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device, "serve")
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    dt = L.FP32
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(gen, cfg, dt, device=dev)
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(3, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)

    t0 = time.time()
    toks = serve_batch(
        cfg, params, prompts, max_new=args.max_new,
        max_seq=args.prompt_len + args.max_new + 1,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt_s = time.time() - t0
    print(f"arch={cfg.name} layers={cfg.n_layers} generated "
          f"{tuple(toks.shape)} in {dt_s:.1f}s")
    print(toks[:2].cpu())
    return toks


if __name__ == "__main__":
    main()
