"""Flash attention (K6) and KV-cache decode attention (K7), on the card.

The port of the TPU kernels ``src/repro/kernels/attention/kernel.py``
(``_flash_kernel`` through ``flash_attention``, ``_decode_kernel``
through ``decode_attention``), written by hand in CUDA C++ for
``sm_90a`` (``csrc/attention.cu``; the design notes and the bounds are
there). Each kernel has two entries:

- the reference's signature, ``(BH, S, d)`` tensors:
  ``flash_attention`` and ``decode_attention``, which the tests hold
  against the Pallas kernels;
- the model's layout, ``(B, S, H, D)`` queries over ``(B, S_kv, Hk, D)``
  keys and values with query head ``h`` on kv head ``h // (H // Hk)``:
  ``flash_attention_gqa`` (called by ``models.flash.flash_mha``) and
  ``decode_attention_gqa`` (called by ``transformer._decode_gqa``).

Sizes are run-time: no block has to divide S or S_kv (the reference
asserts it). ``block_q`` and ``block_k`` are kept for the reference's
signature and change nothing: the CUDA kernels choose their own tiles
and splits from the shape and the card's SM count (``sm_count``), and
the plain versions compute the full scores.

On a CUDA tensor each entry launches its kernel on the current stream
(``repro_torch.device.launch``), built from source at first use
(``repro_torch._build``), and raises on any build or launch failure.
Only tensors on the CPU, which the tests pass, go to the plain versions
in ``ref.py``. ``flash_attention.launches`` and
``decode_attention.launches`` count the launches of K6 and K7 through
either entry, one a call.

K7 splits the cache positions over blocks (``decode_splits``) and merges
the splits' partials inside the same launch. Its scratch (sizes on a
132-SM H100):

- the partials, allocated with ``torch.empty`` for each call:
  ``4 * B * Hk * n_split * (H // Hk) * (D + 2)`` bytes
  (``decode_scratch_floats``), 21.3 MB at B=32, H=40, Hk=8, C=8192,
  D=128 (32 splits) and 0.50 MB at B=4, C=161 (6 splits);
- the tickets, ``4 * B * Hk`` bytes of int32 zeros that the last block of
  each kv head counts up to and sets back to 0, kept per (device, stream)
  and grown as needed. Calls on one stream run in order, so each finds
  its tickets at 0. Calls on two streams at once use two sets and do not
  meet; one stream's tickets must not be shared with a call running on
  another (a call cut short by a fault would leave them non-zero, but
  such a fault ends the CUDA context anyway).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build, device
from repro_torch.kernels.attention.ref import (
    decode_attention_ref,
    decode_gqa_ref,
    flash_attention_ref,
    flash_gqa_ref,
)

MAX_HEAD_DIM = 256  # kMaxD in csrc/attention.cu
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_INT32_MAX = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [i, p, p, p, p, i, i, i, i, i, i,
                                           i, f, i, p]
    lib.flash_attention_launch.restype = i
    lib.decode_attention_launch.argtypes = [i, p, p, p, p, p, p, p, i, i, i,
                                            i, i, f, i, p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_splits.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.decode_attention_splits.restype = i
    lib.decode_attention_scratch_floats.argtypes = [i, i, i, i, i, i]
    lib.decode_attention_scratch_floats.restype = ctypes.c_longlong
    lib.attention_error_string.argtypes = [i]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib


def _device(what, *tensors) -> torch.device:
    """The one device of ``tensors``: the CPU or a CUDA device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _check_cuda(what, *tensors):
    dt = tensors[0].dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{what}: q, k and v must share one of float32, "
                        f"float16, bfloat16; got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.numel() > _INT32_MAX for t in tensors):
        raise ValueError(f"{what}: tensors must hold < 2**31 elements")


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, asked once: K6 picks its
    tile and K7 its splits from it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _lib().attention_error_string(rc).decode())


def _check_heads(what, h, hk, d, dk, dv):
    if hk < 1 or h % hk:
        raise ValueError(f"{what}: {h} query heads do not group over {hk} "
                         f"kv heads")
    if not d == dk == dv:
        raise ValueError(f"{what}: q, k and v head dims differ ({d}, {dk}, "
                         f"{dv})")


def _launch_flash(q, k, v, causal, sm_scale):
    """K6 on contiguous ``(B, S, H, D)`` / ``(B, S_kv, Hk, D)`` CUDA
    tensors; the output is ``(B, S, H, D)`` in q's dtype."""
    what = "flash_attention"
    _check_cuda(what, q, k, v)
    b, s, h, d = q.shape
    s_kv, hk = k.shape[1], k.shape[2]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} outside [1, {MAX_HEAD_DIM}]")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if s_kv == 0:
        raise ValueError(f"{what}: no keys to attend to")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    rc = device.launch(
        q.device, _lib().flash_attention_launch, _DTYPES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, s_kv,
        h, hk, d, int(bool(causal)), float(sm_scale), sm_count(q.device.index),
    )
    _raise_on(rc, what)
    flash_attention.launches += 1
    return out


def _launch_decode(q, k_cache, v_cache, lengths, sm_scale):
    """K7 on contiguous q ``(B, H, D)`` and caches ``(B, C, Hk, D)`` CUDA
    tensors, frontier ``lengths`` ``(B,)``; the output is ``(B, H, D)``."""
    what = "decode_attention"
    _check_cuda(what, q, k_cache, v_cache)
    b, h, d = q.shape
    cap, hk = k_cache.shape[1], k_cache.shape[2]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} outside [1, {MAX_HEAD_DIM}]")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if cap == 0:
        raise ValueError(f"{what}: the cache has no entries")
    dev = q.device
    sms = sm_count(dev.index)
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    part = torch.empty(decode_scratch_floats(b, cap, h, hk, d, sms),
                       dtype=torch.float32, device=dev)
    tickets = _tickets(dev, b * hk)
    rc = device.launch(
        dev, _lib().decode_attention_launch, _DTYPES[q.dtype], q.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part.data_ptr(), tickets.data_ptr(), b, cap, h, hk,
        d, float(sm_scale), sms,
    )
    _raise_on(rc, what)
    decode_attention.launches += 1
    return out


@functools.lru_cache(maxsize=1024)
def decode_splits(b: int, cap: int, hk: int, sms: int) -> tuple[int, int]:
    """``(n_split, split_len)``: the blocks K7 splits ``cap`` cache
    positions over, per (b, kv head), and the positions each covers, as
    the built library chooses them from ``b * hk``, ``cap`` and the
    card's SM count ``sms`` alone (``sm_count``)."""
    length = ctypes.c_int(0)
    n = _lib().decode_attention_splits(b, cap, hk, sms, ctypes.byref(length))
    return n, length.value


@functools.lru_cache(maxsize=1024)
def decode_scratch_floats(b: int, cap: int, h: int, hk: int, d: int,
                          sms: int) -> int:
    """float32 words of partials a K7 call needs on a card of ``sms``
    SMs (asked of the built library, once per shape)."""
    return _lib().decode_attention_scratch_floats(b, cap, h, hk, d, sms)


_TICKETS: dict = {}


def _tickets(dev: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 ticket words at 0 for K7 on ``dev``'s current
    stream (each call leaves them at 0 again)."""
    key = (dev.index, device.raw_stream(dev))
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=dev)
    return t


def _check_blocks(*blocks):
    if any(int(x) < 1 for x in blocks):
        raise ValueError(f"blocks must be positive, got {blocks}")


def flash_attention(q, k, v, *, causal: bool = True, sm_scale: float = 1.0,
                    block_q: int = 128, block_k: int = 128):
    """``(BH, S, d)`` queries over ``(BH, S_kv, d)`` keys and values →
    ``(BH, S, d)`` in q's dtype (the reference's signature)."""
    _check_blocks(block_q, block_k)
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: q, k, v must be (BH, S, d)")
    if not (q.shape[0] == k.shape[0] == v.shape[0]
            and k.shape[1] == v.shape[1]):
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} disagree")
    _check_heads("flash_attention", 1, 1, q.shape[2], k.shape[2], v.shape[2])
    if _device("flash_attention", q, k, v).type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    return _launch_flash(q[:, :, None], k[:, :, None], v[:, :, None],
                         causal, sm_scale)[:, :, 0]


flash_attention.launches = 0


def flash_attention_gqa(q, k, v, *, causal: bool = True, window: int = 0,
                        q_block: int = 512, kv_block: int = 512):
    """``flash_mha``'s function: q ``(B, S, H, D)`` over k, v
    ``(B, S_kv, Hk, D)``, scale ``D**-0.5`` → ``(B, S, H, D)``. On the
    card ``window > 0`` (sliding-window attention) is not ported yet and
    raises ``NotImplementedError``; on the CPU the plain version takes
    it. ``q_block``/``kv_block`` are the plain version's blocks."""
    _check_blocks(q_block, kv_block)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or (
            k.shape[:3] != v.shape[:3]):
        raise ValueError("flash_attention_gqa: q must be (B, S, H, D) and "
                         "k, v (B, S_kv, Hk, D)")
    if q.shape[0] != k.shape[0]:
        raise ValueError("flash_attention_gqa: batch sizes differ")
    _check_heads("flash_attention_gqa", q.shape[2], k.shape[2], q.shape[3],
                 k.shape[3], v.shape[3])
    if _device("flash_attention_gqa", q, k, v).type == "cpu":
        return flash_gqa_ref(q, k, v, causal=causal, window=int(window),
                             q_block=q_block, kv_block=kv_block)
    if window:
        raise NotImplementedError(
            "flash_attention_gqa: sliding-window attention on the card is "
            "not ported yet (ROADMAP queue 1, item 12d)")
    return _launch_flash(q, k, v, causal, q.shape[3] ** -0.5)


def decode_attention(q, k_cache, v_cache, lengths, *, sm_scale: float = 1.0,
                     block_k: int = 128):
    """``(BH, 1, d)`` queries against ``(BH, S_max, d)`` caches masked at
    ``pos < lengths[bh]`` → ``(BH, 1, d)`` (the reference's signature)."""
    _check_blocks(block_k)
    if q.dim() != 3 or q.shape[1] != 1 or k_cache.dim() != 3:
        raise ValueError("decode_attention: q must be (BH, 1, d) and the "
                         "caches (BH, S_max, d)")
    if not (q.shape[0] == k_cache.shape[0] == lengths.shape[0]
            and k_cache.shape == v_cache.shape):
        raise ValueError("decode_attention: shapes disagree")
    _check_heads("decode_attention", 1, 1, q.shape[2], k_cache.shape[2],
                 v_cache.shape[2])
    if _device("decode_attention", q, k_cache, v_cache, lengths).type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths,
                                    sm_scale=sm_scale)
    return _launch_decode(q, k_cache[:, :, None], v_cache[:, :, None],
                          lengths, sm_scale)


decode_attention.launches = 0


def decode_attention_gqa(q, k_cache, v_cache, lengths, *, sm_scale: float):
    """One query per head, q ``(B, H, D)``, against caches
    ``(B, C, Hk, D)`` masked at ``pos < lengths[b]`` → ``(B, H, D)``.
    Rows with ``lengths <= 0`` average the whole cache, as the reference
    does."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("decode_attention_gqa: q must be (B, H, D) and the "
                         "caches (B, C, Hk, D)")
    if not q.shape[0] == k_cache.shape[0] == lengths.shape[0]:
        raise ValueError("decode_attention_gqa: batch sizes differ")
    _check_heads("decode_attention_gqa", q.shape[1], k_cache.shape[2],
                 q.shape[2], k_cache.shape[3], v_cache.shape[3])
    if _device("decode_attention_gqa", q, k_cache, v_cache,
               lengths).type == "cpu":
        return decode_gqa_ref(q, k_cache, v_cache, lengths, sm_scale=sm_scale)
    return _launch_decode(q, k_cache, v_cache, lengths, sm_scale)
