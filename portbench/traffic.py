"""Traffic generators: what a cell's clients send, from ``--seed`` and the
parameters of the cell's traffic file (``workloads/<cell>.json``).

- ``decode_plan``: the closed loop of offline batches of a ``serve``
  cell. The file lists the batches' shapes, ``[prompt_len, new_tokens]``
  each, shared by a batch's rows (the port's batches are rectangular).
  Every seed serves that same list over and over, each pass in an order
  of its own drawn from the seed, so two seeds do the same work; prompt
  token ids are drawn uniformly from ``token_ids`` (``"vocab"`` stands
  for the vocabulary size, as ``launch.serve.main`` draws them from 3
  up).
- ``train_rows``: the packed rows of a ``train`` cell, a copy of the
  packing arithmetic of the port's ``data/pipeline.py`` (documents of
  geometric length, at least 4, each closed by EOS and opened by BOS,
  zipf-skewed token ids, one numpy generator per ``(seed, step, row)``).
  The program's own loader makes the rows it trains on; the reference
  makes them again here, so a loader that feeds other rows fails the
  check.

Every draw is a pure function of ``(seed, index)``, so the same seed
gives the same traffic and any batch can be made again on its own.
"""

from __future__ import annotations

import numpy as np

BOS, EOS = 1, 2


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(list(key)))


def _bound(v, vocab: int) -> int:
    return vocab if v == "vocab" else int(v)


class DecodePlan:
    """The batches of a ``serve`` cell, made on demand: ``shape(i)`` is
    ``(prompt_len, new_tokens)`` of batch ``i`` and ``prompts(i, device)``
    its ``(batch, prompt_len)`` int32 token ids."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.batch = int(traffic["batch"])
        self.shapes = [(int(p), int(n)) for p, n in traffic["batches"]]
        lo, hi = traffic["token_ids"]
        self.t_lo, self.t_hi = _bound(lo, vocab), _bound(hi, vocab)
        self.seed = int(seed)

    def shape(self, i: int) -> tuple[int, int]:
        k = len(self.shapes)
        order = _rng(self.seed, 1, i // k).permutation(k)
        return self.shapes[int(order[i % k])]

    def prompts(self, i: int, device) -> "torch.Tensor":
        import torch

        p, _ = self.shape(i)
        r = _rng(self.seed, 2, i)
        ids = r.integers(self.t_lo, self.t_hi, size=(self.batch, p),
                         dtype=np.int64)
        return torch.from_numpy(ids.astype(np.int32)).to(device)


def decode_plan(traffic: dict, vocab: int, seed: int) -> DecodePlan:
    return DecodePlan(traffic, vocab, seed)


def _pack_row(seq_len: int, vocab: int, mean_doc_len: int,
              rng: np.random.Generator) -> np.ndarray:
    """One packed row of ``seq_len`` token ids."""
    lens, total = [], 0
    while total < seq_len + 1:
        n = max(int(rng.geometric(1.0 / mean_doc_len)), 4)
        lens.append(n)
        total += n + 1  # and its EOS
    offsets = np.concatenate([[0], np.cumsum(np.array(lens) + 1)])
    body = rng.zipf(1.3, size=int(offsets[-1])).clip(3, vocab - 1)
    pos = np.arange(seq_len)
    owner = np.searchsorted(offsets, pos, side="right") - 1
    row = body[:seq_len].astype(np.int32)
    row[pos == offsets[owner]] = BOS
    row[(offsets[1:][offsets[1:] < seq_len] - 1).astype(int)] = EOS
    return row


def train_rows(traffic: dict, vocab: int, seed: int, step: int) -> dict:
    """Step ``step``'s ``{"tokens", "targets"}``, ``(batch, seq_len)``
    int32 numpy arrays; the targets are the tokens shifted by one, EOS
    last."""
    b, s = int(traffic["batch"]), int(traffic["seq_len"])
    mean = int(traffic["mean_doc_len"])
    tokens = np.stack([_pack_row(s, vocab, mean, _rng(seed, step, r))
                       for r in range(b)])
    targets = np.concatenate(
        [tokens[:, 1:], np.full((b, 1), EOS, tokens.dtype)], axis=1)
    return {"tokens": tokens, "targets": targets}
