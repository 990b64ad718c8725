"""Deterministic synthetic data pipeline with document packing.

A copy of the JAX package's ``data/pipeline.py`` (numpy only; the port
imports nothing of that package): every ``(seed, step, shard)`` gives the
reference's batch bit for bit, and the tests hold it so. Host code: no
torch; the train driver moves each batch to its device.

Design goals for 1000+-node operation:

  * **Stateless determinism**: batch ``step`` is a pure function of
    (seed, step, shard) via counted PRNG keys — resuming from a
    checkpoint needs only the step counter, and elastic re-sharding
    (different host count after a failure) re-partitions the *same*
    global stream (fault tolerance without data-state checkpoints).
  * **Monotonic packing**: documents are packed into fixed (B, S)
    windows; the pack offsets are a monotonically non-decreasing stream
    — the same property the paper's DU exploits — so the pack step is a
    frontier merge (searchsorted), not a scan over documents.
  * **Host sharding**: each host materializes only its
    ``process_index`` slice of the global batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    bos: int = 1
    eos: int = 2


def _rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard])
    )


def global_batch_at(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """The full (global_batch, seq_len) batch for one step."""
    return shard_batch_at(cfg, step, shard=0, n_shards=1)


def shard_batch_at(
    cfg: DataConfig, step: int, shard: int, n_shards: int
) -> dict[str, np.ndarray]:
    """This host's slice of the step's batch. Re-sharding with a
    different n_shards yields the identical global stream (elasticity)."""
    assert cfg.global_batch % n_shards == 0
    local = cfg.global_batch // n_shards
    rows = []
    for r in range(local):
        global_row = shard * local + r
        rng = _rng(cfg, step, global_row)
        rows.append(_pack_row(cfg, rng))
    tokens = np.stack(rows)
    # next-token prediction targets
    targets = np.concatenate(
        [tokens[:, 1:], np.full((local, 1), cfg.eos, tokens.dtype)], axis=1
    )
    return {"tokens": tokens, "targets": targets}


def _pack_row(cfg: DataConfig, rng: np.random.Generator) -> np.ndarray:
    """Pack documents into one sequence window.

    Document lengths are drawn first; their cumulative offsets form the
    monotonic pack stream; boundary positions come from one searchsorted
    (frontier merge) instead of per-document append loops.
    """
    # draw docs until they cover the window (geometric lengths can
    # undershoot any fixed count)
    lens_list: list[int] = []
    total = 0
    while total < cfg.seq_len + 1:
        drawn = int(rng.geometric(1.0 / cfg.mean_doc_len))
        drawn = max(drawn, 4)
        lens_list.append(drawn)
        total += drawn + 1  # +1 for eos
    lens = np.array(lens_list)
    offsets = np.concatenate([[0], np.cumsum(lens + 1)])
    # zipfian token stream (skewed like natural text)
    body = rng.zipf(1.3, size=int(offsets[-1])).clip(3, cfg.vocab - 1)
    # frontier merge: which document owns each window position
    pos = np.arange(cfg.seq_len)
    doc_of = np.searchsorted(offsets, pos, side="right") - 1
    boundary = pos == offsets[doc_of]  # document starts -> BOS
    row = body[:cfg.seq_len].astype(np.int32)
    row[boundary[: len(row)]] = cfg.bos
    eos_pos = offsets[1:][offsets[1:] < cfg.seq_len] - 1
    row[eos_pos.astype(int)] = cfg.eos
    return row


class ShardedLoader:
    """Iterator facade used by the train driver."""

    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1,
                 start_step: int = 0):
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.step = start_step

    def __next__(self):
        b = shard_batch_at(self.cfg, self.step, self.shard, self.n_shards)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])
