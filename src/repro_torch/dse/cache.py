"""On-disk result cache for design-space sweeps (DESIGN.md §9).

The port's copy of ``dse/cache.py`` in the JAX package. Its code
version hashes this package's own sources, so its keys differ from the
reference's by design; the results they name are equal.

One entry per *result key*: a ``SimResult`` stored as an ``.npz``
(final arrays + a JSON metadata member) under a content-addressed file
name. The key hashes everything the result depends on — and nothing it
does not:

  * **code version** — sha256 over the source bytes of ``repro_torch.core``,
    ``repro_torch.analysis`` and ``repro_torch.dse``; any change to the
    simulator/compiler/certifier/DSE code invalidates every entry
    (conservative by design: results are cheap to recompute relative
    to debugging a stale cache),
  * **program** — ``Program.fingerprint()`` (structural IR hash),
  * **data** — array names, dtypes, shapes and bytes; parameter values,
  * **configuration** — mode, engine class (``"-"`` for STA, which has
    no engine), the canonical ``SimParams`` override tuple, and the
    speculation class (``"-"`` for kernels the knob cannot affect).

``trace_mode`` is deliberately absent: compiled and interpreted AGU
streams are bit-identical (the trace compiler's contract), so all trace modes share
one entry. Writes are atomic (tmp file + ``os.replace``), so concurrent
sweeps at worst duplicate work, never corrupt entries.

The sweep *journal* (``SweepJournal``) rides alongside the cache: an
append-only ``journal.jsonl`` in the cache directory recording one line
per completed unique run. The npz store stays the source of truth for
resume — the journal exists for observability (what ran, where, how
long) and resume accounting, so a corrupt journal line is skipped and
counted, never fatal (DESIGN.md §13).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import tempfile
from typing import Optional

import numpy as np

from repro_torch.core import loopir as ir
from repro_torch.core.simulator import SimResult

_CODE_VERSION: Optional[str] = None

CACHE_FORMAT = 1


def code_version() -> str:
    """sha256 over the repro_torch.core + repro_torch.analysis + repro_torch.dse source
    files (cached)."""
    global _CODE_VERSION
    if _CODE_VERSION is None:
        import repro_torch.analysis
        import repro_torch.core
        import repro_torch.dse

        h = hashlib.sha256()
        for pkg in (repro_torch.core, repro_torch.analysis, repro_torch.dse):
            root = os.path.dirname(pkg.__file__)
            for fn in sorted(os.listdir(root)):
                if fn.endswith(".py"):
                    with open(os.path.join(root, fn), "rb") as f:
                        h.update(fn.encode())
                        h.update(f.read())
        _CODE_VERSION = h.hexdigest()
    return _CODE_VERSION


def result_cache_key(
    program: ir.Program,
    arrays: dict[str, np.ndarray],
    params: dict[str, int],
    mode: str,
    engine_class: str,
    sim: tuple,
    version: Optional[str] = None,
    speculation: str = "-",
    predictor: str = "-",
    static_prune: str = "-",
) -> str:
    """Content hash naming one cache entry (hex sha256).

    ``speculation`` is the point's *spec class* (``SweepPoint.
    spec_class``): ``"-"`` for kernels the knob cannot affect — so
    ``off``/``auto`` share one entry there — else the knob value.
    ``predictor`` is likewise the *predictor class*
    (``SweepPoint.predictor_class``): ``"-"`` unless the point
    actually speculates, else the predictor knob — distinct predictors
    produce distinct gate schedules, hence distinct results. The
    resolved ``spec_runahead`` travels in ``sim`` (``relevant_sim``
    keeps it only for speculating points). ``static_prune`` is the
    *prune class* (``SweepPoint.prune_class``): ``"-"`` for the
    baseline hazard plan (and always for STA), ``"prune"`` when the
    certifier's forced-pass drops are applied — the variants are
    proven bit-identical but keyed separately so a certifier bug can
    never cross-contaminate entries (the certifier code itself is in
    the code version).
    """
    h = hashlib.sha256()
    h.update(f"format={CACHE_FORMAT}\x00".encode())
    h.update((version or code_version()).encode())
    h.update(program.fingerprint().encode())
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(f"{name}:{a.dtype.str}:{a.shape}\x00".encode())
        h.update(a.tobytes())
    h.update(repr(sorted((params or {}).items())).encode())
    h.update(f"\x00{mode}\x00{engine_class}\x00{sim!r}\x00{speculation}".encode())
    h.update(f"\x00{predictor}".encode())
    h.update(f"\x00{static_prune}".encode())
    return h.hexdigest()


class ResultCache:
    """Directory of ``{key}.npz`` SimResult entries."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.hits = 0
        self.misses = 0

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.npz")

    def get(self, key: str) -> Optional[SimResult]:
        fn = self._file(key)
        if not os.path.exists(fn):
            self.misses += 1
            return None
        try:
            with np.load(fn, allow_pickle=False) as z:
                meta = json.loads(str(z["__meta__"]))
                arrays = {
                    k[len("A::"):]: z[k] for k in z.files if k.startswith("A::")
                }
        except Exception:
            self.misses += 1  # unreadable/truncated entry: treat as miss
            return None
        self.hits += 1
        return SimResult(
            cycles=meta["cycles"],
            arrays=arrays,
            mode=meta["mode"],
            dram_bursts=meta["dram_bursts"],
            dram_requests=meta["dram_requests"],
            forwards=meta["forwards"],
            squashed=meta.get("squashed", 0),
            fifo_stats=meta.get("fifo_stats", []),
            spec_stats=meta.get("spec_stats", {}),
        )

    def put(self, key: str, result: SimResult) -> None:
        meta = dataclasses.asdict(result)
        meta.pop("arrays")
        buf = io.BytesIO()
        np.savez(
            buf,
            __meta__=np.array(json.dumps(meta)),
            **{f"A::{k}": v for k, v in result.arrays.items()},
        )
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(buf.getvalue())
            os.replace(tmp, self._file(key))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def keys(self) -> set[str]:
        """Keys of every readable-looking entry currently on disk."""
        return {
            fn[:-len(".npz")]
            for fn in os.listdir(self.path)
            if fn.endswith(".npz")
        }


class SweepJournal:
    """Append-only ``journal.jsonl`` next to a sweep's npz cache.

    One JSON object per line, written (with a flush) the moment a
    unique run lands: the cache key, the run's (kernel, scale, mode,
    engine, sizing) coordinates, whether it was a cache hit, and its
    wall time. Readers must tolerate torn tails and garbage — a sweep
    can be SIGKILLed mid-append — so ``load()`` skips-and-counts
    corrupt lines instead of raising (pinned by
    tests/test_torch_sweep_service.py).
    """

    FILENAME = "journal.jsonl"

    def __init__(self, cache_dir: str):
        os.makedirs(cache_dir, exist_ok=True)
        self.path = os.path.join(cache_dir, self.FILENAME)

    def append(self, entry: dict) -> None:
        line = json.dumps(entry, sort_keys=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def load(self) -> tuple[list[dict], int]:
        """(entries, n_corrupt): every parseable line, in order; corrupt
        lines are skipped with a warning and counted."""
        import warnings

        entries: list[dict] = []
        corrupt = 0
        if not os.path.exists(self.path):
            return entries, corrupt
        with open(self.path) as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                    if not isinstance(obj, dict):
                        raise ValueError("journal entry is not an object")
                except Exception:
                    corrupt += 1
                    warnings.warn(
                        f"{self.path}:{i}: skipping corrupt journal entry",
                        stacklevel=2,
                    )
                    continue
                entries.append(obj)
        return entries, corrupt
