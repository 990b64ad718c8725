"""k6_launches.train (count): the change of K6's launch counter
(``flash_attention.launches``) over the program's ``train.step`` span,
the median over the steps outside the profiled ones (``spans.per_step``):
a forward and a recomputed forward a layer."""

import statistics


def read(rec):
    xs = ((rec.get("program") or {}).get("counts") or {}).get("train.step")
    return statistics.median(c.get("K6", 0) for c in xs) if xs else None
