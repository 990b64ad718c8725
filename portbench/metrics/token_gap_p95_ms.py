"""token_gap_p95_ms (ms): the 95th percentile, over every decode step of
the window, of the time from one step's end to the next's, read from the
CUDA events recorded after each step (no synchronise inside the window).
A gap across two batches holds the new batch's cache and its first
step."""

import statistics


def read(rec):
    gaps = rec["gaps_ms"]
    if len(gaps) < 20:
        return None
    return statistics.quantiles(gaps, n=100, method="inclusive")[94]
