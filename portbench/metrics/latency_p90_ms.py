"""Nearest-rank 90th percentile of the client latency of every statement
completed with an answer in the window, in ms. A failed statement counts
as missing. Nothing under 100 samples, where fewer than ten would lie
beyond the percentile."""

from portbench import stats

MIN_SAMPLES = 100


def read(r):
    samples = [s.latency_s * 1e3 for s in r.in_window()]
    if len(samples) < MIN_SAMPLES:
        return None
    return stats.exact_percentile(samples, 0.9)
