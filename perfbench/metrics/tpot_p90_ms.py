"""90th percentile over the requests that completed in the window of
(last token - first token) / (tokens - 1), on the benchmark's stamps."""

from perfbench.harness.serve import percentile
from perfbench.harness.window import tpots_s


def read(rec):
    p = percentile(tpots_s(rec), 90)
    return None if p is None else p * 1e3
