"""latency_p95_ms: the 95th percentile, over every request sent in the
window, of the time from the client's send to its response callback; a
failed request counts as infinitely late."""

import math

from portbench.stats import percentile


def read(rec: dict):
    t0 = rec["window"]["t0"]
    lat = [(d - s) * 1e3 if ok else math.inf
           for s, d, ok in rec["requests"] if s >= t0]
    return percentile(lat, 95)
