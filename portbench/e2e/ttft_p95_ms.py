"""ttft_p95_ms: the 95th percentile, over every request sent in the
window, of the time from the client's ``infer`` call to its first token
callback; a request that failed before its first token counts as
infinitely late."""

import math

from portbench.stats import percentile


def read(rec: dict):
    t0 = rec["window"]["t0"]
    ttft = [(r["times"][0] - r["send"]) * 1e3 if r["times"] else math.inf
            for r in rec["requests"] if r["send"] >= t0]
    return percentile(ttft, 95)
