"""batcher.queue_ms: the dynamic batcher's mean queue time per request,
from the served model's statistics (queue ns over requests), read from
the traced run's window start to its traced slice."""


def read(rec: dict):
    a = rec["counters"]["after"]["inference_stats"]["queue"]
    b = rec["counters"]["before"]["inference_stats"]["queue"]
    n = a["count"] - b["count"]
    return (a["ns"] - b["ns"]) / n / 1e6 if n > 0 else None
