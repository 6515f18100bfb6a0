"""engine.queue_wait_ms: the median wait from the engine's enqueue to slot
admission of the requests admitted from the traced run's window start to
its traced slice, from the engine's ``queue_wait`` histogram
(interpolated inside its bucket)."""

from portbench.stats import histogram_median


def read(rec: dict):
    med = histogram_median(rec["latency_buckets_ns"],
                           rec["counters"]["before"]["gen"]["queue_wait"][0],
                           rec["counters"]["after"]["gen"]["queue_wait"][0])
    return None if med is None else med / 1e6
