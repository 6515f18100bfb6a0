"""lane.host_ms_per_dispatch: the engine thread's host milliseconds in the
chunked-prefill lane per lane dispatch: the engine's
``phase_seconds["prefill"]`` (``_dispatch_prefill_lane``, the piggyback
lane the cells run) over its ``prefill_lane["chunks"]``, read from the
traced run's window start to its traced slice."""


def read(rec: dict):
    a = rec["counters"]["after"]["engine"]
    b = rec["counters"]["before"]["engine"]
    n = a["prefill_lane"]["chunks"] - b["prefill_lane"]["chunks"]
    s = a["phase_seconds"]["prefill"] - b["phase_seconds"]["prefill"]
    return s / n * 1e3 if n > 0 else None
