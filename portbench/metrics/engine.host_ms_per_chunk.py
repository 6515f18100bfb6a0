"""engine.host_ms_per_chunk: the engine thread's host milliseconds per
decode chunk dispatch (``dispatch_by_kind["chunk"]``), read from the
traced run's window start to its traced slice."""


def read(rec: dict):
    a = rec["counters"]["after"]["engine"]["dispatch_by_kind"]["chunk"]
    b = rec["counters"]["before"]["engine"]["dispatch_by_kind"]["chunk"]
    n = a["dispatches"] - b["dispatches"]
    return (a["host_s"] - b["host_s"]) / n * 1e3 if n > 0 else None
