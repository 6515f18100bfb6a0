"""device_idle.generate: the share of the traced slice in which no
operation ran on the card (the union of the profiler's device
intervals)."""

from portbench.trace import busy_s, window_s


def read(rec: dict):
    if "trace" not in rec:
        return None
    return 100.0 * (1.0 - busy_s(rec["trace"]) / window_s(rec["trace"]))
