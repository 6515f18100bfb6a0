"""output_tokens_per_s: tokens delivered to the clients in the window, over
the window's seconds."""

from portbench.stats import count_in


def read(rec: dict):
    w = rec["window"]
    n = sum(count_in(r["times"], w["t0"], w["t1"]) for r in rec["requests"])
    return n / w["seconds"]
