"""engine.kv_used_share: the paged KV pool's blocks held by live streams,
as a share of its usable blocks, averaged over the traced run's samples
(every half second of the window): how much of the memory reserved for
the KV cache the traffic fills."""


def read(rec: dict):
    samples = [(live, total) for live, total in rec.get("kv_samples", ())
               if total]
    if not samples:
        return None
    return 100.0 * sum(live / total for live, total in samples) / len(samples)
