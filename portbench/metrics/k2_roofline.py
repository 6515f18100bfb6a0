"""k2_roofline: K2's share of its roofline in the traced slice. For every
decode step whose token reached its client in the slice, K2 had to read,
in each layer, the slot's KV rows up to its position (ctx rows of K and
of V, Hkv x Dh each) and q, and write its output (H x Dh each); those
bytes over the card's memory bandwidth, over K2's device time. Tokens are
placed in the slice by their arrival at the client (the request log),
and a token's context is its prompt plus the tokens before it."""

from portbench.peaks import card_peaks
from portbench.trace import kernel_seconds


def read(rec: dict):
    peaks = card_peaks(rec["device"]["kind"])
    if peaks is None or "trace" not in rec:
        return None
    calls, secs = kernel_seconds(rec["trace"], "K2 paged_attention")
    if calls == 0:
        return None
    tr, s = rec["trace"], rec["shape"]
    row = s["kv_heads"] * s["head_dim"] * 2 * s["kv_bytes"]
    qo = 2 * s["heads"] * s["head_dim"] * s["kv_bytes"]
    nbytes = 0
    for r in rec["requests"]:
        for j, t in enumerate(r["times"]):
            if j and tr["t0"] <= t < tr["t1"]:
                nbytes += s["layers"] * ((r["plen"] + j) * row + qo)
    return 100.0 * nbytes / peaks[0] / secs
