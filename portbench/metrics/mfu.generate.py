"""mfu.generate: the whole step's share of the card's dense bf16 peak in
the traced slice. Decode tokens that reached their clients in the slice
count their layers' products, the attention over their context and the
output head; prompt tokens the engine ingested in the slice (its
``prefill_tokens`` counter at the slice's edges) count their layers'
products and the attention at the mean position of the prompts in
flight, without the head."""

from portbench.peaks import card_peaks
from portbench.trace import window_s


def read(rec: dict):
    peaks = card_peaks(rec["device"]["kind"])
    if peaks is None or "trace" not in rec:
        return None
    tr, s = rec["trace"], rec["shape"]
    d, h, hkv, dh = s["d"], s["heads"], s["kv_heads"], s["head_dim"]
    layer = 2 * (d * h * dh + d * 2 * hkv * dh + h * dh * d + 3 * d * s["ff"])
    attn = 4 * h * dh          # per position of context, per layer
    head = 2 * d * s["vocab"]
    flops = 0
    for r in rec["requests"]:
        for j, t in enumerate(r["times"]):
            if j and tr["t0"] <= t < tr["t1"]:
                flops += s["layers"] * (layer + attn * (r["plen"] + j)) + head
    ingested = (rec["slice"]["after"]["gen"]["prefill_tokens"]
                - rec["slice"]["before"]["gen"]["prefill_tokens"])
    live = [r["plen"] for r in rec["requests"] if r["send"] < tr["t1"]
            and (not r["times"] or r["times"][0] >= tr["t0"])]
    mean_pos = sum(p * (p - 1) / 2 for p in live) / sum(live) if live else 0.0
    flops += ingested * s["layers"] * (layer + attn * mean_pos)
    return 100.0 * flops / window_s(tr) / peaks[1]
