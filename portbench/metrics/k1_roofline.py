"""k1_roofline: K1's share of its roofline in the traced slice: the least
time its calls could take on the card's published peaks, over K1's device
time. Each call of the encoder's one bucket attends q, k, v [B, L, H, D]
in bf16, not causal: it reads 3 and writes 1 such tensor (4 B L H D * 2
bytes) and computes QK^T and PV (4 B H L^2 D FLOPs)."""

from portbench.peaks import card_peaks
from portbench.trace import kernel_seconds


def read(rec: dict):
    peaks = card_peaks(rec["device"]["kind"])
    if peaks is None or "trace" not in rec:
        return None
    calls, secs = kernel_seconds(rec["trace"], "K1 flash_attention")
    if calls == 0:
        return None
    s = rec["shape"]
    b, l, h, d = s["bucket"], s["seq"], s["heads"], s["head_dim"]
    nbytes = 4 * b * l * h * d * 2
    flops = 4 * b * h * l * l * d
    bound = max(nbytes / peaks[0], flops / peaks[1])
    return 100.0 * calls * bound / secs
