"""mfu.encoder: the whole forward's share of the card's dense bf16 peak in
the traced slice: inferences completed in the slice, times the model
FLOPs of one, over the slice's seconds."""

from portbench.peaks import card_peaks
from portbench.trace import window_s


def flops_per_infer(seq: int, d: int, layers: int, ff: int) -> int:
    """Frozen copy of ``bert_flops_per_infer``
    (``client_tpu_torch/perf/bench_harness.py``), with the widths taken
    from the run's shape: matmuls (qkv+proj+ffn MACs x2 x seq) plus
    attention (QK^T + AV = 2*seq^2*d MACs x2 per layer)."""
    return (layers * (4 * d * d + 2 * d * ff) * 2 * seq
            + layers * 4 * seq * seq * d)


def read(rec: dict):
    peaks = card_peaks(rec["device"]["kind"])
    if peaks is None or "trace" not in rec:
        return None
    tr, s = rec["trace"], rec["shape"]
    n = sum(1 for _, d, ok in rec["requests"]
            if ok and tr["t0"] <= d < tr["t1"])
    flops = n * flops_per_infer(s["seq"], s["d"], s["layers"], s["ff"])
    return 100.0 * flops / window_s(tr) / peaks[1]
