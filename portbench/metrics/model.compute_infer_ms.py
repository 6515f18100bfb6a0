"""model.compute_infer_ms: the served model's compute time per execution,
from its statistics (compute_infer ns over executions: for one batch,
from the graph replay's dispatch to the host seeing its CUDA event
complete), read from the traced run's window start to its traced
slice."""


def read(rec: dict):
    a, b = rec["counters"]["after"], rec["counters"]["before"]
    n = a["execution_count"] - b["execution_count"]
    ns = (a["inference_stats"]["compute_infer"]["ns"]
          - b["inference_stats"]["compute_infer"]["ns"])
    return ns / n / 1e6 if n > 0 else None
