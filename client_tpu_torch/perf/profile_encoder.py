"""Where the time of one encoder forward goes on the card.

    python -m client_tpu_torch.perf.profile_encoder [--attn-impl flash|ref]
        [--seq 128] [--batch 256] [--steps 5] [--trace out.json]

Builds the BERT-base-class encoder of ``bench_harness.build_bert_encoder``
(random weights from a seed) on the card, times its pipelined step with
``probe_step_ms``, then traces ``--steps`` forwards with
``torch.profiler`` and prints one JSON object: the card's name and power
limit, the step time, the device's busy and idle share of the traced
window, and the device time of each kernel per forward, grouped into
attention kernel, matrix products and the rest. ``--trace`` also writes
the Chrome trace. Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from client_tpu_torch.perf.bench_harness import build_bert_encoder, probe_step_ms

_GEMM_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")


def kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_attention"
    if any(mark in low for mark in _GEMM_MARKS):
        return "matmul"
    return "other"


def card_label() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def profile_encoder(attn_impl: str, seq: int, batch: int, steps: int,
                    trace: str | None = None) -> dict:
    model = build_bert_encoder(seq, batch, attn_impl=attn_impl)
    step_ms = probe_step_ms(model, seq, batch)
    tok = np.zeros((batch, seq), np.int32)
    dev_in = model.device_put_inputs({"input_ids": tok})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.execute_on_device(dev_in)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    if trace:
        prof.export_chrome_trace(trace)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        raise RuntimeError("the profiler saw no device time")
    busy_us = sum(e.self_device_time_total for e in kernels)
    groups: dict = {}
    for e in kernels:
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / steps / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    return {
        "card": card_label(), "attn_impl": attn_impl, "seq": seq,
        "batch": batch, "steps": steps, "step_ms": step_ms,
        "device_ms_per_forward": busy_us / steps / 1e3,
        "window_ms_per_forward": window_us / steps / 1e3,
        "device_busy_share": min(1.0, busy_us / window_us),
        "group_ms_per_forward": groups,
        "top_kernels": [{"name": e.key[:120], "group": kernel_group(e.key),
                         "launches_per_forward": e.count / steps,
                         "ms_per_forward":
                             e.self_device_time_total / steps / 1e3}
                        for e in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("client_tpu_torch.perf.profile_encoder")
    ap.add_argument("--attn-impl", default="flash", choices=("flash", "ref"))
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default=None,
                    help="also write the Chrome trace to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_encoder: CUDA is not available", file=sys.stderr)
        return 1
    print(json.dumps(profile_encoder(args.attn_impl, args.seq, args.batch,
                                     args.steps, args.trace)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
