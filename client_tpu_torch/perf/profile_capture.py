"""Captures of the server's profiler endpoint, one after another, while
another thread launches kernels.

    python -m client_tpu_torch.perf.profile_capture [--captures 24]
        [--seconds 0.5]

Each capture goes through ``TorchInferenceServer.debug_profile`` (the code
behind POST /v2/debug/profile), from a thread of its own as an HTTP handler
takes it, while a worker thread launches small matmuls on the card. For
each capture it counts the Chrome trace's kernel events and runtime launch
events. Prints one JSON object: the card's name and power limit, the
per-capture counts, and the index of the first capture that recorded
launches but no kernel (null if none). Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import torch


def _counts(log_dir: str) -> dict:
    cats: dict = {}
    for root, _dirs, files in os.walk(log_dir):
        for name in files:
            if name.endswith(".pt.trace.json"):
                with open(os.path.join(root, name)) as fh:
                    for cat in re.findall(r'"cat": "([^"]+)"', fh.read()):
                        cats[cat] = cats.get(cat, 0) + 1
    return {"kernels": cats.get("kernel", 0),
            "launches": cats.get("cuda_runtime", 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--captures", type=int, default=24)
    ap.add_argument("--seconds", type=float, default=0.5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_capture: CUDA is not available", file=sys.stderr)
        return 1
    from client_tpu_torch.server import TorchInferenceServer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    core = TorchInferenceServer()
    stop = threading.Event()

    def launch():
        a = torch.randn(512, 512, device="cuda")
        while not stop.is_set():
            for _ in range(20):
                a = torch.tanh(a @ a * 1e-3)
            torch.cuda.synchronize()
            time.sleep(0.001)

    worker = threading.Thread(target=launch, daemon=True)
    worker.start()
    time.sleep(1.0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.captures):
            log_dir = os.path.join(tmp, str(i))
            handler = threading.Thread(
                target=core.debug_profile, args=(log_dir, args.seconds))
            handler.start()
            handler.join()
            rows.append(_counts(log_dir))
    stop.set()
    worker.join(timeout=10)
    core.stop()
    lost = [i for i, r in enumerate(rows) if r["launches"] and not r["kernels"]]
    print(json.dumps({"nvidia_smi": smi.strip(), "seconds": args.seconds,
                      "captures": rows,
                      "first_without_kernels": lost[0] if lost else None,
                      "without_kernels": len(lost)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
