#!/usr/bin/env python
"""Loop inferences and watch RSS for unbounded growth.

Parity: ref:src/python/examples/memory_growth_test.py (and the C++
memory_leak_test role, ref:src/c++/tests/memory_leak_test.cc).

The port's copy of ``examples/memory_growth_test.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.memory_growth_test``.
"""

import argparse
import os
import sys

import numpy as np

from client_tpu_torch.client import http as httpclient


def rss_mb() -> float:
    with open(f"/proc/{os.getpid()}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8000")
    ap.add_argument("-r", "--repetitions", type=int, default=200)
    ap.add_argument("--max-growth-mb", type=float, default=32.0)
    args = ap.parse_args(argv)

    client = httpclient.InferenceServerClient(args.url)
    a = np.arange(16, dtype=np.int32)
    i0 = httpclient.InferInput("INPUT0", a.shape, "INT32")
    i1 = httpclient.InferInput("INPUT1", a.shape, "INT32")

    # warm up before the baseline so allocator pools are primed
    for _ in range(20):
        i0.set_data_from_numpy(a)
        i1.set_data_from_numpy(a)
        client.infer("add_sub", [i0, i1])
    base = rss_mb()
    for k in range(args.repetitions):
        i0.set_data_from_numpy(a)
        i1.set_data_from_numpy(a)
        client.infer("add_sub", [i0, i1])
    growth = rss_mb() - base
    print(f"RSS growth after {args.repetitions} inferences: "
          f"{growth:.1f} MB")
    if growth > args.max_growth_mb:
        sys.exit(f"error: memory growth {growth:.1f} MB exceeds "
                 f"{args.max_growth_mb} MB")
    print("PASS: memory growth")


if __name__ == "__main__":
    main()
