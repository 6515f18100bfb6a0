#!/usr/bin/env python
"""Async gRPC inference (callback-based).

Parity: ref:src/python/examples/simple_grpc_async_infer_client.py.

The port's copy of ``examples/simple_grpc_async_infer_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_grpc_async_infer_client``.
"""

import argparse
import sys
import threading

import numpy as np

from client_tpu_torch.client import grpc as grpcclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8001")
    args = ap.parse_args(argv)

    client = grpcclient.InferenceServerClient(args.url)
    a = np.arange(16, dtype=np.int32)
    b = np.full(16, 3, dtype=np.int32)
    i0 = grpcclient.InferInput("INPUT0", a.shape, "INT32")
    i0.set_data_from_numpy(a)
    i1 = grpcclient.InferInput("INPUT1", b.shape, "INT32")
    i1.set_data_from_numpy(b)

    n = 4
    done = threading.Event()
    results = []

    def callback(result, error):
        results.append((result, error))
        if len(results) == n:
            done.set()

    for _ in range(n):
        client.async_infer("add_sub", [i0, i1], callback)
    if not done.wait(timeout=30):
        sys.exit("error: async callbacks timed out")
    for result, error in results:
        if error is not None:
            sys.exit(f"error: {error}")
        if not np.array_equal(result.as_numpy("OUTPUT0"), a + b):
            sys.exit("error: incorrect async result")
    print("PASS: grpc async infer x4")
    client.close()


if __name__ == "__main__":
    main()
