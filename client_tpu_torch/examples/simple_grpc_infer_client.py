#!/usr/bin/env python
"""Sync gRPC inference against add_sub; exits non-zero on mismatch.

Parity: ref:src/c++/examples/simple_grpc_infer_client.cc and
ref:src/python/examples/simple_grpc_infer_client.py.

The port's copy of ``examples/simple_grpc_infer_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_grpc_infer_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.client import grpc as grpcclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8001")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    client = grpcclient.InferenceServerClient(args.url, verbose=args.verbose)

    a = np.arange(16, dtype=np.int32)
    b = np.ones(16, dtype=np.int32)
    i0 = grpcclient.InferInput("INPUT0", a.shape, "INT32")
    i0.set_data_from_numpy(a)
    i1 = grpcclient.InferInput("INPUT1", b.shape, "INT32")
    i1.set_data_from_numpy(b)

    result = client.infer("add_sub", [i0, i1])
    out0 = result.as_numpy("OUTPUT0")
    out1 = result.as_numpy("OUTPUT1")
    if not np.array_equal(out0, a + b) or not np.array_equal(out1, a - b):
        sys.exit("error: incorrect result")
    print("PASS: grpc infer")
    client.close()


if __name__ == "__main__":
    main()
