#!/usr/bin/env python
"""BYTES/string tensors over gRPC against add_sub_string.

Parity: ref:src/c++/examples/simple_grpc_string_infer_client.cc.

The port's copy of ``examples/simple_grpc_string_infer_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_grpc_string_infer_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.client import grpc as grpcclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8001")
    args = ap.parse_args(argv)

    client = grpcclient.InferenceServerClient(args.url)
    a = np.arange(16)
    b = np.full(16, 5, dtype=np.int64)
    sa = np.array([str(x).encode() for x in a], dtype=np.object_)
    sb = np.array([str(x).encode() for x in b], dtype=np.object_)
    i0 = grpcclient.InferInput("INPUT0", sa.shape, "BYTES")
    i0.set_data_from_numpy(sa)
    i1 = grpcclient.InferInput("INPUT1", sb.shape, "BYTES")
    i1.set_data_from_numpy(sb)

    result = client.infer("add_sub_string", [i0, i1])
    out0 = result.as_numpy("OUTPUT0")
    for i in range(16):
        if int(out0[i]) != a[i] + b[i]:
            sys.exit("error: incorrect string result")
    print("PASS: grpc string infer")
    client.close()


if __name__ == "__main__":
    main()
