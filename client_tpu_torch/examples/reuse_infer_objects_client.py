#!/usr/bin/env python
"""Reuse InferInput/InferRequestedOutput objects across requests and
protocols (object lifecycle regression test).

Parity: ref:src/c++/examples/reuse_infer_objects_client.cc.

The port's copy of ``examples/reuse_infer_objects_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.reuse_infer_objects_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.client import http as httpclient


def run(tclient, url, label):
    client = tclient.InferenceServerClient(url)
    a = np.arange(16, dtype=np.int32)
    b = np.ones(16, dtype=np.int32)
    i0 = tclient.InferInput("INPUT0", a.shape, "INT32")
    i1 = tclient.InferInput("INPUT1", b.shape, "INT32")
    o0 = tclient.InferRequestedOutput("OUTPUT0")
    for k in range(5):
        a2 = a + k
        i0.set_data_from_numpy(a2)
        i1.set_data_from_numpy(b)
        result = client.infer("add_sub", [i0, i1], outputs=[o0])
        if not np.array_equal(result.as_numpy("OUTPUT0"), a2 + b):
            sys.exit(f"error: {label} iteration {k} mismatch")
    if hasattr(client, "close"):
        client.close()
    print(f"PASS: reuse objects over {label}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--http-url", default="localhost:8000")
    ap.add_argument("-g", "--grpc-url", default="localhost:8001")
    args = ap.parse_args(argv)
    # imported here: only the gRPC examples load grpc when imported
    from client_tpu_torch.client import grpc as grpcclient

    run(httpclient, args.http_url, "http")
    run(grpcclient, args.grpc_url, "grpc")


if __name__ == "__main__":
    main()
