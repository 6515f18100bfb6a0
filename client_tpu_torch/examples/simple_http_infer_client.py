#!/usr/bin/env python
"""Sync HTTP inference against add_sub; exits non-zero on mismatch.

Parity: ref:src/c++/examples/simple_http_infer_client.cc and
ref:src/python/examples/simple_http_infer_client.py.

The port's copy of ``examples/simple_http_infer_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_http_infer_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.client import http as httpclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8000")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    client = httpclient.InferenceServerClient(args.url, verbose=args.verbose)

    a = np.arange(16, dtype=np.int32)
    b = np.ones(16, dtype=np.int32)
    i0 = httpclient.InferInput("INPUT0", a.shape, "INT32")
    i0.set_data_from_numpy(a)
    i1 = httpclient.InferInput("INPUT1", b.shape, "INT32")
    i1.set_data_from_numpy(b)
    outputs = [httpclient.InferRequestedOutput("OUTPUT0"),
               httpclient.InferRequestedOutput("OUTPUT1")]

    result = client.infer("add_sub", [i0, i1], outputs=outputs)
    out0 = result.as_numpy("OUTPUT0")
    out1 = result.as_numpy("OUTPUT1")
    for i in range(16):
        print(f"{a[i]} + {b[i]} = {out0[i]}; {a[i]} - {b[i]} = {out1[i]}")
        if out0[i] != a[i] + b[i] or out1[i] != a[i] - b[i]:
            sys.exit("error: incorrect result")
    print("PASS: infer")


if __name__ == "__main__":
    main()
