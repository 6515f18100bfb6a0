#!/usr/bin/env python
"""Explicit (JSON) tensor content over HTTP: data rides the request JSON
instead of the binary extension, and the response is requested as JSON
too — the debugging-friendly wire mode.

Parity: ref:src/python/examples — the explicit-content client variants
(set_data_from_numpy(binary_data=False)).

The port's copy of ``examples/simple_http_explicit_infer_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_http_explicit_infer_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.client import http as httpclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8000")
    args = ap.parse_args(argv)

    client = httpclient.InferenceServerClient(args.url)
    a = np.arange(16, dtype=np.int32)
    b = np.full(16, 2, dtype=np.int32)

    i0 = httpclient.InferInput("INPUT0", a.shape, "INT32")
    i0.set_data_from_numpy(a, binary_data=False)
    i1 = httpclient.InferInput("INPUT1", b.shape, "INT32")
    i1.set_data_from_numpy(b, binary_data=False)
    o0 = httpclient.InferRequestedOutput("OUTPUT0", binary_data=False)
    o1 = httpclient.InferRequestedOutput("OUTPUT1", binary_data=False)

    result = client.infer("add_sub", [i0, i1], outputs=[o0, o1])
    out0 = result.as_numpy("OUTPUT0")
    out1 = result.as_numpy("OUTPUT1")
    if not np.array_equal(out0, a + b) or not np.array_equal(out1, a - b):
        sys.exit("error: explicit-content mismatch")
    print("PASS: explicit JSON content round trip")


if __name__ == "__main__":
    main()
