#!/usr/bin/env python
"""Async HTTP inference (future-based).

Parity: ref:src/python/examples/simple_http_async_infer_client.py.

The port's copy of ``examples/simple_http_async_infer_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_http_async_infer_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.client import http as httpclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8000")
    args = ap.parse_args(argv)

    client = httpclient.InferenceServerClient(args.url, concurrency=4)
    a = np.arange(16, dtype=np.int32)
    b = np.full(16, 2, dtype=np.int32)
    i0 = httpclient.InferInput("INPUT0", a.shape, "INT32")
    i0.set_data_from_numpy(a)
    i1 = httpclient.InferInput("INPUT1", b.shape, "INT32")
    i1.set_data_from_numpy(b)

    pending = [client.async_infer("add_sub", [i0, i1]) for _ in range(4)]
    for req in pending:
        result = req.get_result()
        if not np.array_equal(result.as_numpy("OUTPUT0"), a + b):
            sys.exit("error: incorrect async result")
    print("PASS: async infer x4")


if __name__ == "__main__":
    main()
