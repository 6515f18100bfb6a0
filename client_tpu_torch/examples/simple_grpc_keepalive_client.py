#!/usr/bin/env python
"""KeepAlive-configured gRPC client: channel pings keep the connection
warm across idle gaps.

Parity: ref:src/python/examples/simple_grpc_keepalive_client.py.

The port's copy of ``examples/simple_grpc_keepalive_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_grpc_keepalive_client``.
"""

import argparse
import sys
import time

import numpy as np

from client_tpu_torch.client import grpc as grpcclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8001")
    args = ap.parse_args(argv)

    keepalive = grpcclient.KeepAliveOptions(
        keepalive_time_ms=500,
        keepalive_timeout_ms=2000,
        keepalive_permit_without_calls=True,
        http2_max_pings_without_data=0)
    client = grpcclient.InferenceServerClient(
        args.url, keepalive_options=keepalive)

    a = np.arange(16, dtype=np.int32)
    b = np.ones(16, dtype=np.int32)
    i0 = grpcclient.InferInput("INPUT0", a.shape, "INT32")
    i0.set_data_from_numpy(a)
    i1 = grpcclient.InferInput("INPUT1", b.shape, "INT32")
    i1.set_data_from_numpy(b)

    for round_no in range(2):
        result = client.infer("add_sub", [i0, i1])
        out = result.as_numpy("OUTPUT0")
        if not np.array_equal(out, a + b):
            sys.exit("error: wrong result")
        if round_no == 0:
            time.sleep(1.5)  # idle gap longer than the keepalive period
    print("PASS: keepalive channel survived idle gap")
    client.close()


if __name__ == "__main__":
    main()
