#!/usr/bin/env python
"""Stateful sequences with synchronous unary calls.

Parity: ref:src/c++/examples/simple_grpc_sequence_sync_client.cc.

The port's copy of ``examples/simple_grpc_sequence_sync_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_grpc_sequence_sync_client``.
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
    values = [10, 20, 30]
    total = 0
    for idx, v in enumerate(values):
        data = np.array([v], dtype=np.int32)
        i0 = grpcclient.InferInput("INPUT", data.shape, "INT32")
        i0.set_data_from_numpy(data)
        result = client.infer(
            "accumulator", [i0], sequence_id=555,
            sequence_start=(idx == 0),
            sequence_end=(idx == len(values) - 1))
        total = int(result.as_numpy("OUTPUT")[0])
    if total != sum(values):
        sys.exit(f"error: expected {sum(values)}, got {total}")
    print(f"PASS: sequence sync (total {total})")
    client.close()


if __name__ == "__main__":
    main()
