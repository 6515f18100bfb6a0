#!/usr/bin/env python
"""Decoupled model: one request -> N streamed responses (repeat_int32).

Parity: ref:src/c++/examples/simple_grpc_custom_repeat.cc.

The port's copy of ``examples/simple_grpc_custom_repeat_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_grpc_custom_repeat_client``.
"""

import argparse
import queue
import sys

import numpy as np

from client_tpu_torch.client import grpc as grpcclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8001")
    ap.add_argument("-r", "--repeat-count", type=int, default=8)
    args = ap.parse_args(argv)

    client = grpcclient.InferenceServerClient(args.url)
    results: "queue.Queue" = queue.Queue()
    client.start_stream(lambda result, error: results.put((result, error)))
    try:
        data = np.arange(args.repeat_count, dtype=np.int32)
        i0 = grpcclient.InferInput("IN", data.shape, "INT32")
        i0.set_data_from_numpy(data)
        client.async_stream_infer("repeat_int32", [i0])

        received = []
        for _ in range(args.repeat_count):
            result, error = results.get(timeout=30)
            if error is not None:
                sys.exit(f"error: {error}")
            received.append(int(result.as_numpy("OUT")[0]))
        if received != list(range(args.repeat_count)):
            sys.exit(f"error: unexpected stream {received}")
    finally:
        client.stop_stream()
        client.close()
    print(f"PASS: decoupled repeat x{args.repeat_count}")


if __name__ == "__main__":
    main()
