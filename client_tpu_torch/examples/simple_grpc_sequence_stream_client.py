#!/usr/bin/env python
"""Stateful sequences over a gRPC bidi stream: two interleaved sequences
accumulate values server-side.

Parity: ref:src/c++/examples/simple_grpc_sequence_stream_client.cc.

The port's copy of ``examples/simple_grpc_sequence_stream_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_grpc_sequence_stream_client``.
"""

import argparse
import queue
import sys

import numpy as np

from client_tpu_torch.client import grpc as grpcclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8001")
    args = ap.parse_args(argv)

    client = grpcclient.InferenceServerClient(args.url)
    results: "queue.Queue" = queue.Queue()
    client.start_stream(lambda result, error: results.put((result, error)))

    values = [1, 2, 3, 4, 5]
    try:
        for seq_id in (1001, 1002):
            for idx, v in enumerate(values):
                data = np.array([v if seq_id == 1001 else -v],
                                dtype=np.int32)
                i0 = grpcclient.InferInput("INPUT", data.shape, "INT32")
                i0.set_data_from_numpy(data)
                client.async_stream_infer(
                    "accumulator", [i0], request_id=f"{seq_id}_{idx}",
                    sequence_id=seq_id,
                    sequence_start=(idx == 0),
                    sequence_end=(idx == len(values) - 1))
        totals = {}
        for _ in range(2 * len(values)):
            result, error = results.get(timeout=30)
            if error is not None:
                sys.exit(f"error: {error}")
            out = result.as_numpy("OUTPUT")
            rid = result.get_response().id
            totals[rid] = int(out[0])
    finally:
        client.stop_stream()
        client.close()
    expected = sum(values)
    finals = sorted(totals.values())
    if finals[0] != -expected or finals[-1] != expected:
        # the running totals include intermediate sums; check extremes
        sys.exit(f"error: unexpected accumulator totals {finals}")
    print("PASS: sequence stream (totals "
          f"{finals[0]} and {finals[-1]})")


if __name__ == "__main__":
    main()
