#!/usr/bin/env python
"""Stateful-sequence inference over HTTP: two interleaved correlation
ids accumulate independent running sums server-side.

Parity: ref:src/c++/examples/simple_http_sequence_sync_client.cc (the
HTTP half of the sequence pair).

The port's copy of ``examples/simple_http_sequence_sync_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_http_sequence_sync_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.client import http as httpclient


def send_step(client, seq_id, value, start, end):
    inp = httpclient.InferInput("INPUT", (1,), "INT32")
    inp.set_data_from_numpy(np.array([value], dtype=np.int32))
    result = client.infer("accumulator", [inp], sequence_id=seq_id,
                          sequence_start=start, sequence_end=end)
    return int(result.as_numpy("OUTPUT")[0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8000")
    args = ap.parse_args(argv)

    client = httpclient.InferenceServerClient(args.url)
    values = [1, 2, 3, 4, 5]
    seq_a, seq_b = 2001, 2002
    sum_a = sum_b = 0
    for i, v in enumerate(values):
        start, end = i == 0, i == len(values) - 1
        got_a = send_step(client, seq_a, v, start, end)
        got_b = send_step(client, seq_b, 10 * v, start, end)
        sum_a += v
        sum_b += 10 * v
        print(f"step {i}: seqA={got_a} (want {sum_a}), "
              f"seqB={got_b} (want {sum_b})")
        if got_a != sum_a or got_b != sum_b:
            sys.exit("error: sequence state mixed up")
    print("PASS: http sequence sync")


if __name__ == "__main__":
    main()
