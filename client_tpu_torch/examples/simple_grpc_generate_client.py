#!/usr/bin/env python
"""Decoupled streaming generation: send a prompt, receive one generated
token per stream response (the serving surface for autoregressive LM
decode — KV cache stays device-resident for the whole request).

Run the server with:
    python -m client_tpu_torch.server --grpc-port 8001 --lm-models

The port's copy of ``examples/simple_grpc_generate_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_grpc_generate_client``.
"""

import argparse
import queue
import sys

import numpy as np

from client_tpu_torch.client import grpc as tclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-u", "--url", default="localhost:8001")
    ap.add_argument("-m", "--model", default="generator_lm")
    ap.add_argument("-p", "--prompt", default="5,11,2",
                    help="comma-separated token ids")
    ap.add_argument("-n", "--max-tokens", type=int, default=8)
    ap.add_argument("-t", "--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples at this temperature")
    ap.add_argument("-k", "--top-k", type=int, default=0,
                    help="restrict sampling to the k best logits (0 = all)")
    ap.add_argument("-P", "--top-p", type=float, default=0.0,
                    help="nucleus sampling: smallest candidate prefix "
                         "with cumulative probability >= p (0 = off)")
    ap.add_argument("-s", "--seed", type=int, default=0,
                    help="sampling seed (same seed -> same stream)")
    args = ap.parse_args(argv)

    client = tclient.InferenceServerClient(args.url, verbose=args.verbose)
    prompt = [int(x) for x in args.prompt.split(",") if x.strip()]

    results: queue.Queue = queue.Queue()
    client.start_stream(lambda result, error: results.put((result, error)))

    x = tclient.InferInput("PROMPT", [len(prompt)], "INT32")
    x.set_data_from_numpy(np.array(prompt, np.int32))
    m = tclient.InferInput("MAX_TOKENS", [1], "INT32")
    m.set_data_from_numpy(np.array([args.max_tokens], np.int32))
    inputs = [x, m]
    if args.temperature > 0:
        for name, dtype, val in (("TEMPERATURE", "FP32",
                                  np.array([args.temperature], np.float32)),
                                 ("TOP_K", "INT32",
                                  np.array([args.top_k], np.int32)),
                                 ("TOP_P", "FP32",
                                  np.array([args.top_p], np.float32)),
                                 ("SEED", "INT32",
                                  np.array([args.seed], np.int32))):
            inp = tclient.InferInput(name, [1], dtype)
            inp.set_data_from_numpy(val)
            inputs.append(inp)
    client.async_stream_infer(args.model, inputs)

    tokens = []
    while True:
        result, error = results.get(timeout=120)
        if error is not None:
            sys.exit(f"error: {error}")
        resp = result.get_response(as_json=True) \
            if hasattr(result, "get_response") else {}
        if isinstance(resp, dict) and \
                resp.get("parameters", {}).get("triton_final_response"):
            break
        tok = int(result.as_numpy("TOKEN")[0])
        tokens.append(tok)
        print(f"token[{len(tokens) - 1}] = {tok}", flush=True)
    client.stop_stream()
    client.close()

    if not tokens:
        sys.exit("error: no tokens generated")
    print(f"generated {len(tokens)} tokens: {tokens}")
    print("PASS: generate")


if __name__ == "__main__":
    main()
