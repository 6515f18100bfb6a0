#!/usr/bin/env python
"""Model lifecycle: unload -> verify -> load -> verify, over HTTP.

Parity: ref:src/c++/examples/simple_http_model_control.cc.

The port's copy of ``examples/simple_http_model_control.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_http_model_control``.
"""

import argparse
import sys

from client_tpu_torch.client import http as httpclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8000")
    ap.add_argument("-m", "--model", default="identity")
    args = ap.parse_args(argv)

    client = httpclient.InferenceServerClient(args.url)
    if not client.is_model_ready(args.model):
        sys.exit(f"error: {args.model} should start ready")
    client.unload_model(args.model)
    if client.is_model_ready(args.model):
        sys.exit("error: model still ready after unload")
    client.load_model(args.model)
    if not client.is_model_ready(args.model):
        sys.exit("error: model not ready after load")
    print("PASS: model control")


if __name__ == "__main__":
    main()
