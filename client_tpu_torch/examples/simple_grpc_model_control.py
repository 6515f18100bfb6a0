#!/usr/bin/env python
"""Model lifecycle over gRPC: repository index, unload, readiness flip,
load.

Parity: ref:src/python/examples/simple_grpc_model_control.py.

The port's copy of ``examples/simple_grpc_model_control.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_grpc_model_control``.
"""

import argparse
import sys

from client_tpu_torch.client import grpc as grpcclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8001")
    ap.add_argument("-m", "--model", default="identity")
    args = ap.parse_args(argv)

    client = grpcclient.InferenceServerClient(args.url)
    model = args.model
    try:
        if not client.is_model_ready(model):
            sys.exit(f"error: {model} should start ready")
        index = client.get_model_repository_index(as_json=True)
        names = [m["name"] for m in index.get("models", [])]
        if model not in names:
            sys.exit(f"error: {model} missing from repository index")
        client.unload_model(model)
        if client.is_model_ready(model):
            sys.exit(f"error: {model} still ready after unload")
        client.load_model(model)
        if not client.is_model_ready(model):
            sys.exit(f"error: {model} not ready after load")
        print("PASS: grpc model control")
    finally:
        client.close()


if __name__ == "__main__":
    main()
