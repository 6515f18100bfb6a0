#!/usr/bin/env python
"""Health + metadata probes over gRPC (typed protos and as_json).

Parity: ref:src/c++/examples/simple_grpc_health_metadata.cc.

The port's copy of ``examples/simple_grpc_health_metadata.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_grpc_health_metadata``.
"""

import argparse
import sys

from client_tpu_torch.client import grpc as grpcclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8001")
    args = ap.parse_args(argv)

    client = grpcclient.InferenceServerClient(args.url)
    if not client.is_server_live():
        sys.exit("error: server not live")
    if not client.is_server_ready():
        sys.exit("error: server not ready")
    if not client.is_model_ready("add_sub"):
        sys.exit("error: add_sub not ready")

    meta = client.get_server_metadata(as_json=True)
    print(f"server: {meta['name']}")
    mmeta = client.get_model_metadata("add_sub")  # typed proto
    assert mmeta.name == "add_sub"
    stats = client.get_inference_statistics("add_sub", as_json=True)
    assert "model_stats" in stats
    print("PASS: grpc health/metadata")
    client.close()


if __name__ == "__main__":
    main()
