#!/usr/bin/env python
"""Health + metadata + statistics probes over HTTP.

Parity: ref:src/c++/examples/simple_http_health_metadata.cc.

The port's copy of ``examples/simple_http_health_metadata.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_http_health_metadata``.
"""

import argparse
import sys

from client_tpu_torch.client import http as httpclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8000")
    args = ap.parse_args(argv)

    client = httpclient.InferenceServerClient(args.url)
    if not client.is_server_live():
        sys.exit("error: server not live")
    if not client.is_server_ready():
        sys.exit("error: server not ready")
    if not client.is_model_ready("add_sub"):
        sys.exit("error: add_sub not ready")

    meta = client.get_server_metadata()
    print(f"server: {meta['name']} {meta.get('version', '')}")
    print(f"extensions: {', '.join(meta.get('extensions', []))}")
    mmeta = client.get_model_metadata("add_sub")
    print(f"model inputs: {[t['name'] for t in mmeta['inputs']]}")
    config = client.get_model_config("add_sub")
    assert config["name"] == "add_sub"
    index = client.get_model_repository_index()
    assert any(m["name"] == "add_sub" for m in index)
    stats = client.get_inference_statistics("add_sub")
    assert "model_stats" in stats
    print("PASS: health/metadata")


if __name__ == "__main__":
    main()
