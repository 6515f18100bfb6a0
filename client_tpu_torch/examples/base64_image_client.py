#!/usr/bin/env python
"""Callable classification helper around the image ensemble: feed a
base64-encoded image (the form detection pipelines hand around), get
back top-K classes. Importable — ``infer(b64_bytes)`` — or a CLI.

Parity: the fork-added ref:src/python/examples/base64_image_client.py
(:235 ``infer()``), which wraps image classification for device_hub-style
pipelines.

The port's copy of ``examples/base64_image_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.base64_image_client``.
"""

import argparse
import base64
import sys

import numpy as np

from client_tpu_torch.client import http as httpclient

DEFAULT_URL = "localhost:8000"
DEFAULT_MODEL = "preprocess_resnet50"


def infer(image_b64: bytes, url: str = DEFAULT_URL,
          model_name: str = DEFAULT_MODEL, topk: int = 3,
          client: "httpclient.InferenceServerClient | None" = None):
    """Classify one base64-encoded image; returns [(class_idx, score)].

    The ensemble's BYTES input receives the *decoded* image bytes; the
    server-side preprocess step handles format decode + resize.
    """
    owned = client is None
    if client is None:
        client = httpclient.InferenceServerClient(url)
    try:
        raw = base64.b64decode(image_b64)
        tensor = np.array([[raw]], dtype=object)  # [batch=1, 1]
        inp = httpclient.InferInput("raw_image", tensor.shape, "BYTES")
        inp.set_data_from_numpy(tensor)
        result = client.infer(model_name, [inp])
        logits = result.as_numpy("logits")[0]
        top = np.argsort(logits)[::-1][:topk]
        return [(int(i), float(logits[i])) for i in top]
    finally:
        if owned:
            client.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default=DEFAULT_URL)
    ap.add_argument("-m", "--model", default=DEFAULT_MODEL)
    ap.add_argument("-c", "--topk", type=int, default=3)
    ap.add_argument("image", help="image file (any format PIL decodes)")
    args = ap.parse_args(argv)

    with open(args.image, "rb") as f:
        image_b64 = base64.b64encode(f.read())
    try:
        results = infer(image_b64, args.url, args.model, args.topk)
    except Exception as e:  # noqa: BLE001
        sys.exit(f"error: {e}")
    for rank, (idx, score) in enumerate(results):
        print(f"rank {rank}: class {idx} score {score:.4f}")
    print("PASS: base64 classification")


if __name__ == "__main__":
    main()
