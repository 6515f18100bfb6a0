#!/usr/bin/env python
"""Ensemble client: send the raw encoded image; the server-side ensemble
(preprocess -> resnet50) does the rest.

Parity: ref:src/c++/examples/ensemble_image_client.cc.

The port's copy of ``examples/ensemble_image_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.ensemble_image_client``.
"""

import argparse
import io
import sys

import numpy as np

from client_tpu_torch.client import http as httpclient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default=None)
    ap.add_argument("-u", "--url", default="localhost:8000")
    ap.add_argument("-m", "--model-name", default="preprocess_resnet50")
    args = ap.parse_args(argv)

    if args.image:
        with open(args.image, "rb") as f:
            raw = f.read()
    else:
        from PIL import Image

        buf = io.BytesIO()
        Image.new("RGB", (64, 64), (0, 200, 100)).save(buf, format="PNG")
        raw = buf.getvalue()

    client = httpclient.InferenceServerClient(args.url)
    data = np.array([[raw]], dtype=np.object_)
    i0 = httpclient.InferInput("raw_image", [1, 1], "BYTES")
    i0.set_data_from_numpy(data)
    result = client.infer(args.model_name, [i0])
    logits = result.as_numpy("logits")
    if logits.shape != (1, 1000):
        sys.exit(f"error: unexpected shape {logits.shape}")
    print(f"top class: {int(np.argmax(logits))}")
    print("PASS: ensemble image client")


if __name__ == "__main__":
    main()
