#!/usr/bin/env python
"""Image classification client: preprocess locally, infer, print top-K.

Parity: ref:src/c++/examples/image_client.cc and
ref:src/python/examples/image_client.py (scaling modes NONE/INCEPTION/VGG,
batching, classification extension, -i protocol switch, async mode).

The port's copy of ``examples/image_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.image_client``.
"""

import argparse
import sys

import numpy as np


def preprocess(path: str, scaling: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((224, 224))
    arr = np.asarray(img, np.float32)
    if scaling == "INCEPTION":
        arr = arr / 127.5 - 1.0
    elif scaling == "VGG":
        arr = arr[..., ::-1] - np.array([123.68, 116.78, 103.94],
                                        np.float32)
    return arr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default=None,
                    help="image file (synthetic if omitted)")
    ap.add_argument("-u", "--url", default=None)
    ap.add_argument("-i", "--protocol", choices=["http", "grpc"],
                    default="http")
    ap.add_argument("-m", "--model-name", default="resnet50")
    ap.add_argument("-s", "--scaling", default="INCEPTION",
                    choices=["NONE", "INCEPTION", "VGG"])
    ap.add_argument("-b", "--batch-size", type=int, default=1)
    ap.add_argument("-c", "--classes", type=int, default=0,
                    help="use the classification extension with top-K")
    ap.add_argument("-a", "--async-mode", action="store_true")
    args = ap.parse_args(argv)

    if args.protocol == "grpc":
        from client_tpu_torch.client import grpc as tclient

        url = args.url or "localhost:8001"
    else:
        from client_tpu_torch.client import http as tclient

        url = args.url or "localhost:8000"
    client = tclient.InferenceServerClient(url)

    if args.image:
        img = preprocess(args.image, args.scaling)
    else:
        img = np.random.default_rng(0).random((224, 224, 3)).astype(
            np.float32)
    batch = np.stack([img] * args.batch_size, axis=0)

    i0 = tclient.InferInput("image", batch.shape, "FP32")
    i0.set_data_from_numpy(batch)
    outputs = None
    if args.classes:
        o = tclient.InferRequestedOutput("logits",
                                         class_count=args.classes)
        outputs = [o]

    if args.async_mode and args.protocol == "http":
        result = client.async_infer(args.model_name, [i0],
                                    outputs=outputs).get_result()
    elif args.async_mode:  # grpc async is callback-based
        import threading

        done = threading.Event()
        holder = {}

        def cb(res, err):
            holder["res"], holder["err"] = res, err
            done.set()

        client.async_infer(args.model_name, [i0], cb, outputs=outputs)
        if not done.wait(timeout=120):
            sys.exit("error: async infer timed out")
        if holder["err"] is not None:
            sys.exit(f"error: {holder['err']}")
        result = holder["res"]
    else:
        result = client.infer(args.model_name, [i0], outputs=outputs)

    out = result.as_numpy("logits")
    if args.classes:
        for row in out.reshape(args.batch_size, -1):
            for item in row:
                s = item.decode() if isinstance(item, bytes) else str(item)
                print(f"    {s}")
    else:
        if out.shape != (args.batch_size, 1000):
            sys.exit(f"error: unexpected output shape {out.shape}")
        top = np.argmax(out, axis=-1)
        for i, cls in enumerate(top):
            print(f"image {i}: class {cls} "
                  f"(score {out[i, cls]:.3f})")
    print("PASS: image client")


if __name__ == "__main__":
    main()
