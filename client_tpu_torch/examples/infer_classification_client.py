#!/usr/bin/env python
"""Classification-extension verification script: runs a model twice —
once fetching the raw logits tensor, once through the v2 classification
extension (class_count=K) — and cross-checks that the server-side top-K
"<score>:<index>" labels agree with a client-side argsort of the logits.

Parity role: ref:src/python/examples/infer_classification_plan_model_script.py
(which debugs classification accuracy of a TensorRT plan engine by
comparing in-process TensorRT execution against the served result; a
TensorRT engine cannot exist here, so the equivalent check drives the
classification extension against the model's own raw output).

The port's copy of ``examples/infer_classification_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.infer_classification_client``.
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-u", "--url", default="localhost:8000")
    ap.add_argument("-m", "--model-name", default="resnet50")
    ap.add_argument("--input-name", default="image")
    ap.add_argument("--output-name", default="logits")
    ap.add_argument("-c", "--classes", type=int, default=5)
    ap.add_argument("-b", "--batch-size", type=int, default=2)
    args = ap.parse_args(argv)

    from client_tpu_torch.client import http as tclient

    client = tclient.InferenceServerClient(args.url)

    rng = np.random.default_rng(0)
    batch = rng.random((args.batch_size, 224, 224, 3)).astype(np.float32)
    i0 = tclient.InferInput(args.input_name, batch.shape, "FP32")
    i0.set_data_from_numpy(batch)

    # pass 1: raw logits
    raw = client.infer(args.model_name, [i0]).as_numpy(args.output_name)
    want = np.argsort(-raw, axis=-1)[:, :args.classes]

    # pass 2: server-side classification
    out = tclient.InferRequestedOutput(args.output_name,
                                       class_count=args.classes)
    got = client.infer(args.model_name, [i0],
                       outputs=[out]).as_numpy(args.output_name)
    got = got.reshape(args.batch_size, args.classes)

    for b in range(args.batch_size):
        for k in range(args.classes):
            item = got[b, k]
            s = item.decode() if isinstance(item, bytes) else str(item)
            score_str, idx_str = s.split(":")[:2]
            idx = int(idx_str)
            if args.verbose:
                print(f"batch {b} top-{k}: {s}")
            if idx != int(want[b, k]):
                sys.exit(f"classification mismatch at batch {b} rank {k}: "
                         f"server says {idx}, client argsort says "
                         f"{int(want[b, k])}")
            if abs(float(score_str) - float(raw[b, idx])) > 1e-3:
                sys.exit(f"classification score mismatch at batch {b} "
                         f"rank {k}: {score_str} vs {raw[b, idx]}")
    print("PASS: classification")


if __name__ == "__main__":
    main()
