#!/usr/bin/env python
"""Image classification over gRPC using the RAW protoc-generated stubs —
no client library: builds ModelInferRequest protos directly and calls
the service through a bare grpc channel, the way third-party generated
clients do.

Parity: ref:src/python/examples/grpc_image_client.py:1-420 (raw-stub
variant of image_client).

The port's copy of ``examples/grpc_image_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.grpc_image_client``.
"""

import argparse
import struct
import sys

import numpy as np

from client_tpu_torch.protocol import kserve_pb2 as pb


def preprocess(path: str, scaling: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((224, 224))
    x = np.asarray(img, np.float32)
    if scaling == "INCEPTION":
        x = x / 127.5 - 1.0
    elif scaling == "VGG":
        x = x - np.array([123.68, 116.779, 103.939], np.float32)
    return x


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8001")
    ap.add_argument("-m", "--model", default="resnet50")
    ap.add_argument("-b", "--batch", type=int, default=1)
    ap.add_argument("-c", "--topk", type=int, default=3)
    ap.add_argument("-s", "--scaling", default="INCEPTION",
                    choices=["NONE", "VGG", "INCEPTION"])
    ap.add_argument("image")
    args = ap.parse_args(argv)

    import grpc

    channel = grpc.insecure_channel(args.url)
    service = "/inference.GRPCInferenceService/"

    def unary(method, resp_cls):
        return channel.unary_unary(
            service + method,
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString)

    live = unary("ServerLive", pb.ServerLiveResponse)(
        pb.ServerLiveRequest())
    if not live.live:
        sys.exit("error: server is not live")
    metadata = unary("ModelMetadata", pb.ModelMetadataResponse)(
        pb.ModelMetadataRequest(name=args.model))
    input_name = metadata.inputs[0].name
    output_name = metadata.outputs[0].name

    x = preprocess(args.image, args.scaling)
    batched = np.stack([x] * args.batch, axis=0)

    request = pb.ModelInferRequest(model_name=args.model)
    tin = request.inputs.add()
    tin.name = input_name
    tin.datatype = "FP32"
    tin.shape.extend(batched.shape)
    request.raw_input_contents.append(batched.tobytes())

    response = unary("ModelInfer", pb.ModelInferResponse)(request)
    raw = response.raw_output_contents[0]
    shape = [int(d) for d in response.outputs[0].shape]
    logits = np.frombuffer(raw, np.float32).reshape(shape)
    for b in range(args.batch):
        top = np.argsort(logits[b])[::-1][: args.topk]
        for rank, idx in enumerate(top):
            print(f"image {b} rank {rank}: class {idx} "
                  f"score {logits[b][idx]:.4f} ({output_name})")
    print("PASS: raw-stub classification")


if __name__ == "__main__":
    main()
