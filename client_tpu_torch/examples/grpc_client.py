#!/usr/bin/env python
"""Minimal raw-stub gRPC walk-through: health, metadata, configuration,
one inference — built directly on bare grpc + the protoc-generated
messages, no client library.

Parity: ref:src/python/examples/grpc_client.py:1-115 (which drives an
inception model with a dummy raw payload; here the dummy payload drives
the resnet50 example model).

The port's copy of ``examples/grpc_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.grpc_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.protocol import kserve_pb2 as pb


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-u", "--url", default="localhost:8001")
    ap.add_argument("-m", "--model", default="resnet50")
    args = ap.parse_args(argv)

    import grpc

    channel = grpc.insecure_channel(args.url)
    service = "/inference.GRPCInferenceService/"

    def unary(method, resp_cls):
        return channel.unary_unary(
            service + method,
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString)

    # Health
    live = unary("ServerLive", pb.ServerLiveResponse)(pb.ServerLiveRequest())
    print(f"server live: {live.live}")
    ready = unary("ServerReady", pb.ServerReadyResponse)(
        pb.ServerReadyRequest())
    print(f"server ready: {ready.ready}")
    model_ready = unary("ModelReady", pb.ModelReadyResponse)(
        pb.ModelReadyRequest(name=args.model))
    print(f"model ready: {model_ready.ready}")
    if not (live.live and ready.ready and model_ready.ready):
        sys.exit("error: server/model not ready")

    # Metadata
    server_md = unary("ServerMetadata", pb.ServerMetadataResponse)(
        pb.ServerMetadataRequest())
    print(f"server metadata:\n{server_md}")
    model_md = unary("ModelMetadata", pb.ModelMetadataResponse)(
        pb.ModelMetadataRequest(name=args.model))
    if args.verbose:
        print(f"model metadata:\n{model_md}")

    # Configuration
    config = unary("ModelConfig", pb.ModelConfigResponse)(
        pb.ModelConfigRequest(name=args.model))
    if args.verbose:
        print(f"model config:\n{config}")

    # Infer: one raw blob matching the first input's metadata
    request = pb.ModelInferRequest()
    request.model_name = args.model
    request.id = "my request id"
    spec = model_md.inputs[0]
    shape = [1 if d < 0 else int(d) for d in spec.shape]
    inp = request.inputs.add()
    inp.name = spec.name
    inp.datatype = spec.datatype
    inp.shape.extend(shape)
    out = request.outputs.add()
    out.name = model_md.outputs[0].name
    dtype = np.dtype(
        {"FP32": np.float32, "FP16": np.float16, "INT32": np.int32,
         "INT64": np.int64, "UINT8": np.uint8}[spec.datatype])
    request.raw_input_contents.append(
        np.zeros(shape, dtype=dtype).tobytes())

    response = unary("ModelInfer", pb.ModelInferResponse)(request)
    print(f"model infer: id={response.id} outputs="
          f"{[(o.name, list(o.shape)) for o in response.outputs]}")
    print("PASS")


if __name__ == "__main__":
    main()
