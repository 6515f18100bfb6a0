#!/usr/bin/env python
"""BYTES typed-contents inference through the raw protoc stubs
(``bytes_contents`` carries one bytes value per element; BYTES outputs
come back length-prefixed in ``raw_output_contents``).

Parity: ref:src/python/examples/grpc_explicit_byte_content_client.py
against the add_sub_string example model (the reference's
"simple_string").

The port's copy of ``examples/grpc_explicit_byte_content_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.grpc_explicit_byte_content_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.protocol import kserve_pb2 as pb
from client_tpu_torch.utils import deserialize_bytes_tensor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-u", "--url", default="localhost:8001")
    ap.add_argument("-m", "--model", default="add_sub_string")
    args = ap.parse_args(argv)

    import grpc

    channel = grpc.insecure_channel(args.url)
    infer = channel.unary_unary(
        "/inference.GRPCInferenceService/ModelInfer",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=pb.ModelInferResponse.FromString)

    input0_data = [str(i).encode() for i in range(16)]
    input1_data = [b"1"] * 16

    request = pb.ModelInferRequest()
    request.model_name = args.model
    for name, data in (("INPUT0", input0_data), ("INPUT1", input1_data)):
        t = request.inputs.add()
        t.name = name
        t.datatype = "BYTES"
        t.shape.extend([16])
        t.contents.bytes_contents.extend(data)
    request.outputs.add().name = "OUTPUT0"
    request.outputs.add().name = "OUTPUT1"

    response = infer(request)

    results = []
    for i, output in enumerate(response.outputs):
        arr = deserialize_bytes_tensor(response.raw_output_contents[i])
        results.append(np.resize(arr, list(output.shape)))
    if len(results) != 2:
        sys.exit("expected two output results")

    for i in range(16):
        s, d = int(results[0][i]), int(results[1][i])
        print(f"{i} + 1 = {s}")
        print(f"{i} - 1 = {d}")
        if i + 1 != s:
            sys.exit("explicit string infer error: incorrect sum")
        if i - 1 != d:
            sys.exit("explicit string infer error: incorrect difference")
    print("PASS: explicit string")


if __name__ == "__main__":
    main()
