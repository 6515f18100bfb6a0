#!/usr/bin/env python
"""INT8 typed-contents inference through the raw protoc stubs (int8
values travel in ``int_contents``; outputs come back as raw bytes).

Parity: ref:src/python/examples/grpc_explicit_int8_content_client.py
against an INT8 add_sub model (the reference's "simple_int8").

The port's copy of ``examples/grpc_explicit_int8_content_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.grpc_explicit_int8_content_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.protocol import kserve_pb2 as pb


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-u", "--url", default="localhost:8001")
    ap.add_argument("-m", "--model", default="add_sub_int8")
    args = ap.parse_args(argv)

    import grpc

    channel = grpc.insecure_channel(args.url)
    infer = channel.unary_unary(
        "/inference.GRPCInferenceService/ModelInfer",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=pb.ModelInferResponse.FromString)

    input0_data = [i % 16 for i in range(16)]
    input1_data = [1] * 16

    request = pb.ModelInferRequest()
    request.model_name = args.model
    for name, data in (("INPUT0", input0_data), ("INPUT1", input1_data)):
        t = request.inputs.add()
        t.name = name
        t.datatype = "INT8"
        t.shape.extend([16])
        t.contents.int_contents[:] = data
    request.outputs.add().name = "OUTPUT0"
    request.outputs.add().name = "OUTPUT1"

    response = infer(request)

    results = []
    for i, output in enumerate(response.outputs):
        arr = np.frombuffer(response.raw_output_contents[i], dtype=np.int8)
        results.append(np.resize(arr, list(output.shape)))
    if len(results) != 2:
        sys.exit("expected two output results")

    for i in range(16):
        s, d = int(results[0][i]), int(results[1][i])
        print(f"{input0_data[i]} + {input1_data[i]} = {s}")
        print(f"{input0_data[i]} - {input1_data[i]} = {d}")
        if input0_data[i] + input1_data[i] != s:
            sys.exit("explicit int8 infer error: incorrect sum")
        if input0_data[i] - input1_data[i] != d:
            sys.exit("explicit int8 infer error: incorrect difference")
    print("PASS: explicit int8")


if __name__ == "__main__":
    main()
