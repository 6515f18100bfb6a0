#!/usr/bin/env python
"""Typed-contents (InferTensorContents.int_contents) inference through the
raw protoc stubs, plus the mixed typed+raw error case.

Parity: ref:src/python/examples/grpc_explicit_int_content_client.py:28-140
against the add_sub example model (the reference's "simple").

The port's copy of ``examples/grpc_explicit_int_content_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.grpc_explicit_int_content_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.protocol import kserve_pb2 as pb


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-u", "--url", default="localhost:8001")
    ap.add_argument("-m", "--model", default="add_sub")
    args = ap.parse_args(argv)

    import grpc

    channel = grpc.insecure_channel(args.url)
    infer = channel.unary_unary(
        "/inference.GRPCInferenceService/ModelInfer",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=pb.ModelInferResponse.FromString)

    input0_data = list(range(16))
    input1_data = [1] * 16

    request = pb.ModelInferRequest()
    request.model_name = args.model

    input0 = request.inputs.add()
    input0.name = "INPUT0"
    input0.datatype = "INT32"
    input0.shape.extend([16])
    input0.contents.int_contents[:] = input0_data

    input1 = request.inputs.add()
    input1.name = "INPUT1"
    input1.datatype = "INT32"
    input1.shape.extend([16])
    input1.contents.int_contents[:] = input1_data

    request.outputs.add().name = "OUTPUT0"
    request.outputs.add().name = "OUTPUT1"

    response = infer(request)

    results = []
    for i, output in enumerate(response.outputs):
        arr = np.frombuffer(response.raw_output_contents[i], dtype=np.int32)
        results.append(np.resize(arr, list(output.shape)))
    if len(results) != 2:
        sys.exit("expected two output results")

    for i in range(16):
        s, d = int(results[0][i]), int(results[1][i])
        print(f"{input0_data[i]} + {input1_data[i]} = {s}")
        print(f"{input0_data[i]} - {input1_data[i]} = {d}")
        if input0_data[i] + input1_data[i] != s:
            sys.exit("sync infer error: incorrect sum")
        if input0_data[i] - input1_data[i] != d:
            sys.exit("sync infer error: incorrect difference")

    # Populating an additional raw content field must generate an error
    request.raw_input_contents.append(
        np.array(input0_data[0:8], np.int32).tobytes())
    request.inputs[0].contents.int_contents[:] = input0_data[8:]
    try:
        infer(request)
    except Exception as e:  # noqa: BLE001 — the error IS the test
        if ("contents field must not be specified when using "
                f"raw_input_contents for 'INPUT0' for model "
                f"'{args.model}'") in str(e):
            print("PASS: explicit int")
            return
        sys.exit(f"unexpected error: {e}")
    sys.exit("mixed typed+raw contents did not produce an error")


if __name__ == "__main__":
    main()
