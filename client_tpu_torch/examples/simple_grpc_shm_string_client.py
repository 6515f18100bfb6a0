#!/usr/bin/env python
"""BYTES (string) tensors through system shared memory over gRPC: the
length-prefixed serialization is written into the region by the client
and parsed back out of the output region.

Parity: ref:src/python/examples/simple_grpc_shm_string_client.py:1-201.

The port's copy of ``examples/simple_grpc_shm_string_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_grpc_shm_string_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.client import grpc as grpcclient
from client_tpu_torch.protocol.binary import serialize_byte_tensor
from client_tpu_torch.utils import shared_memory as shm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8001")
    args = ap.parse_args(argv)

    client = grpcclient.InferenceServerClient(args.url)
    a = np.array([str(i).encode() for i in range(16)], dtype=object)
    b = np.array([b"1"] * 16, dtype=object)
    a_bytes = len(serialize_byte_tensor(a))
    b_bytes = len(serialize_byte_tensor(b))
    out_size = 4 * 1024  # generous: string outputs vary in size

    in_region = shm.create_shared_memory_region(
        "str_in", "/str_in_shm", a_bytes + b_bytes)
    out_region = shm.create_shared_memory_region(
        "str_out", "/str_out_shm", 2 * out_size)
    try:
        shm.set_shared_memory_region(in_region, [a, b])
        client.register_system_shared_memory("str_in", "/str_in_shm",
                                             a_bytes + b_bytes)
        client.register_system_shared_memory("str_out", "/str_out_shm",
                                             2 * out_size)

        i0 = grpcclient.InferInput("INPUT0", a.shape, "BYTES")
        i0.set_shared_memory("str_in", a_bytes, 0)
        i1 = grpcclient.InferInput("INPUT1", b.shape, "BYTES")
        i1.set_shared_memory("str_in", b_bytes, a_bytes)
        o0 = grpcclient.InferRequestedOutput("OUTPUT0")
        o0.set_shared_memory("str_out", out_size, 0)
        o1 = grpcclient.InferRequestedOutput("OUTPUT1")
        o1.set_shared_memory("str_out", out_size, out_size)

        result = client.infer("add_sub_string", [i0, i1],
                              outputs=[o0, o1])
        # output sizes ride the response parameters; parse from the region
        out0 = shm.get_contents_as_numpy(out_region, np.object_, (16,),
                                         offset=0)
        out1 = shm.get_contents_as_numpy(out_region, np.object_, (16,),
                                         offset=out_size)
        want0 = [str(i + 1).encode() for i in range(16)]
        want1 = [str(i - 1).encode() for i in range(16)]
        if list(out0) != want0 or list(out1) != want1:
            sys.exit(f"error: string shm mismatch: {list(out0)[:4]}...")
        print("PASS: grpc string shm infer")
    finally:
        client.unregister_system_shared_memory()
        shm.destroy_shared_memory_region(in_region)
        shm.destroy_shared_memory_region(out_region)
        client.close()


if __name__ == "__main__":
    main()
