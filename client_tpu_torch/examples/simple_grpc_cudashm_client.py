#!/usr/bin/env python
"""CUDA shared-memory inference over gRPC: the port's counterpart of
``examples/simple_grpc_tpushm_client.py`` (needs grpcio).

Both inputs of ``add_sub`` go into one CUDA shm region; OUTPUT0 comes
back in a second region and OUTPUT1 in the response.

    python -m client_tpu_torch.examples.simple_grpc_cudashm_client \
        -u localhost:8001 [--device cpu]
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.client import grpc as grpcclient
from client_tpu_torch.utils import cuda_shared_memory as cudashm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8001")
    ap.add_argument("--device", default=None,
                    help="device of the regions (default the card)")
    args = ap.parse_args(argv)

    client = grpcclient.InferenceServerClient(args.url)
    a = np.arange(16, dtype=np.int32)
    b = np.full(16, 4, dtype=np.int32)

    handle = cudashm.create_shared_memory_region("g_cudashm", 128, 0,
                                                 device=args.device)
    out_handle = cudashm.create_shared_memory_region("g_cudashm_out", 128, 0,
                                                     device=args.device)
    try:
        cudashm.set_shared_memory_region(handle, [a, b])
        client.register_cuda_shared_memory(
            "g_cudashm", cudashm.get_raw_handle(handle), handle.device_id,
            128)
        client.register_cuda_shared_memory(
            "g_cudashm_out", cudashm.get_raw_handle(out_handle),
            out_handle.device_id, 128)

        i0 = grpcclient.InferInput("INPUT0", a.shape, "INT32")
        i0.set_shared_memory("g_cudashm", 64, 0)
        i1 = grpcclient.InferInput("INPUT1", b.shape, "INT32")
        i1.set_shared_memory("g_cudashm", 64, 64)
        o0 = grpcclient.InferRequestedOutput("OUTPUT0")
        o0.set_shared_memory("g_cudashm_out", 64, 0)

        result = client.infer("add_sub", [i0, i1], outputs=[
            o0, grpcclient.InferRequestedOutput("OUTPUT1")])
        out0 = cudashm.get_contents_as_numpy(out_handle, np.int32, (16,))
        if not np.array_equal(out0, a + b) or \
                not np.array_equal(result.as_numpy("OUTPUT1"), a - b):
            sys.exit("error: incorrect cuda-shm result")
        print("PASS: grpc cuda shm infer")
    finally:
        client.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(handle)
        cudashm.destroy_shared_memory_region(out_handle)
        client.close()


if __name__ == "__main__":
    main()
