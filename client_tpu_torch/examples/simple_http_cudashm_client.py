#!/usr/bin/env python
"""CUDA shared-memory inference over HTTP: the port's counterpart of
``examples/simple_http_tpushm_client.py``.

Both inputs of ``add_sub`` go into one CUDA shm region and both outputs
come back in a second one; the regions' raw handles are registered with
the server, and the request names the regions instead of carrying data.
A server in another process reads the region's staging buffer (one
host->device copy per set) and writes the outputs back into it; a server
in this process reads the device tensors with no copy.

    python -m client_tpu_torch.examples.simple_http_cudashm_client \
        -u localhost:8000 [--device cpu]
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.client import http as httpclient
from client_tpu_torch.utils import cuda_shared_memory as cudashm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8000")
    ap.add_argument("--device", default=None,
                    help="device of the regions (default the card)")
    args = ap.parse_args(argv)

    client = httpclient.InferenceServerClient(args.url)
    a = np.arange(16, dtype=np.int32)
    b = np.full(16, 9, dtype=np.int32)

    handle = cudashm.create_shared_memory_region("example_cudashm", 128, 0,
                                                 device=args.device)
    out_handle = cudashm.create_shared_memory_region(
        "example_cudashm_out", 128, 0, device=args.device)
    try:
        cudashm.set_shared_memory_region(handle, [a, b])
        client.register_cuda_shared_memory(
            "example_cudashm", cudashm.get_raw_handle(handle),
            handle.device_id, 128)
        client.register_cuda_shared_memory(
            "example_cudashm_out", cudashm.get_raw_handle(out_handle),
            out_handle.device_id, 128)

        i0 = httpclient.InferInput("INPUT0", a.shape, "INT32")
        i0.set_shared_memory("example_cudashm", 64, 0)
        i1 = httpclient.InferInput("INPUT1", b.shape, "INT32")
        i1.set_shared_memory("example_cudashm", 64, 64)
        o0 = httpclient.InferRequestedOutput("OUTPUT0")
        o0.set_shared_memory("example_cudashm_out", 64, 0)
        o1 = httpclient.InferRequestedOutput("OUTPUT1")
        o1.set_shared_memory("example_cudashm_out", 64, 64)

        client.infer("add_sub", [i0, i1], outputs=[o0, o1])
        out0 = cudashm.get_contents_as_numpy(out_handle, np.int32, (16,),
                                             offset=0)
        out1 = cudashm.get_contents_as_numpy(out_handle, np.int32, (16,),
                                             offset=64)
        if not np.array_equal(out0, a + b) or \
                not np.array_equal(out1, a - b):
            sys.exit("error: incorrect cuda-shm result")
        status = client.get_cuda_shared_memory_status()
        if not any(r.get("name") == "example_cudashm" for r in status):
            sys.exit("error: region missing from status")
        print("PASS: cuda shm infer")
    finally:
        client.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(handle)
        cudashm.destroy_shared_memory_region(out_handle)
        client.close()


if __name__ == "__main__":
    main()
