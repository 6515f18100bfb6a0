#!/usr/bin/env python
"""BYTES (string) tensors through system shared memory over HTTP.

Parity: ref:src/python/examples/simple_http_shm_string_client.py.

The port's copy of ``examples/simple_http_shm_string_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_http_shm_string_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.client import http as httpclient
from client_tpu_torch.protocol.binary import serialize_byte_tensor
from client_tpu_torch.utils import shared_memory as shm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8000")
    args = ap.parse_args(argv)

    client = httpclient.InferenceServerClient(args.url)
    a = np.array([str(i).encode() for i in range(16)], dtype=object)
    b = np.array([b"1"] * 16, dtype=object)
    a_bytes = len(serialize_byte_tensor(a))
    b_bytes = len(serialize_byte_tensor(b))
    out_size = 4 * 1024

    in_region = shm.create_shared_memory_region(
        "hstr_in", "/hstr_in_shm", a_bytes + b_bytes)
    out_region = shm.create_shared_memory_region(
        "hstr_out", "/hstr_out_shm", 2 * out_size)
    try:
        shm.set_shared_memory_region(in_region, [a, b])
        client.register_system_shared_memory("hstr_in", "/hstr_in_shm",
                                             a_bytes + b_bytes)
        client.register_system_shared_memory("hstr_out", "/hstr_out_shm",
                                             2 * out_size)

        i0 = httpclient.InferInput("INPUT0", a.shape, "BYTES")
        i0.set_shared_memory("hstr_in", a_bytes, 0)
        i1 = httpclient.InferInput("INPUT1", b.shape, "BYTES")
        i1.set_shared_memory("hstr_in", b_bytes, a_bytes)
        o0 = httpclient.InferRequestedOutput("OUTPUT0")
        o0.set_shared_memory("hstr_out", out_size, 0)
        o1 = httpclient.InferRequestedOutput("OUTPUT1")
        o1.set_shared_memory("hstr_out", out_size, out_size)

        client.infer("add_sub_string", [i0, i1], outputs=[o0, o1])
        out0 = shm.get_contents_as_numpy(out_region, np.object_, (16,),
                                         offset=0)
        out1 = shm.get_contents_as_numpy(out_region, np.object_, (16,),
                                         offset=out_size)
        want0 = [str(i + 1).encode() for i in range(16)]
        want1 = [str(i - 1).encode() for i in range(16)]
        if list(out0) != want0 or list(out1) != want1:
            sys.exit(f"error: string shm mismatch: {list(out0)[:4]}...")
        print("PASS: http string shm infer")
    finally:
        client.unregister_system_shared_memory()
        shm.destroy_shared_memory_region(in_region)
        shm.destroy_shared_memory_region(out_region)
        client.close()


if __name__ == "__main__":
    main()
