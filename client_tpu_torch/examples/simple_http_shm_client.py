#!/usr/bin/env python
"""System shared-memory inference over HTTP: inputs and outputs both ride
a POSIX shm region.

Parity: ref:src/c++/examples/simple_http_shm_client.cc and
ref:src/python/examples/simple_http_shm_client.py.

The port's copy of ``examples/simple_http_shm_client.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.simple_http_shm_client``.
"""

import argparse
import sys

import numpy as np

from client_tpu_torch.client import http as httpclient
from client_tpu_torch.utils import shared_memory as shm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8000")
    args = ap.parse_args(argv)

    client = httpclient.InferenceServerClient(args.url)
    a = np.arange(16, dtype=np.int32)
    b = np.full(16, 7, dtype=np.int32)

    region = shm.create_shared_memory_region("example_shm", "/example_shm",
                                             256)
    try:
        shm.set_shared_memory_region(region, [a, b])
        client.register_system_shared_memory("example_shm", "/example_shm",
                                             256)
        i0 = httpclient.InferInput("INPUT0", a.shape, "INT32")
        i0.set_shared_memory("example_shm", 64, 0)
        i1 = httpclient.InferInput("INPUT1", b.shape, "INT32")
        i1.set_shared_memory("example_shm", 64, 64)
        o0 = httpclient.InferRequestedOutput("OUTPUT0")
        o0.set_shared_memory("example_shm", 64, 128)
        o1 = httpclient.InferRequestedOutput("OUTPUT1")
        o1.set_shared_memory("example_shm", 64, 192)

        client.infer("add_sub", [i0, i1], outputs=[o0, o1])
        out0 = shm.get_contents_as_numpy(region, np.int32, (16,),
                                         offset=128)
        out1 = shm.get_contents_as_numpy(region, np.int32, (16,),
                                         offset=192)
        if not np.array_equal(out0, a + b) or \
                not np.array_equal(out1, a - b):
            sys.exit("error: incorrect shm result")
        status = client.get_system_shared_memory_status()
        if not any(r.get("name") == "example_shm" for r in status):
            sys.exit("error: region missing from status")
        print("PASS: system shm infer")
    finally:
        client.unregister_system_shared_memory("example_shm")
        shm.destroy_shared_memory_region(region)


if __name__ == "__main__":
    main()
