"""Launch a serving process: ``python -m client_tpu_torch.server [options]``.

Serves the demo models (add_sub / add_sub_fp32 / identity), and with
``--lm-models`` the continuous-batching generator ``continuous_lm``, over
HTTP and, with ``--grpc-port``, gRPC; on the card, or on the CPU with
``--device cpu``. ``--debug-endpoints`` serves the ``/v2/debug/*`` routes
(and the gRPC incidents trailer); without it they answer 404. Faults are
armed through ``POST /v2/debug/faults`` or, at start, the
``CLIENT_TPU_FAULTS`` / ``CLIENT_TPU_FAULT_SEED`` environment.
"""

from __future__ import annotations

import argparse
import signal
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("client_tpu_torch.server")
    ap.add_argument("--http-port", type=int, default=8000)
    ap.add_argument("--grpc-port", type=int, default=None,
                    help="also serve gRPC on this port")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    ap.add_argument("--demo-models", action="store_true",
                    help="register the add_sub/add_sub_fp32/identity demo "
                         "models (also the default when nothing else is "
                         "asked for)")
    ap.add_argument("--lm-models", action="store_true",
                    help="also register continuous_lm (decoupled streaming "
                         "generation through the continuous-batching "
                         "engine, on --device); the reference's decoder_lm "
                         "and generator_lm are not ported yet (ROADMAP A12, "
                         "A14)")
    ap.add_argument("--debug-endpoints", action="store_true",
                    help="serve the runtime introspection surface "
                         "(GET /v2/debug/runtime, GET /v2/debug/models/"
                         "{name}/engine, GET /v2/debug/incidents, "
                         "GET/POST /v2/debug/faults, POST "
                         "/v2/debug/profile, ...); off by default — those "
                         "paths 404 without the flag")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from client_tpu_torch.models import make_add_sub, make_identity
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer

    core = TorchInferenceServer()
    core.register_model(make_add_sub("add_sub", 16, "INT32",
                                     device=args.device))
    core.register_model(make_add_sub("add_sub_fp32", 16, "FP32",
                                     device=args.device))
    core.register_model(make_identity("identity", 16, "INT32",
                                      device=args.device))
    if args.lm_models:
        from client_tpu_torch.models.decoder_lm import (
            make_continuous_generator,
        )

        core.register_model(make_continuous_generator(device=args.device))

    http_srv = HttpInferenceServer(core, host=args.host, port=args.http_port,
                                   verbose=args.verbose,
                                   debug_endpoints=args.debug_endpoints
                                   ).start()
    print(f"HTTP server listening on {http_srv.url}", flush=True)

    grpc_srv = None
    if args.grpc_port is not None:
        from client_tpu_torch.server.grpc_server import GrpcInferenceServer

        grpc_srv = GrpcInferenceServer(
            core, host=args.host, port=args.grpc_port,
            debug_endpoints=args.debug_endpoints).start()
        print(f"gRPC server listening on {grpc_srv.address}", flush=True)

    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    try:
        while not stop:
            signal.pause()
    finally:
        http_srv.stop()
        if grpc_srv:
            grpc_srv.stop()
        core.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
