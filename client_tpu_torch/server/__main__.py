"""Launch a serving process: ``python -m client_tpu_torch.server [options]``.

Serves the reference's demo models (add_sub, add_sub_fp32, identity,
add_sub_string, repeat_int32, accumulator) unless only a model
repository is asked for, the models of ``--model-repository``
(``<repo>/<name>/model.py`` with ``create_model()``, loaded through the
repository extension), with ``--image-models`` preprocess, resnet50 and
their ensemble preprocess_resnet50, and with ``--lm-models`` the
sequence decoder ``decoder_lm`` and the continuous-batching generator
``continuous_lm``; over HTTP and, with ``--grpc-port``, gRPC; on the
card, or on the CPU with ``--device cpu``. ``--debug-endpoints`` serves
the ``/v2/debug/*`` routes (and the gRPC incidents trailer); without it
they answer 404. Faults are armed through ``POST /v2/debug/faults`` or,
at start, the ``CLIENT_TPU_FAULTS`` / ``CLIENT_TPU_FAULT_SEED``
environment.
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
    ap.add_argument("--model-repository", default=None,
                    help="a directory of <name>/model.py entries (each "
                         "with create_model()), loaded through the "
                         "repository extension")
    ap.add_argument("--demo-models", action="store_true",
                    help="register the add_sub/add_sub_fp32/identity/"
                         "add_sub_string/repeat_int32/accumulator demo "
                         "models (also the default without "
                         "--model-repository)")
    ap.add_argument("--image-models", action="store_true",
                    help="also register preprocess/resnet50 (bf16, on "
                         "--device)/preprocess_resnet50 (the ensemble)")
    ap.add_argument("--lm-models", action="store_true",
                    help="also register decoder_lm (sequence decode), "
                         "generator_lm (decoupled single-stream "
                         "generation) and continuous_lm (decoupled "
                         "streaming generation through the "
                         "continuous-batching engine), on --device")
    ap.add_argument("--debug-endpoints", action="store_true",
                    help="serve the runtime introspection surface "
                         "(GET /v2/debug/runtime, GET /v2/debug/models/"
                         "{name}/engine, GET /v2/debug/incidents, "
                         "GET/POST /v2/debug/faults, POST "
                         "/v2/debug/profile, ...); off by default — those "
                         "paths 404 without the flag")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer

    core = TorchInferenceServer(model_repository=args.model_repository)
    if args.demo_models or not args.model_repository:
        from client_tpu_torch.models import (
            make_accumulator,
            make_add_sub,
            make_add_sub_string,
            make_identity,
            make_repeat,
        )

        core.register_model(make_add_sub("add_sub", 16, "INT32",
                                         device=args.device))
        core.register_model(make_add_sub("add_sub_fp32", 16, "FP32",
                                         device=args.device))
        core.register_model(make_identity("identity", 16, "INT32",
                                          device=args.device))
        core.register_model(make_add_sub_string("add_sub_string", 16))
        core.register_model(make_repeat("repeat_int32"))
        core.register_model(make_accumulator("accumulator", 1, "INT32",
                                             device=args.device))
    if args.image_models:
        from client_tpu_torch.models import (
            make_image_ensemble,
            make_preprocess,
            make_resnet50,
        )

        core.register_model(make_preprocess())
        core.register_model(make_resnet50(device=args.device))
        core.register_model(make_image_ensemble())
    if args.lm_models:
        from client_tpu_torch.models import (
            make_continuous_generator,
            make_decoder_lm,
            make_generator,
        )

        core.register_model(make_decoder_lm(device=args.device))
        core.register_model(make_generator(device=args.device))
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
