"""perf CLI — the port's copy of ``client_tpu/perf/__main__.py``, with the
reference perf_analyzer's flags.

Usage examples:
    python -m client_tpu_torch.perf -m add_sub -u localhost:8000
    python -m client_tpu_torch.perf -m add_sub -i grpc -u localhost:8001 \
        --concurrency-range 1:16:2 -f out.csv
    python -m client_tpu_torch.perf -m bert_base -u localhost:8000 \
        --shared-memory cuda --concurrency-range 8
    python -m client_tpu_torch.perf -m add_sub --request-rate-range \
        100:500:100 --request-distribution poisson --shared-memory system

``--service-kind`` is ``cuda_serve`` (a network client, the default) or
``cuda_direct`` (an in-process server, given as ``main(server=...)``);
``--shared-memory cuda`` puts the regions on the card (``--device cpu``
asks for the CPU). Loading a model repository in process and the foreign
services (``tfserve``, ``torchserve``) are not ported yet: they name
their ROADMAP items.
"""

from __future__ import annotations

import argparse
import sys


def _parse_range(spec: str, cast=int, default_step=1):
    parts = spec.split(":")
    start = cast(parts[0])
    end = cast(parts[1]) if len(parts) > 1 else start
    step = cast(parts[2]) if len(parts) > 2 else cast(default_step)
    return start, end, step


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m client_tpu_torch.perf",
        description="perf analyzer of the PyTorch/CUDA port (the "
                    "reference perf_analyzer's flags)")
    p.add_argument("-m", "--model-name", required=True)
    p.add_argument("-x", "--model-version", default="")
    p.add_argument("-b", "--batch-size", type=int, default=1)
    p.add_argument("-u", "--url", default="localhost:8000")
    p.add_argument("-i", "--protocol", choices=["http", "grpc"],
                   default="http")
    p.add_argument("--service-kind",
                   choices=["cuda_serve", "cuda_direct", "tfserve",
                            "torchserve"],
                   default="cuda_serve",
                   help="cuda_serve = network client; cuda_direct = "
                        "in-process server, no RPC; tfserve / "
                        "torchserve = foreign services (not ported yet)")
    p.add_argument("--model-repository", default=None,
                   help="model repository for --service-kind=cuda_direct "
                        "(not ported yet)")
    p.add_argument("--retries", type=int, default=0,
                   help="opt-in client RetryPolicy: total attempts per "
                        "non-streaming infer (0/1 = fail fast). Retries "
                        "502/503/UNAVAILABLE with exponential backoff + "
                        "full jitter, honoring server Retry-After; the "
                        "report splits retried from rejected counts")
    p.add_argument("--retry-backoff", type=float, default=0.1,
                   help="base backoff seconds for --retries (doubles "
                        "per attempt, capped at 5s)")
    p.add_argument("-H", "--http-header", action="append", default=[],
                   metavar="NAME:VALUE",
                   help="extra request header (HTTP) / metadata pair "
                        "(gRPC); repeatable")
    p.add_argument("-v", "--verbose", action="store_true")

    mode = p.add_argument_group("load generation")
    mode.add_argument("--async", dest="async_mode", action="store_true",
                      default=True)
    mode.add_argument("--sync", dest="async_mode", action="store_false")
    mode.add_argument("--streaming", action="store_true",
                      help="gRPC bidi streaming (requires -i grpc)")
    mode.add_argument("--concurrency-range", default="1",
                      help="start:end:step (closed loop)")
    mode.add_argument("--request-rate-range", default=None,
                      help="start:end:step in infer/sec (open loop)")
    mode.add_argument("--request-distribution",
                      choices=["constant", "poisson"], default="constant")
    mode.add_argument("--request-intervals", default=None,
                      help="file of inter-request intervals (ns)")
    mode.add_argument("--num-threads", type=int, default=16)

    meas = p.add_argument_group("measurement")
    meas.add_argument("--measurement-mode",
                      choices=["time_windows", "count_windows"],
                      default="time_windows")
    meas.add_argument("-p", "--measurement-interval", type=int,
                      default=5000, help="window ms")
    meas.add_argument("--measurement-request-count", type=int, default=50)
    meas.add_argument("-s", "--stability-percentage", type=float,
                      default=10.0)
    meas.add_argument("-r", "--max-trials", type=int, default=10)
    meas.add_argument("--percentile", type=int, default=None,
                      help="use this percentile for stability instead of "
                           "average")
    meas.add_argument("-l", "--latency-threshold", type=int, default=0,
                      help="usec; stop search when exceeded")
    meas.add_argument("--retire-share-ceiling", type=float, default=20.0,
                      help="fail a window when the generation engine's "
                           "retire-phase share exceeds this percentage "
                           "while fetches are unamortized (0 disables)")
    meas.add_argument("--prefill-share-ceiling", type=float, default=0.0,
                      help="fail a window when the generation engine's "
                           "chunked-prefill lane share exceeds this "
                           "percentage while requests queue for a slot "
                           "(0 disables, the default)")
    meas.add_argument("--min-goodput", type=float, default=0.0,
                      help="fail a window when the engine's useful-FLOP "
                           "share (useful / (useful + wasted), window "
                           "deltas) drops below this percentage while "
                           "slot occupancy is >= 50%% (0 disables, the "
                           "default)")
    meas.add_argument("--allow-window-compiles", action="store_true",
                      help="do not fail windows that saw serving-phase "
                           "XLA compiles (default: a post-warmup "
                           "compile fails the window)")
    meas.add_argument("--fail-on-incident", action="store_true",
                      help="fail a window during which the server's "
                           "watchdog fired any incident (default off — "
                           "chaos runs inject faults on purpose)")
    meas.add_argument("--binary-search", action="store_true")
    meas.add_argument("--search-mode", choices=["linear", "binary", "none"],
                      default=None)

    data = p.add_argument_group("input data")
    data.add_argument("--input-data", default="random",
                      help="random | zero | shared_prefix | <json file> "
                           "| <directory>")
    data.add_argument("--string-data", default=None)
    data.add_argument("--string-length", type=int, default=128)
    data.add_argument("--shape", action="append", default=[],
                      help="name:d1,d2,... override for dynamic dims")
    data.add_argument("--shared-prefix-length", type=int, default=256,
                      help="common token-prefix length for --input-data "
                           "shared_prefix (the prefix-cache workload)")
    data.add_argument("--shared-prefix-suffix-length", type=int,
                      default=32,
                      help="per-stream random suffix length for "
                           "--input-data shared_prefix")
    data.add_argument("--shared-prefix-streams", type=int, default=16,
                      help="distinct prompt streams for --input-data "
                           "shared_prefix (requests rotate across them)")
    data.add_argument("--shared-prefix-vocab", type=int, default=1024,
                      help="token-id range for --input-data shared_prefix")
    data.add_argument("--shared-prefix-max-tokens", type=int, default=32,
                      help="generation budget (MAX_TOKENS) per request "
                           "for --input-data shared_prefix")

    shm = p.add_argument_group("shared memory")
    shm.add_argument("--shared-memory", choices=["none", "system", "cuda"],
                     default="none")
    shm.add_argument("--device", default=None,
                     help="device of the --shared-memory cuda regions "
                          "(default the card; cpu only when asked)")
    shm.add_argument("--output-shared-memory-size", type=int,
                     default=100 * 1024)

    seq = p.add_argument_group("sequences")
    seq.add_argument("--sequence-length", type=int, default=20)
    seq.add_argument("--num-of-sequences", type=int, default=4)
    seq.add_argument("--sequence-id-range", default=None,
                     help="start:end")

    out = p.add_argument_group("output")
    out.add_argument("-f", "--csv-file", default=None)
    return p


def main(argv=None, server=None) -> int:
    args = build_arg_parser().parse_args(argv)

    from client_tpu_torch.perf.client_backend import (
        UNPORTED_KIND, BackendKind, ClientBackendFactory)
    from client_tpu_torch.perf.concurrency_manager import ConcurrencyManager
    from client_tpu_torch.perf.data_loader import DataLoader
    from client_tpu_torch.perf.inference_profiler import InferenceProfiler
    from client_tpu_torch.perf.model_parser import ModelParser
    from client_tpu_torch.perf.report import render_report, write_csv
    from client_tpu_torch.perf.request_rate_manager import (
        CustomLoadManager, RequestRateManager)

    # flag-combination checks, as the reference perf_analyzer's
    if args.streaming and (args.protocol != "grpc"
                           or args.service_kind == "cuda_direct"):
        print("error: --streaming requires -i grpc", file=sys.stderr)
        return 2
    if args.service_kind == "cuda_direct" and server is None:
        if not args.model_repository:
            print("error: --service-kind cuda_direct requires "
                  "--model-repository", file=sys.stderr)
            return 2
        raise NotImplementedError(
            "--service-kind cuda_direct with --model-repository: loading "
            "a model repository in process is not ported yet (ROADMAP "
            "queue A, item 6: the serving core's repository); pass "
            "main(server=...)")
    if args.service_kind in ("tfserve", "torchserve"):
        print(f"error: --service-kind {args.service_kind}: "
              + UNPORTED_KIND.format(kind=args.service_kind),
              file=sys.stderr)
        return 2

    if args.service_kind == "cuda_direct":
        kind = BackendKind.INPROCESS
    else:
        kind = BackendKind(args.protocol)
    headers = {}
    for spec in args.http_header:
        name, sep, value = spec.partition(":")
        if not sep or not name.strip():
            print(f"error: -H expects NAME:VALUE, got {spec!r}",
                  file=sys.stderr)
            return 2
        if name.strip() in headers:
            # a dict would silently keep only the last value; refuse
            # rather than send different wire traffic than asked for
            print(f"error: duplicate -H header {name.strip()!r}",
                  file=sys.stderr)
            return 2
        headers[name.strip()] = value.strip()
    if headers and args.service_kind == "cuda_direct":
        print(f"error: -H is not supported by --service-kind "
              f"{args.service_kind}", file=sys.stderr)
        return 2
    retry_policy = None
    if args.retries > 1:
        if kind not in (BackendKind.HTTP, BackendKind.GRPC):
            print("error: --retries requires -i http or -i grpc",
                  file=sys.stderr)
            return 2
        from client_tpu_torch.client.retry import RetryPolicy

        retry_policy = RetryPolicy(max_attempts=args.retries,
                                   backoff_s=args.retry_backoff)
    factory = ClientBackendFactory(
        kind, url=args.url, verbose=args.verbose, server=server,
        headers=headers or None,
        retry_policy=retry_policy)
    backend = factory.create()

    parser = ModelParser()
    parser.init(backend, args.model_name, args.model_version,
                args.batch_size)
    # --shape overrides for dynamic dims
    for spec in args.shape:
        name, _, dims = spec.partition(":")
        if name in parser.inputs:
            parser.inputs[name].dims = [int(d) for d in dims.split(",")]
    loader = DataLoader(args.batch_size)
    if args.input_data == "shared_prefix":
        # the shared-prefix generator sets explicit per-stream shapes
        # for the dynamic token input, so the dynamic-dim guard below
        # does not apply to the inputs it populated
        try:
            loader.generate_shared_prefix_data(
                parser.inputs, prefix_len=args.shared_prefix_length,
                suffix_len=args.shared_prefix_suffix_length,
                n_streams=args.shared_prefix_streams,
                vocab=args.shared_prefix_vocab,
                max_tokens=args.shared_prefix_max_tokens)
        except ValueError as e:
            print(f"error: --input-data shared_prefix: {e}",
                  file=sys.stderr)
            return 2
    for info in parser.inputs.values():
        if not info.is_dynamic():
            continue
        if args.input_data == "shared_prefix" \
                and loader.get_input_shape(info.name) is not None:
            continue
        print(f"error: input '{info.name}' has dynamic shape "
              f"{info.dims}; use --shape {info.name}:<dims>",
              file=sys.stderr)
        return 2

    import os

    if args.input_data == "shared_prefix":
        pass  # populated above, ahead of the dynamic-dim guard
    elif args.input_data == "zero":
        loader.generate_data(parser.inputs, zero_data=True)
    elif args.input_data == "random":
        loader.generate_data(parser.inputs, string_data=args.string_data,
                             string_length=args.string_length)
    elif os.path.isdir(args.input_data):
        loader.read_data_from_dir(args.input_data, parser.inputs)
    else:
        loader.read_data_from_json(args.input_data, parser.inputs,
                                   parser.outputs)

    seq_range = None
    if args.sequence_id_range:
        a, b = args.sequence_id_range.split(":")
        seq_range = (int(a), int(b))

    common = dict(
        factory=factory, parser=parser, data_loader=loader,
        batch_size=args.batch_size, async_mode=args.async_mode,
        streaming=args.streaming,
        shared_memory=args.shared_memory,
        output_shm_size=args.output_shared_memory_size,
        sequence_length=args.sequence_length,
        num_of_sequences=args.num_of_sequences,
        sequence_id_range=seq_range,
        string_length=args.string_length,
        shm_device=args.device)

    if args.request_intervals:
        manager = CustomLoadManager(
            intervals_file=args.request_intervals,
            max_threads=args.num_threads, **common)
        mode = "request_rate"
    elif args.request_rate_range:
        manager = RequestRateManager(
            distribution=args.request_distribution,
            max_threads=args.num_threads, **common)
        mode = "request_rate"
    else:
        manager = ConcurrencyManager(max_threads=args.num_threads, **common)
        mode = "concurrency"

    percentiles = [50, 90, 95, 99]
    if args.percentile and args.percentile not in percentiles:
        percentiles.append(args.percentile)

    profiler = InferenceProfiler(
        manager, parser, backend,
        measurement_window_ms=args.measurement_interval,
        measurement_mode=args.measurement_mode,
        measurement_request_count=args.measurement_request_count,
        stability_threshold=args.stability_percentage / 100.0,
        max_trials=args.max_trials,
        latency_threshold_us=args.latency_threshold,
        percentiles=tuple(sorted(percentiles)),
        stability_percentile=args.percentile,
        fail_on_window_compiles=not args.allow_window_compiles,
        fail_on_incident=args.fail_on_incident,
        retire_share_ceiling=args.retire_share_ceiling / 100.0,
        prefill_share_ceiling=args.prefill_share_ceiling / 100.0,
        min_goodput=args.min_goodput / 100.0)

    search = args.search_mode or ("binary" if args.binary_search
                                  else "linear")
    # Ctrl-C: stop issuing, drain live sequences, report partial data
    from client_tpu_torch.perf.perf_utils import (
        early_exit,
        install_sigint_handler,
    )
    early_exit.clear()  # a previous in-process run may have tripped it
    restore_sigint = install_sigint_handler()
    try:
        if args.request_intervals:
            results = profiler.profile_custom()
        elif args.request_rate_range:
            start, end, step = _parse_range(args.request_rate_range, float)
            results = profiler.profile_request_rate_range(
                start, end, step, search)
        else:
            start, end, step = _parse_range(args.concurrency_range)
            results = profiler.profile_concurrency_range(
                start, end, step, search,
                latency_threshold_us=args.latency_threshold)
    finally:
        restore_sigint()
        manager.cleanup()
        try:
            backend.close()
        except Exception:  # noqa: BLE001
            pass

    if early_exit.is_set():
        print("[perf] interrupted — reporting partial results")
    print(render_report(results, parser, mode))
    if args.csv_file:
        write_csv(args.csv_file, results, parser, mode)
        print(f"CSV written to {args.csv_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
