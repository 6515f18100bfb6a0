"""Where the time of bench.py's headline path goes: the host threads and
the card, under the perf analyzer's steady in-process load.

    python -m client_tpu_torch.perf.profile_serve_shm [--bucket 256]
        [--concurrency 2560] [--threads 16] [--window-s 3]

Serves the BERT-base-class encoder of ``bench_harness.build_bert_encoder``
(random weights from a seed, flash attention, pipeline depth 8) on the
card and drives it as ``run_point`` does: the in-process backend, inputs
and outputs in CUDA shared-memory regions, ``--concurrency`` requests in
flight from ``--threads`` async workers. After a warm-up window it
measures two windows of ``--window-s`` each and prints one JSON object:

- window 1, the host: completed requests per second, and the CPU seconds
  each group of threads spent per wall second (the load workers, the
  batcher's dispatcher, its completion workers, the rest), read from
  /proc/self/task/<tid>/stat, plus where each group's threads were, by
  sampling their Python stacks every 5 ms (innermost frame);
- window 2, the card: torch.profiler's kernel events over one active
  step of a profiler schedule (CUDA activity only), the statistics read
  at its edges: the device's busy share, device ms per batch and
  batches per second.

The card's name and power limit come first. Runs on the card only.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import threading
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from client_tpu_torch.perf.bench_harness import D_MODEL, build_bert_encoder
from client_tpu_torch.perf.client_backend import (
    BackendKind,
    ClientBackendFactory,
)
from client_tpu_torch.perf.concurrency_manager import ConcurrencyManager
from client_tpu_torch.perf.data_loader import DataLoader
from client_tpu_torch.perf.model_parser import ModelParser
from client_tpu_torch.server import TorchInferenceServer

_TICK_S = 1.0 / os.sysconf("SC_CLK_TCK")


def card_label() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def thread_group(name: str) -> str:
    if name.startswith("perf-conc-"):
        return "load_workers"
    if name.startswith("batcher-complete-"):
        return "completion_workers"
    if name.startswith("batcher-"):
        return "dispatcher"
    return "other"


def _cpu_s(native_id: int) -> float:
    """CPU seconds (user + system) one thread of this process has used."""
    with open(f"/proc/self/task/{native_id}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) * _TICK_S


def _cpu_by_group() -> dict:
    out: dict = collections.Counter()
    for t in threading.enumerate():
        try:
            out[thread_group(t.name)] += _cpu_s(t.native_id)
        except (OSError, TypeError):
            pass   # the thread ended between the listing and the read
    return out


def _sample_stacks(stop: threading.Event, counts: dict,
                   interval_s: float = 0.005) -> None:
    names = {}
    while not stop.wait(interval_s):
        for t in threading.enumerate():
            names[t.ident] = t.name
        for ident, frame in sys._current_frames().items():
            group = thread_group(names.get(ident, ""))
            code = frame.f_code
            where = (f"{os.path.basename(code.co_filename)}:"
                     f"{code.co_name}:{frame.f_lineno}")
            counts[group][where] += 1


def _stats(core, name):
    return core.statistics(name)["model_stats"][0]


def profile_serve_shm(bucket: int, concurrency: int, threads: int,
                      window_s: float) -> dict:
    seq = 128
    core = TorchInferenceServer()
    core.register_model(build_bert_encoder(seq, bucket, attn_impl="flash",
                                           pipeline_depth=8), warmup=True)
    factory = ClientBackendFactory(BackendKind.INPROCESS, server=core)
    parser = ModelParser()
    parser.init(factory.create(), "bert_base")
    loader = DataLoader(1)
    loader.generate_data(parser.inputs)
    manager = ConcurrencyManager(
        factory, parser, loader, async_mode=True, shared_memory="cuda",
        output_shm_size=D_MODEL * 4, max_threads=threads)
    try:
        manager.change_concurrency_level(concurrency)
        time.sleep(window_s)   # warm-up: the closed loop fills
        manager.check_health()

        # window 1: host threads, no profiler
        counts = collections.defaultdict(collections.Counter)
        stop = threading.Event()
        sampler = threading.Thread(target=_sample_stacks,
                                   args=(stop, counts), name="sampler")
        before, cpu0 = _stats(core, "bert_base"), _cpu_by_group()
        t0 = time.perf_counter()
        sampler.start()
        time.sleep(window_s)
        stop.set()
        sampler.join(timeout=10)
        wall = time.perf_counter() - t0
        cpu1, after = _cpu_by_group(), _stats(core, "bert_base")
        host = {
            "infer_per_s": (after["inference_count"]
                            - before["inference_count"]) / wall,
            "batches_per_s": (after["execution_count"]
                              - before["execution_count"]) / wall,
            "cpu_s_per_wall_s": {g: (cpu1[g] - cpu0.get(g, 0.0)) / wall
                                 for g in sorted(cpu1)},
            "where": {g: [{"frame": f, "share": n / sum(c.values())}
                          for f, n in c.most_common(8)]
                      for g, c in sorted(counts.items())
                      if g != "other"},
        }

        # window 2: the card. The profiler's start and stop take seconds,
        # so the schedule records one active step, delimited by step()
        # calls, and the statistics are read at its edges
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            time.sleep(0.5)
            prof.step()    # warm-up done: record from here
            before = _stats(core, "bert_base")
            t0 = time.perf_counter()
            time.sleep(window_s)
            wall = time.perf_counter() - t0
            after = _stats(core, "bert_base")
            prof.step()    # the active step ends
        manager.check_health()
    finally:
        manager.cleanup()
        core.stop()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        raise RuntimeError("the profiler saw no device time")
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    batches = after["execution_count"] - before["execution_count"]
    device = {
        "infer_per_s": (after["inference_count"]
                        - before["inference_count"]) / wall,
        "batches_per_s": batches / wall,
        "device_busy_share": min(1.0, busy_s / wall),
        "device_ms_per_batch": busy_s * 1e3 / batches if batches else None,
    }
    return {"card": card_label(), "bucket": bucket,
            "concurrency": concurrency, "threads": threads,
            "window_s": window_s, "host_window": host,
            "device_window": device}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("client_tpu_torch.perf.profile_serve_shm")
    ap.add_argument("--bucket", type=int, default=256)
    ap.add_argument("--concurrency", type=int, default=2560)
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--window-s", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve_shm: CUDA is not available", file=sys.stderr)
        return 1
    print(json.dumps(profile_serve_shm(args.bucket, args.concurrency,
                                       args.threads, args.window_s)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
