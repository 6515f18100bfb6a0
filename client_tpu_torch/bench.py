"""bench.py of the JAX package, ported: the BERT-base-class encoder served
in process over the CUDA shared-memory data plane and measured by the
port's own perf analyzer, then the continuous-batching generation point.

    python -m client_tpu_torch.bench [--device cpu]

Prints ONE JSON line with bench.py's schema: the headline point (seq 128,
one bucket of ``BENCH_MAX_BATCH`` = 256, ``BENCH_CONCURRENCY`` = 2560 in
flight), the ``latency_bounded`` point (bucket ``BENCH_LB_MAX_BATCH`` =
128 at ``BENCH_LB_CONCURRENCY`` = 768, target p50 250 ms) and the
``generation`` point (bench.py's 32 ragged jobs at full width on the slot
layout with ``attn_impl="ref"``, 16 slots, chunk 16, depth 2: a warm-up
submit, then two passes aggregated as total tokens over total time). It
reads bench.py's ``BENCH_*`` variables (window ``BENCH_WINDOW_MS`` = 6000,
``BENCH_STABILITY`` = 0.07, ``BENCH_MAX_TRIALS`` = 10,
``BENCH_STABILIZE_ATTEMPTS`` = 5, ``BENCH_PIPELINE_DEPTH`` = 8) and adds
``device`` (the card's name and power limit from ``nvidia-smi``) and, per
encoder point, ``server_infer_per_s``: the server's completions over the
point's whole run, beside the analyzer's stabilised reading.

``vs_baseline`` is null: bench.py's baseline was measured on another
device. Two of bench.py's habits are not kept, because each would hide a
failure: the encoder always serves the flash-attention kernel (K1), whose
build or launch failure raises instead of falling through to the plain
attention (on CPU tensors K1's wrapper runs its plain version), and a
failed point exits non-zero instead of printing an error field.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from client_tpu_torch.device import resolve_device
from client_tpu_torch.models import transformer as t
from client_tpu_torch.perf import bench_harness as bh

SEQ = 128
LB_TARGET_P50_MS = 250.0


@dataclasses.dataclass(frozen=True)
class Settings:
    """bench.py's operating points and measurement settings."""
    max_batch: int = 256
    concurrency: int = 2560
    lb_max_batch: int = 128
    lb_concurrency: int = 768
    pipeline_depth: int = 8
    window_ms: int = 6000
    max_trials: int = 10
    stability: float = 0.07
    attempts: int = 5

    @classmethod
    def from_env(cls, env=os.environ) -> "Settings":
        """bench.py's ``BENCH_*`` variables over its defaults."""
        d = cls()
        return cls(
            max_batch=int(env.get("BENCH_MAX_BATCH", d.max_batch)),
            concurrency=int(env.get("BENCH_CONCURRENCY", d.concurrency)),
            lb_max_batch=int(env.get("BENCH_LB_MAX_BATCH", d.lb_max_batch)),
            lb_concurrency=int(env.get("BENCH_LB_CONCURRENCY",
                                       d.lb_concurrency)),
            pipeline_depth=int(env.get("BENCH_PIPELINE_DEPTH",
                                       d.pipeline_depth)),
            window_ms=int(env.get("BENCH_WINDOW_MS", d.window_ms)),
            max_trials=int(env.get("BENCH_MAX_TRIALS", d.max_trials)),
            stability=float(env.get("BENCH_STABILITY", d.stability)),
            attempts=int(env.get("BENCH_STABILIZE_ATTEMPTS", d.attempts)))


def generation_config() -> t.TransformerConfig:
    """bench.py's generation model: vocab 30528, d 768, 12 layers, 12
    heads of 64, d_ff 3072, max_seq 192, bf16, the plain attention."""
    return t.TransformerConfig(
        vocab_size=30528, d_model=768, n_layers=12, n_heads=12, head_dim=64,
        d_ff=3072, max_seq=192, causal=True, dtype=torch.bfloat16,
        attn_impl="ref")


def device_info(device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them;
    ``{"name": "cpu", "power_limit": None}`` on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in line.rsplit(",", 1))
    return {"name": name, "power_limit": power}


class Encoder:
    """Builds the served encoder of one configuration (the BERT-base-class
    one unless ``cfg`` is given) on the flash-attention kernel (K1), one
    set of weights from ``seed`` shared by every build."""

    def __init__(self, device, settings: Settings, cfg=None, seq: int = SEQ,
                 seed: int = 0):
        self.device = device
        self.settings = settings
        self.cfg = dataclasses.replace(cfg or bh.bert_config(seq),
                                       attn_impl="flash")
        self.seq = seq
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.params = t.init_params(gen, self.cfg)

    def build(self, name: str = "bert_base", max_batch: int = 0):
        return bh.make_encoder_model(
            self.cfg, self.params, self.seq, max_batch or self.settings.max_batch,
            name=name, pipeline_depth=self.settings.pipeline_depth,
            device=self.device)


def start_server(encoder: Encoder):
    """The server with the encoder on the flash-attention kernel (K1),
    registered with a warm-up; a registration that fails raises."""
    from client_tpu_torch.server import TorchInferenceServer

    server = TorchInferenceServer()
    server.register_model(encoder.build(), warmup=True)
    return server


def run_point(server, encoder: Encoder, model_name: str,
              concurrency: int) -> dict:
    """One stabilised operating point in bench.py's schema (throughput
    under "value"), plus the server's own completions per second over
    the point's whole run."""
    s = encoder.settings
    before = server.statistics(model_name)["model_stats"][0]
    t0 = time.perf_counter()
    point = bh.stabilized_point(
        server, model_name, concurrency,
        flops_per_infer=bh.bert_flops_per_infer(encoder.seq),
        window_ms=s.window_ms, stability=s.stability,
        max_trials=s.max_trials, attempts=s.attempts,
        output_shm_size=encoder.cfg.d_model * 4, device=encoder.device)
    wall = time.perf_counter() - t0
    after = server.statistics(model_name)["model_stats"][0]
    point["value"] = point.pop("infer_per_s")
    point["server_infer_per_s"] = (
        (after["inference_count"] - before["inference_count"]) / wall)
    return point


def run_generation_point(device, cfg=None, jobs=None, n_slots: int = 16,
                         chunk: int = 16, seed: int = 0) -> dict:
    """bench.py's generation point: the continuous-batching engine with
    its defaults (the slot layout, token-level prefill) on ``cfg``
    (bench.py's model unless given) and bench.py's 32 ragged jobs unless
    ``jobs`` are given; a warm-up submit outside the clock, then two
    passes, aggregated as total useful tokens over total time. Any
    stream that fails or falls short of its budget raises."""
    from client_tpu_torch.server.generation import ContinuousBatchingEngine

    cfg = cfg or generation_config()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = t.init_params(gen, cfg)
    if jobs is None:
        jobs = bh.ragged_generation_jobs(7, cfg.vocab_size, 32, (8, 64),
                                         (16, 128), cfg.max_seq)
    useful = sum(b for _, b in jobs)
    eng = ContinuousBatchingEngine(cfg, params, n_slots=n_slots,
                                   chunk=chunk, dispatch_depth=2,
                                   device=device).start()
    try:
        list(eng.submit(jobs[0][0][:4], 2))   # the engine's first chunk
        times = [bh.run_engine_jobs(eng, jobs)[0] for _ in range(2)]
    finally:
        eng.stop()
    return {
        "metric": "continuous_batching_ragged_tokens_per_s",
        "value": round(len(times) * useful / sum(times), 2),
        "unit": "tok/s",
        "pass_rates": [round(useful / dt, 2) for dt in times],
        "n_jobs": len(jobs),
        "n_slots": n_slots,
        "useful_tokens": useful,
    }


def run_bench(device, settings: Settings, encoder_cfg=None, seq: int = SEQ,
              generation: dict = None) -> dict:
    """The three points, as one dict in bench.py's schema.
    ``encoder_cfg``/``seq`` and ``generation`` (keyword arguments of
    ``run_generation_point``) shrink the models for a test."""
    encoder = Encoder(device, settings, cfg=encoder_cfg, seq=seq)
    server = start_server(encoder)
    try:
        primary = run_point(server, encoder, "bert_base",
                            settings.concurrency)
        lb = None
        if settings.lb_concurrency > 0:
            server.register_model(
                encoder.build(name="bert_base_lb",
                              max_batch=settings.lb_max_batch),
                warmup=True)
            lb = run_point(server, encoder, "bert_base_lb",
                           settings.lb_concurrency)
            lb["max_batch"] = settings.lb_max_batch
            lb["target_p50_ms"] = LB_TARGET_P50_MS
            lb["meets_target"] = lb["p50_latency_ms"] <= LB_TARGET_P50_MS
    finally:
        # the encoder's buffers go before the decoder loads
        server.stop()
    out = {
        "metric": f"bert_base_seq{seq}_dynbatch_cudashm_infer_per_s",
        "unit": "infer/s",
        "vs_baseline": None,
        "attn_impl": "flash",
        "attn_fallback_reason": None,
        "max_batch": settings.max_batch,
        "device": device_info(device),
    }
    out.update(primary)
    if lb is not None:
        out["latency_bounded"] = lb
    out["generation"] = run_generation_point(device, **(generation or {}))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m client_tpu_torch.bench",
        description="bench.py's three points on the port")
    parser.add_argument("--device", default=None,
                        help="torch device (the card by default; 'cpu' "
                             "only when asked)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps(run_bench(device, Settings.from_env())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
