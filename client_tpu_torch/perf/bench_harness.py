"""The BERT-base-class embedding encoder served behind the dynamic batcher,
a pipelined step probe, the ragged generation workload, and one
stabilized profiling point measured by the port's own perf analyzer:
the port's counterpart of ``client_tpu/perf/bench_harness.py``.

``build_bert_encoder`` builds the same model as the reference's (the
same config, one static batch bucket, mean-pooled f32 embedding) as a
TorchModel on the card. Its forward, ``encoder_apply``, is factored out
so the tests can run it at small widths through ``make_encoder_model``.

``run_point`` / ``stabilized_point`` profile a served model over the
in-process backend and the CUDA shared-memory data plane with the
window-of-3 stability gate. MFU divides by the card's own dense bf16
peak, looked up by the card's name; with no known card (or on the CPU)
it reports none.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from client_tpu_torch.device import resolve_device
from client_tpu_torch.models import transformer as t
from client_tpu_torch.server.config import (
    DynamicBatchingConfig,
    ModelConfig,
    TensorSpec,
)
from client_tpu_torch.server.model import (
    TorchModel,
    finish_host_copies,
    start_host_copies,
)

# BERT-base-class dims shared by every serving benchmark of the reference
D_MODEL, N_LAYERS, N_HEADS, HEAD_DIM, D_FF, VOCAB = 768, 12, 12, 64, 3072, 30528

# published peaks (NVIDIA data sheets, SXM parts): memory bytes/s, dense
# bf16 tensor-core FLOP/s, by a substring of the card's name
CARD_PEAKS = (
    ("H200", 4.8e12, 989e12),
    ("H100", 3.35e12, 989e12),
)


def card_peaks(name: str):
    """(memory bytes/s, dense bf16 FLOP/s) of a card by its name, or None
    for a card without published peaks here."""
    for key, bw, bf16 in CARD_PEAKS:
        if key in name:
            return bw, bf16
    return None


def device_bf16_peak(device) -> float | None:
    """Dense bf16 peak of the card ``device`` names; None on the CPU or an
    unknown card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    peaks = card_peaks(torch.cuda.get_device_name(dev))
    return peaks[1] if peaks else None


def bert_flops_per_infer(seq: int) -> int:
    """Dense FLOPs per inference: matmuls (qkv+proj+ffn MACs x2 x seq)
    plus attention (QK^T + AV = 2*seq^2*d MACs x2 per layer)."""
    return (N_LAYERS * (4 * D_MODEL * D_MODEL + 2 * D_MODEL * D_FF) * 2 * seq
            + N_LAYERS * 4 * seq * seq * D_MODEL)


def bert_config(seq: int, attn_impl: str = "flash") -> t.TransformerConfig:
    """The BERT-base-class encoder's TransformerConfig (bf16, bidirectional)."""
    return t.TransformerConfig(
        vocab_size=VOCAB, d_model=D_MODEL, n_layers=N_LAYERS,
        n_heads=N_HEADS, head_dim=HEAD_DIM, d_ff=D_FF, max_seq=seq,
        causal=False, dtype=torch.bfloat16, attn_impl=attn_impl)


def encoder_apply(cfg: t.TransformerConfig, params: dict, inputs: dict,
                  mesh=None) -> dict:
    """input_ids [B, L] -> {"embedding": [B, d] f32}: embed + pos_embed,
    the layers, the final RMSNorm, then a mean over the sequence. Under a
    mesh: the rank's dp block of the batch and tp block of the weights
    (the heads, and so K1's, split over tp), the embedding replicated over
    tp."""
    x = t.embed_tokens(cfg, params, inputs["input_ids"], mesh)
    for i in range(cfg.n_layers):
        x, _ = t._layer(cfg, x, t.layer_params(params, i), mesh)
    x = t._rmsnorm(x, params["final_norm"])
    return {"embedding": x.mean(dim=1).float()}


def make_encoder_model(cfg: t.TransformerConfig, params: dict, seq: int,
                       max_batch: int, name: str = "bert_base",
                       pipeline_depth: int = 8,
                       max_queue_delay_us: int = 5000,
                       device=None, mesh=None) -> TorchModel:
    """An encoder of any width behind the dynamic batcher with ONE static
    bucket: every batch pads to ``max_batch`` rows. With ``mesh`` the
    model is sharded over it (``TorchModel``'s mesh: the weights by
    ``param_specs``, the batch over dp; ``max_batch`` must divide by
    dp); every rank builds it, rank 0 serves it."""
    model_config = ModelConfig(
        name=name,
        max_batch_size=max_batch,
        inputs=(TensorSpec("input_ids", "INT32", (seq,)),),
        outputs=(TensorSpec("embedding", "FP32", (cfg.d_model,)),),
        dynamic_batching=DynamicBatchingConfig(
            preferred_batch_size=(max_batch,),
            max_queue_delay_microseconds=max_queue_delay_us,
            pipeline_depth=pipeline_depth),
        batch_buckets_override=(max_batch,),
    )
    if mesh is not None:
        return TorchModel(model_config,
                          lambda params, inputs, mesh: encoder_apply(
                              cfg, params, inputs, mesh),
                          params=params, mesh=mesh,
                          param_sharding=t.param_specs(cfg),
                          input_sharding=("dp", None))
    return TorchModel(model_config,
                      lambda params, inputs: encoder_apply(cfg, params, inputs),
                      params=params, device=device)


def build_bert_encoder(seq: int, max_batch: int, attn_impl: str = "flash",
                       name: str = "bert_base", pipeline_depth: int = 8,
                       max_queue_delay_us: int = 5000,
                       params_cache: dict = None, device=None,
                       seed: int = 0) -> TorchModel:
    """The BERT-base-class encoder with random weights from ``seed``,
    made on ``device`` (CUDA by default; raises without it).
    ``params_cache`` keeps the weights across builds, so two builds (for
    example flash and ref) share one set."""
    dev = resolve_device(device)
    cfg = bert_config(seq, attn_impl)
    params = params_cache.get("params") if params_cache is not None else None
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = t.init_params(gen, cfg)
        if params_cache is not None:
            params_cache["params"] = params
    return make_encoder_model(cfg, params, seq, max_batch, name=name,
                              pipeline_depth=pipeline_depth,
                              max_queue_delay_us=max_queue_delay_us,
                              device=dev)


def probe_step_ms(model: TorchModel, seq: int, max_batch: int,
                  iters: int = 10) -> float:
    """Pipelined per-step time of one max_batch forward of the exact
    model the server will host (launches overlap; one honest wait at the
    end)."""
    model.load()
    tok = np.zeros((max_batch, seq), np.int32)
    dev_in = model.device_put_inputs({"input_ids": tok})
    finish_host_copies(start_host_copies(model.execute_on_device(dev_in)))
    t0 = time.time()
    outs = [model.execute_on_device(dev_in) for _ in range(iters)]
    finish_host_copies(start_host_copies(outs[-1]))
    return (time.time() - t0) / iters * 1e3


def ragged_generation_jobs(seed: int, vocab: int, n_jobs: int,
                           prompt_range: tuple, budget_range: tuple,
                           max_seq: int) -> list:
    """The ragged generation workload of the reference's bench.py
    generation point: (prompt, budget) pairs, budgets clipped to the
    context. The same seed gives the reference's jobs."""
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n_jobs):
        plen = int(rng.integers(*prompt_range))
        budget = min(int(rng.integers(*budget_range)), max_seq - plen)
        jobs.append((rng.integers(0, vocab, size=plen).astype(np.int32),
                     budget))
    return jobs


def run_engine_jobs(engine, jobs, collect: bool = False,
                    join_timeout_s: float = 1800.0, **submit_kw) -> tuple:
    """Submit all jobs concurrently to a continuous-batching engine, one
    thread each; returns (wall_s, per-job time to first token), plus the
    per-stream token lists with ``collect=True``. A worker's exception is
    re-raised, a stream still alive ``join_timeout_s`` after the joins
    began fails the run, and without ``collect`` every stream must have
    streamed exactly its budget."""
    import threading

    t0 = time.time()
    ttft = [None] * len(jobs)
    tokens: list = [None] * len(jobs)
    errors: list = []

    def worker(i):
        prompt, budget = jobs[i]
        try:
            out = []
            for tok in engine.submit(np.asarray(prompt, np.int32), budget,
                                     **submit_kw):
                if ttft[i] is None:
                    ttft[i] = time.time() - t0
                out.append(tok)
            tokens[i] = out
        except Exception as e:  # noqa: BLE001 — re-raised after join
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(jobs))]
    for th in threads:
        th.start()
    deadline = time.time() + join_timeout_s
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.time()))
    dt = time.time() - t0
    hung = [i for i, th in enumerate(threads) if th.is_alive()]
    if errors or hung:
        raise RuntimeError(
            f"engine stream errors: hung={hung} errors={errors[:3]}")
    if collect:
        return dt, ttft, tokens
    bad = [(i, len(tokens[i]), jobs[i][1]) for i in range(len(jobs))
           if len(tokens[i]) != jobs[i][1]]
    if bad:
        raise RuntimeError(
            f"streams short of budget (job, got, want): {bad[:5]}")
    return dt, ttft


def run_point(server, model_name: str, concurrency: int, *,
              flops_per_infer: int, window_ms: int = 6000,
              stability: float = 0.07, max_trials: int = 10,
              output_shm_size: int = D_MODEL * 4,
              max_threads: int = 16, device=None) -> dict:
    """Profile ONE stabilized operating point of ``model_name`` over the
    in-process backend + the CUDA shared-memory data plane (regions on
    ``device``, the card unless the CPU is asked for). Returns infer_per_s,
    mfu (None without a known card), latency percentiles, the stabilized
    flag and the client's rejected-request count."""
    from client_tpu_torch.perf.client_backend import (
        BackendKind,
        ClientBackendFactory,
    )
    from client_tpu_torch.perf.concurrency_manager import ConcurrencyManager
    from client_tpu_torch.perf.data_loader import DataLoader
    from client_tpu_torch.perf.inference_profiler import InferenceProfiler
    from client_tpu_torch.perf.model_parser import ModelParser

    dev = resolve_device(device)
    factory = ClientBackendFactory(BackendKind.INPROCESS, server=server)
    backend = factory.create()
    parser = ModelParser()
    parser.init(backend, model_name, "", 1)
    loader = DataLoader(1)
    loader.generate_data(parser.inputs)
    manager = ConcurrencyManager(
        factory=factory, parser=parser, data_loader=loader,
        batch_size=1, async_mode=True, streaming=False,
        shared_memory="cuda", output_shm_size=output_shm_size,
        max_threads=max_threads, shm_device=dev)
    profiler = InferenceProfiler(
        manager, parser, backend,
        measurement_window_ms=window_ms,
        stability_threshold=stability, max_trials=max_trials)
    try:
        status = profiler.profile_concurrency_range(
            concurrency, concurrency, 1, "none")[-1]
    finally:
        manager.cleanup()
    ips = status.client_infer_per_sec
    peak = device_bf16_peak(dev)
    return {
        "infer_per_s": round(ips, 2),
        "mfu": round(ips * flops_per_infer / peak, 4) if peak else None,
        "p50_latency_ms": round(
            status.latency.percentiles_us.get(50, 0.0) / 1e3, 2),
        "p99_latency_ms": round(
            status.latency.percentiles_us.get(99, 0.0) / 1e3, 2),
        "stabilized": status.stabilized,
        "concurrency": concurrency,
        "client_rejected_count": status.client_rejected_count,
    }


def stabilized_point(server, model_name: str, concurrency: int, *,
                     flops_per_infer: int, window_ms: int = 6000,
                     stability: float = 0.07, max_trials: int = 10,
                     output_shm_size: int = D_MODEL * 4,
                     max_threads: int = 16, attempts: int = 5,
                     point_fn=None, device=None) -> dict:
    """A stabilized operating point, escalating when one profile run fails
    its window-of-3 gate:

    1. re-run, re-anchoring the measurement (a full fresh run, not more
       trials on the drifted anchor);
    2. from the 3rd attempt, relax the stability gate to 10% — the
       reference CLI's own default;
    3. from the 4th, also back concurrency off by 25% per attempt — at the
       saturation corner the closed loop itself oscillates, and a
       slightly-backed-off point is an honest stabilized measurement where
       an unstabilized corner reading is not.

    Every attempt is recorded in the returned point's
    ``stabilization.history``. Returns the first stabilized point; if none
    stabilizes, the highest-throughput attempt with ``stabilized: false``
    intact and ``exhausted: true``, so the failure is explicit.
    """
    if point_fn is None:
        def point_fn(conc, stab):
            return run_point(
                server, model_name, conc, flops_per_infer=flops_per_infer,
                window_ms=window_ms, stability=stab, max_trials=max_trials,
                output_shm_size=output_shm_size, max_threads=max_threads,
                device=device)
    history = []
    best = None
    conc = concurrency
    for attempt in range(1, attempts + 1):
        stab = stability if attempt <= 2 else max(stability, 0.10)
        if attempt >= 4:
            conc = max(1, int(conc * 0.75))
        point = point_fn(conc, stab)
        history.append({"attempt": attempt, "concurrency": conc,
                        "stability_gate": stab,
                        "infer_per_s": point["infer_per_s"],
                        "stabilized": point["stabilized"]})
        if best is None or point["infer_per_s"] > best["infer_per_s"]:
            best = point
        if point["stabilized"]:
            point["stabilization"] = {"attempts": attempt,
                                      "history": history}
            return point
    best["stabilization"] = {"attempts": attempts, "history": history,
                             "exhausted": True}
    return best
