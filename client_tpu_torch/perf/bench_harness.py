"""The BERT-base-class embedding encoder served behind the dynamic batcher,
a pipelined step probe, and the ragged generation workload: the port's
counterpart of ``client_tpu/perf/bench_harness.py``.

``build_bert_encoder`` builds the same model as the reference's (the
same config, one static batch bucket, mean-pooled f32 embedding) as a
TorchModel on the card. Its forward, ``encoder_apply``, is factored out
so the tests can run it at small widths through ``make_encoder_model``.
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


def encoder_apply(cfg: t.TransformerConfig, params: dict, inputs: dict) -> dict:
    """input_ids [B, L] -> {"embedding": [B, d] f32}: embed + pos_embed,
    the layers, the final RMSNorm, then a mean over the sequence."""
    x = t.embed_tokens(cfg, params, inputs["input_ids"])
    for i in range(cfg.n_layers):
        x = t._layer(cfg, x, t.layer_params(params, i))
    x = t._rmsnorm(x, params["final_norm"])
    return {"embedding": x.mean(dim=1).float()}


def make_encoder_model(cfg: t.TransformerConfig, params: dict, seq: int,
                       max_batch: int, name: str = "bert_base",
                       pipeline_depth: int = 8,
                       max_queue_delay_us: int = 5000,
                       device=None) -> TorchModel:
    """An encoder of any width behind the dynamic batcher with ONE static
    bucket: every batch pads to ``max_batch`` rows."""
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
