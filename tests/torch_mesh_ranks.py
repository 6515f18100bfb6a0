"""Rank bodies of tests/test_torch_mesh_engine.py and
tests/test_torch_mesh_serving.py, run by
``client_tpu_torch.parallel.collectives.run_ranks`` in spawned gloo
processes.

This module imports torch and the port only (no JAX), so every rank starts
quickly; the test modules compute the reference's results and compare.
Rank 0 drives every sharded object and returns what it saw; the other
ranks follow and return what they observed of their own shard.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import time

import numpy as np
import torch

from client_tpu_torch.models import transformer as tt
from client_tpu_torch.parallel import spmd
from client_tpu_torch.parallel.collectives import all_gather
from client_tpu_torch.parallel.mesh import axis_group, make_mesh
from client_tpu_torch.server import faultinject
from client_tpu_torch.server.generation import ContinuousBatchingEngine


# a short group timeout, and an idle gap of twice it on rank 0
IDLE_TIMEOUT_S = 4.0


def cfg_of(kw: dict) -> tt.TransformerConfig:
    return tt.TransformerConfig(dtype=torch.float32, **kw)


def _err(fn) -> str:
    """``"<type>: <message>"`` of what ``fn()`` raises ("" when nothing)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads the text
        return f"{type(e).__name__}: {e}"
    return ""


def _concurrent(eng, jobs: list, sampling: dict = None) -> list:
    """Every job submitted before any is read (so the engine batches them
    in submit order), then each stream read to its end; ``sampling``
    maps a job's index to its submit keywords."""
    sampling = sampling or {}
    its = [eng.submit(np.asarray(p, np.int32), b, **sampling.get(i, {}))
           for i, (p, b) in enumerate(jobs)]
    return [list(it) for it in its]


def _slots_taken(eng) -> list:
    """Record the decode slot each admission takes, in admission order."""
    taken = []
    fill = eng._fill_slot

    def spy(slot, req):
        taken.append(eng._slots.index(slot))
        fill(slot, req)

    eng._fill_slot = spy
    return taken


def _run(rank: int, eng, drive):
    """Rank 0 starts ``eng`` and returns ``drive(eng)`` (stopping the
    engine after); every other rank follows until rank 0 stops."""
    if rank == 0:
        eng.start()
        try:
            return drive(eng)
        finally:
            eng.stop()
    eng.start()
    return None


def _shared_prefix(eng, case: dict) -> dict:
    """A filler stream holds decode slot 0, so SHARED + [1] takes slot 1
    (the second dp rank); once both ended, SHARED + [2] takes slot 0
    (the first): the hit reads blocks the other dp rank wrote."""
    taken = _slots_taken(eng)
    filler = eng.submit(np.asarray(case["filler"], np.int32), 20)
    first = list(eng.submit(np.asarray(case["shared"] + [1], np.int32), 5))
    list(filler)
    second = list(eng.submit(np.asarray(case["shared"] + [2], np.int32), 5))
    snap = eng.generation_snapshot()
    return {"tokens": [first, second], "slots": taken,
            "hits": snap["prefix_hits"]}


def mesh_engine(rank, world, case: dict) -> dict:
    """dp2 x tp2 over 4 gloo ranks: every engine scenario of
    tests/test_torch_mesh_engine.py, then the loud errors, the failure
    paths and the dry run's steps 1-4 at this world size."""
    from client_tpu_torch.parallel.dryrun import dryrun_steps

    mesh = make_mesh({"dp": 2, "tp": 2}, device="cpu")
    tiny = cfg_of(case["tiny"])
    tparams = tt.params_from_jax(case["tiny_params"], "cpu", torch.float32)
    llama = cfg_of(case["llama"])
    lparams = tt.params_from_jax(case["llama_params"], "cpu", torch.float32)
    jobs, long_jobs = case["jobs"], case["long_jobs"]
    out = {}

    def engine(cfg, params, **kw):
        kw.setdefault("n_slots", 4)
        kw.setdefault("chunk", 4)
        return ContinuousBatchingEngine(cfg, params, mesh=mesh, **kw)

    def jobs_of(js):
        return lambda eng: _concurrent(eng, js)

    # the five jobs, both layouts; the llama family, both layouts
    for name, cfg, params, kw, js in (
            ("slot", tiny, tparams, {}, jobs),
            ("paged", tiny, tparams, dict(kv_layout="paged",
                                          kv_block_len=8), jobs),
            ("llama_slot", llama, lparams, {}, jobs),
            ("llama_paged", llama, lparams, dict(kv_layout="paged",
                                                 kv_block_len=8), jobs),
            # prompts longer than a chunk: the lane's chunks and the
            # batched prefill, each a device op of its own
            ("chunked_slot", tiny, tparams, dict(prefill_mode="chunked",
                                                 prefill_chunk=8),
             long_jobs),
            ("chunked_paged", tiny, tparams, dict(
                prefill_mode="chunked", prefill_chunk=8, kv_layout="paged",
                kv_block_len=8), long_jobs),
            ("batched_slot", tiny, tparams, dict(prefill_mode="batched"),
             long_jobs)):
        out[name] = _run(rank, engine(cfg, params, **kw), jobs_of(js))

    # the prefix cache across dp ranks: paged (the pool is the prefix
    # pool) and the slot layout's block pool
    out["paged_prefix"] = _run(rank, engine(
        tiny, tparams, n_slots=2, kv_layout="paged", kv_block_len=8,
        prefix_cache=True, prefix_block_len=8), lambda eng: _shared_prefix(eng, case))
    out["slot_prefix"] = _run(rank, engine(
        tiny, tparams, n_slots=2, prefix_cache=True, prefix_blocks=16,
        prefix_block_len=4), lambda eng: _shared_prefix(eng, case))

    # sampled streams: the same seeds on the sharded and the port's
    # unsharded engine (rank 0 runs the latter alone)
    sampling = {i: dict(temperature=0.9, top_k=8, seed=5 + i)
                for i in range(len(jobs))}

    def sampled(eng):
        got = _concurrent(eng, jobs, sampling)
        plain = ContinuousBatchingEngine(tiny, tparams, n_slots=4, chunk=4,
                                         device="cpu")
        try:
            want = _concurrent(plain, jobs, sampling)
        finally:
            plain.stop()
        return {"sharded": got, "plain": want}

    out["sampled"] = _run(rank, engine(tiny, tparams), sampled)

    # every rank holds its block: the heads, ffn and vocab over tp, the
    # slots over dp, the pool's heads over tp (its blocks whole)
    probe = engine(tiny, tparams, kv_layout="paged", kv_block_len=8)
    out["shards"] = {
        "wqkv": tuple(probe._params_host["layers"]["wqkv"].shape),
        "embed": tuple(probe._params_host["embed"].shape)}
    out["follower_submit"] = (_err(lambda: probe.submit([1, 2], 2))
                              if rank else "")

    def state_shapes(eng):
        list(eng.submit(np.asarray([1, 2], np.int32), 2))  # built by now
        return {"pool_k": tuple(eng._dev["pool"]["k"].shape),
                "pos": tuple(eng._dev["pos"].shape),
                "ring": tuple(eng._dev["ring"].shape)}

    out["state"] = _run(rank, probe, state_shapes)
    out["groups_destroyed"] = probe._mesh.all_group is None

    # rank 0 idles for twice the groups' timeout: its heartbeat plans
    # keep the followers waiting, and the next stream is served alike
    saved = spmd.DEFAULT_TIMEOUT_S, spmd.HEARTBEAT_S
    spmd.DEFAULT_TIMEOUT_S, spmd.HEARTBEAT_S = IDLE_TIMEOUT_S, 0.5
    try:
        sleepy = engine(tiny, tparams)

        def idle_then_serve(eng):
            list(eng.submit(np.asarray([1, 2], np.int32), 2))  # built
            time.sleep(2 * IDLE_TIMEOUT_S)
            return _concurrent(eng, jobs[:1])

        out["idle"] = _run(rank, sleepy, idle_then_serve)
    finally:
        spmd.DEFAULT_TIMEOUT_S, spmd.HEARTBEAT_S = saved

    # rank 0 stops an engine it never started: its followers return
    idle = engine(tiny, tparams)
    out["unstarted"] = _err(idle.stop if rank == 0 else idle.start)

    # the reference's loud errors, raised on every rank alike
    tp4 = make_mesh({"dp": 1, "tp": 4}, device="cpu")
    errors = {
        "n_slots": _err(lambda: ContinuousBatchingEngine(
            tiny, tparams, n_slots=3, mesh=mesh)),
        "kv_heads": _err(lambda: ContinuousBatchingEngine(
            llama, lparams, n_slots=4, mesh=tp4)),
        "prefill_slots": _err(lambda: engine(
            tiny, tparams, prefill_mode="chunked", kv_layout="paged",
            prefill_slots=3)),
        "engine_devices": _err(lambda: ContinuousBatchingEngine(
            tiny, tparams, n_slots=2, engine_devices=(
                torch.device("cpu", 0), torch.device("cpu", 1)))),
    }
    from client_tpu_torch.server.speculation import DraftModel

    for knob, kw, cfg in (
            ("speculative_draft", dict(
                speculative_draft=DraftModel(tiny, tparams),
                speculative_gamma=2), tiny),
            ("prefill_slots", dict(prefill_mode="chunked", kv_layout="paged",
                                   prefill_slots=2), tiny),
            ("host_tier_bytes", dict(prefix_cache=True,
                                     host_tier_bytes=1 << 20), tiny),
            ("kv_quant", {}, dataclasses.replace(tiny, kv_quant=True))):
        errors[f"9c_{knob}"] = _err(lambda: engine(cfg, tparams, **kw))
    out["errors"] = errors

    # the failure paths: rank 0's engine dies (an injected loop fault)
    # and every follower raises; then the followers never start, and rank
    # 0's first collective times out and kills its engine
    doomed = engine(tiny, tparams, name="doomed")
    if rank == 0:
        faultinject.get_injector().arm([{"point": "engine_loop", "times": 1,
                                         "match": {"engine": "doomed"}}])
        doomed.start()
        doomed._thread.join(timeout=60)
        faultinject.get_injector().clear()
        out["death"] = {"healthy": doomed.healthy(),
                        "submit": _err(lambda: doomed.submit([1, 2], 2))}
    else:
        out["death"] = {"follower": _err(doomed.start)}
    spmd.DEFAULT_TIMEOUT_S, saved = 3.0, spmd.DEFAULT_TIMEOUT_S
    try:
        orphan = engine(tiny, tparams, name="orphan")
    finally:
        spmd.DEFAULT_TIMEOUT_S = saved
    if rank == 0:
        orphan.start()
        orphan._thread.join(timeout=60)
        out["timeout"] = {"healthy": orphan.healthy(),
                          "failed": f"{type(orphan._failed).__name__}: "
                                    f"{orphan._failed}"}
    out["dryrun"] = dryrun_steps(world, "cpu")
    return out


def mesh_serving(rank, world, case: dict) -> dict:
    """dp2 x tp4 over 8 gloo ranks: the sharded LM behind the port's HTTP
    front end on rank 0, requests over HTTP and over a CUDA shared-memory
    region (``device="cpu"``); every rank reports its embed shard."""
    from client_tpu_torch.server.config import (
        ModelConfig,
        ShardingSpec,
        TensorSpec,
    )
    from client_tpu_torch.server.model import TorchModel

    cfg = cfg_of(case["cfg"])
    params = tt.params_from_jax(case["params"], "cpu", torch.float32)
    mesh = make_mesh({"dp": 2, "tp": 4}, device="cpu")
    seq, vocab = case["seq"], cfg.vocab_size

    def apply_fn(p, inputs, mesh):
        # the vocab-parallel logits, gathered over tp to the whole vocab
        logits, _ = tt.forward(cfg, p, inputs["tokens"], mesh=mesh)
        return {"logits": all_gather(logits, axis_group(mesh, "tp"), -1)}

    config = ModelConfig(
        name="sharded_lm",
        inputs=(TensorSpec("tokens", "INT32", (2, seq)),),
        outputs=(TensorSpec("logits", "FP32", (2, seq, vocab)),),
        sharding=ShardingSpec(mesh_axes=("dp", "tp"), mesh_shape=(2, 4),
                              batch_axis="dp"))
    # short group timeouts: the follower waits out an idle gap of twice
    # the timeout on rank 0's heartbeats
    spmd.DEFAULT_TIMEOUT_S, spmd.HEARTBEAT_S = IDLE_TIMEOUT_S, 0.5
    model = TorchModel(config, apply_fn, params=params, mesh=mesh,
                       param_sharding=tt.param_specs(cfg),
                       input_sharding=("dp", None))
    out = {"embed_rows": None}
    if rank != 0:
        model.follow()
        out["embed_rows"] = int(model._params["embed"].shape[0])
    else:
        out.update(_serve(model, case, params, cfg))
    out["groups_destroyed"] = model._mesh.all_group is None
    return out


def _serve(model, case: dict, params: dict, cfg) -> dict:
    """Rank 0: register the model behind HTTP, infer over the wire and
    over a CUDA shm region, read the config JSON, then stop the core
    (whose unload ends the followers)."""
    from client_tpu_torch.client import http as httpclient
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    core = TorchInferenceServer()
    core.register_model(model)
    srv = HttpInferenceServer(core, port=0).start()
    out = {"embed_rows": int(model._params["embed"].shape[0])}
    try:
        client = httpclient.InferenceServerClient(f"localhost:{srv.port}")
        tokens = np.asarray(case["tokens"], np.int32)
        i0 = httpclient.InferInput("tokens", tokens.shape, "INT32")
        i0.set_data_from_numpy(tokens)
        out["http"] = client.infer("sharded_lm", [i0]).as_numpy("logits")
        with torch.inference_mode():
            plain, _ = tt.forward(cfg, params, torch.from_numpy(tokens))
        out["plain"] = plain.numpy()
        ones = np.ones_like(tokens)
        handle = cudashm.create_shared_memory_region(
            "dist_shm", ones.nbytes, device="cpu")
        try:
            cudashm.set_shared_memory_region(handle, [ones])
            client.register_cuda_shared_memory(
                "dist_shm", cudashm.get_raw_handle(handle), 0, ones.nbytes)
            i1 = httpclient.InferInput("tokens", ones.shape, "INT32")
            i1.set_shared_memory("dist_shm", ones.nbytes, 0)
            out["shm"] = client.infer("sharded_lm", [i1]).as_numpy("logits")
        finally:
            client.unregister_cuda_shared_memory()
            cudashm.destroy_shared_memory_region(handle)
        time.sleep(2 * IDLE_TIMEOUT_S)    # idle: heartbeats only
        out["after_idle"] = client.infer("sharded_lm", [i0]).as_numpy(
            "logits")
        out["config"] = client.get_model_config("sharded_lm")
        if importlib.util.find_spec("grpc") is not None:
            out["grpc_config"] = _grpc_config(core)
    finally:
        srv.stop()
        core.stop()
    return out


def _grpc_config(core) -> dict:
    """The model's config as the port's gRPC front end answers it."""
    from client_tpu_torch.client import grpc as grpcclient
    from client_tpu_torch.server.grpc_server import GrpcInferenceServer

    srv = GrpcInferenceServer(core, port=0).start()
    try:
        client = grpcclient.InferenceServerClient(f"127.0.0.1:{srv.port}")
        try:
            return client.get_model_config("sharded_lm",
                                           as_json=True)["config"]
        finally:
            client.close()
    finally:
        srv.stop()


def one_rank_mesh_engine(rank, world, kw: dict) -> list:
    """A one-rank NCCL mesh engine beside the unsharded one, on the card:
    both streams of three jobs (tests/test_torch_cuda.py)."""
    cfg = tt.TransformerConfig(vocab_size=128, d_model=64, n_layers=2,
                               n_heads=4, head_dim=16, d_ff=128, max_seq=64,
                               dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tt.init_params(gen, cfg)
    jobs = [(np.arange(1, 9), 6), (np.arange(3, 20), 5), (np.asarray([5]), 7)]
    out = []
    for mesh in (None, make_mesh({"dp": 1, "tp": 1}, device="cuda")):
        eng = ContinuousBatchingEngine(cfg, params, n_slots=4, chunk=4,
                                       mesh=mesh, **kw)
        try:
            its = [eng.submit(p, b) for p, b in jobs]
            out.append([list(it) for it in its])
        finally:
            eng.stop()
    return out
