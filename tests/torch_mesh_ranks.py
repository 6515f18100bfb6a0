"""Rank bodies of tests/test_torch_mesh_engine.py,
tests/test_torch_mesh_planes.py and tests/test_torch_mesh_serving.py, run by
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
from client_tpu_torch.server.kv_cache import pool_block_nbytes


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
                torch.device("cpu", 0), torch.device("cpu", 9)))),
    }
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



def _handoffs(eng) -> list:
    """Record each lane handoff's (lane slot, decode slot)."""
    taken = []
    handoff = eng._handoff

    def spy(l_idx, d_idx):
        taken.append((l_idx, d_idx))
        handoff(l_idx, d_idx)

    eng._handoff = spy
    return taken


def _shard_shapes(eng, names: dict) -> dict:
    """The shapes of this rank's device state ``names`` ({label: key path
    into ``eng._dev``}), read at the engine's first chunk (its warm-up,
    when every state is built), on the driver and the followers alike."""
    got = {}
    chunk = eng._op_chunk

    def spy(*args):
        if not got:
            for label, path in names.items():
                node = eng._dev
                for key in path:
                    node = node[key]
                got[label] = tuple(node.shape)
        return chunk(*args)

    eng._op_chunk = spy
    return got


def _tier_rows(eng) -> list:
    """Record, on a follower, the shapes of the rows it files under the
    driver's key at each spill."""
    shapes = []
    spill = eng._op_tier_spill

    def spy(key, bid):
        spill(key, bid)
        shapes.append({n: tuple(r.shape)
                       for n, r in eng._tier_rows[key].items()})

    eng._op_tier_spill = spy
    return shapes


def _tier_cycle(eng, case: dict) -> dict:
    """Family A on decode slot 0 (dp rank 0), B and C after it on the same
    slot (the small pool spills A's committed blocks to the host tier),
    then a filler on slot 0 while A again takes slot 1 (dp rank 1): its
    hit restores the blocks dp rank 0 wrote."""
    taken = _slots_taken(eng)
    fams = [np.asarray(f, np.int32) for f in case["families"]]
    budget = case["family_budget"]
    first = list(eng.submit(fams[0], budget))
    for fam in fams[1:]:
        list(eng.submit(fam, budget))
    filler = eng.submit(np.asarray(case["filler"], np.int32), 12)
    second = list(eng.submit(fams[0], budget))
    list(filler)
    tier = eng._kv_index.tier_snapshot()
    pool, layer_major = eng._tier_pool()
    return {"tokens": [first, second], "slots": taken,
            "spills": tier["spills"], "restores": tier["restores"],
            "tier_hits": eng.gen_stats.snapshot()["tier_hits"],
            "block_nbytes": eng._kv_index.tier.block_nbytes,
            "shard_block_nbytes": pool_block_nbytes(pool, layer_major)}


def _supervised(rank: int, mesh, tiny, tparams, jobs: list) -> dict:
    """A supervised generator over the mesh: streams, an injected crash of
    the driver's engine (every rank rebuilds it), the streams again, then
    a second crash that trips the breaker (max_failures 2), whose STOP
    ends the followers."""
    from client_tpu_torch.models.decoder_lm import make_continuous_generator

    model = make_continuous_generator(
        "sup_lm", cfg=tiny, params=tparams, n_slots=4, chunk_size=4,
        mesh=mesh, supervision={"backoff_base_s": 0.05, "max_failures": 2,
                                "window_s": 300.0})
    sup = model.engine_supervisor
    if rank != 0:
        model.engine.start()            # follows every rebuilt engine
        return {"restarts": sup.restarts, "crash_looped": sup.crash_looped}
    inj = faultinject.get_injector()

    def crash() -> str:
        inj.arm([{"point": "engine_loop", "times": 1,
                  "match": {"engine": "sup_lm"}}])
        try:
            return _err(lambda: list(model.engine.submit(
                np.asarray([1, 2], np.int32), 4)))
        finally:
            inj.clear()

    def wait(done) -> None:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not done():
            time.sleep(0.02)

    model.engine.start()
    before = _concurrent(model.engine, jobs)
    first_crash = crash()
    wait(lambda: sup.restarts == 1 and model.engine_healthy())
    after = _concurrent(model.engine, jobs)
    second_crash = crash()
    wait(lambda: sup.crash_looped)
    out = {"before": before, "after": after, "first_crash": first_crash,
           "second_crash": second_crash, "restarts": sup.restarts,
           "crash_looped": sup.crash_looped,
           "healthy": model.engine_healthy()}
    model.shutdown()
    return out


def mesh_planes(rank, world, case: dict) -> dict:
    """dp2 x tp2 over 4 gloo ranks: every optional plane of the engine
    under the mesh (tests/test_torch_mesh_planes.py): speculation, the
    dedicated lanes (per slot and batched), the host tier and int8 KV on
    both layouts, with each rank's shard of each plane's state, then
    supervision."""
    from client_tpu_torch.server.speculation import DraftModel

    mesh = make_mesh({"dp": 2, "tp": 2}, device="cpu")
    tiny = cfg_of(case["tiny"])
    tparams = tt.params_from_jax(case["tiny_params"], "cpu", torch.float32)
    kv8 = dataclasses.replace(tiny, kv_quant=True)
    jobs, long_jobs = case["jobs"], case["long_jobs"]
    paged = dict(kv_layout="paged", kv_block_len=8)
    out, shards = {}, {}

    def engine(cfg, **kw):
        kw.setdefault("n_slots", 4)
        kw.setdefault("chunk", 4)
        return ContinuousBatchingEngine(cfg, tparams, mesh=mesh, **kw)

    # speculation with a self-draft, both layouts
    for layout, kw in (("slot", {}), ("paged", paged)):
        eng = engine(tiny, speculative_draft=DraftModel(tiny, tparams),
                     speculative_gamma=3, **kw)
        shards[f"spec_{layout}"] = _shard_shapes(eng, {
            "dcache_k": ("dcache", "k"), "dpos": ("dpos",),
            "dparams_wqkv": ("dparams", "layers", "wqkv")})
        out[f"spec_{layout}"] = _run(rank, eng, lambda e: {
            "tokens": _concurrent(e, jobs),
            "spec": e.stats()["speculation"]})

    # the dedicated lanes, per slot and batched, both layouts
    for layout, kw in (("slot", dict(prefix_cache=True, prefix_blocks=32,
                                     prefix_block_len=4)),
                       ("paged", paged)):
        for batch in (0, 2):
            eng = engine(tiny, prefill_mode="chunked", prefill_chunk=8,
                         prefill_slots=2, prefill_lane_width=8,
                         prefill_lane_batch=batch, **kw)
            taken = _handoffs(eng)
            lane = {"lane_pos": ("lane_pos",), "lane_last": ("lane_last",)}
            if layout == "slot":
                lane["lane_cache_k"] = ("lane_cache", "k")
            shards[f"lane_{layout}_{batch}"] = _shard_shapes(eng, lane)
            out[f"lane_{layout}_{batch}"] = _run(rank, eng, lambda e: {
                "tokens": _concurrent(e, long_jobs),
                "handoffs": list(taken)})

    # the host tier: a prefix spilled from dp rank 0, restored for dp
    # rank 1
    for layout, kw in (("slot", dict(prefix_blocks=11, prefix_block_len=8)),
                       ("paged", dict(paged, kv_pool_blocks=16,
                                      prefix_block_len=8,
                                      prefill_mode="chunked",
                                      prefill_chunk=16))):
        eng = engine(tiny, n_slots=2, prefix_cache=True,
                     host_tier_bytes=1 << 22, **kw)
        rows = _tier_rows(eng) if rank else []
        out[f"tier_{layout}"] = _run(rank, eng,
                                     lambda e: _tier_cycle(e, case))
        shards[f"tier_{layout}"] = {"rows": rows[:1]}

    # int8 KV, both layouts: the scale tables at this rank's heads
    for layout, kw in (("slot", {}), ("paged", paged)):
        eng = engine(kv8, **kw)
        state = "pool" if kw else "cache"
        shards[f"int8_{layout}"] = _shard_shapes(eng, {
            "k": (state, "k"), "k_scale": (state, "k_scale")})
        out[f"int8_{layout}"] = _run(rank, eng,
                                     lambda e: _concurrent(e, jobs))
    out["shards"] = shards

    out["supervision"] = _supervised(rank, mesh, tiny, tparams, jobs[:2])
    return out


def one_rank_mesh_planes(rank, world, kw: dict, plane: str) -> list:
    """A one-rank NCCL mesh engine beside the unsharded one, on the card,
    at GQA widths (4 heads over 2 KV heads, rope, swiglu, K2 on the paged
    layout), with ``plane`` on: a self-draft at gamma 3 (``"spec"``) or
    int8 KV (``"int8"``). Returns each arm's streams of four jobs and its
    verify rounds (tests/test_torch_cuda.py)."""
    from client_tpu_torch.server.speculation import DraftModel

    cfg = tt.TransformerConfig(vocab_size=128, d_model=64, n_layers=2,
                               n_heads=4, n_kv_heads=2, head_dim=16,
                               d_ff=128, max_seq=64, rope=True, ffn="swiglu",
                               dtype=torch.bfloat16, attn_impl="flash",
                               kv_quant=plane == "int8")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tt.init_params(gen, cfg)
    if plane == "spec":
        kw = dict(kw, speculative_draft=DraftModel(cfg, params),
                  speculative_gamma=3)
    jobs = [(np.arange(1, 9), 6), (np.arange(3, 20), 5), (np.asarray([5]), 7),
            (np.arange(40, 52), 9)]
    out = []
    for mesh in (None, make_mesh({"dp": 1, "tp": 1}, device="cuda")):
        eng = ContinuousBatchingEngine(cfg, params, n_slots=4, chunk=4,
                                       mesh=mesh, **kw)
        try:
            its = [eng.submit(p, b) for p, b in jobs]
            streams = [list(it) for it in its]
            spec = eng.stats()["speculation"]
        finally:
            eng.stop()
        out.append({"streams": streams,
                    "rounds": None if spec is None else spec["rounds"]})
    return out


# ------------------------------------------------ replica fleets on ranks
#
# Rank bodies of tests/test_torch_fleet_mesh.py: fleets whose replicas
# shard over the ranks, rank 0 routing and driving every replica through
# the fleet's one plan channel, the other ranks following.


def _fleet_run(rank: int, build, drive) -> dict:
    """Rank 0 builds the fleet model (``build()``), runs ``drive(model)``
    and shuts the fleet down; every other rank builds it and follows
    until then. Each rank returns what it saw: ``drive``'s result (rank
    0), the (replica, op) plans its channel carried from the first, its
    followed rows, and each first replica's shard as its first
    ``_op_ready`` left it."""
    from client_tpu_torch.parallel.spmd import FleetChannel
    from client_tpu_torch.server.generation import ContinuousBatchingEngine

    shards = {}
    ready, channel = (ContinuousBatchingEngine._op_ready,
                      FleetChannel.__init__)

    def spy(eng):
        ready(eng)
        idx = int(eng.name.rsplit("/r", 1)[1])
        if idx < first and idx not in shards:
            shards[idx] = {
                "member": eng._shard,
                "pool": ("pool" in eng._dev
                         and tuple(eng._dev["pool"]["k"].shape)),
                "pos": "pos" in eng._dev and tuple(eng._dev["pos"].shape),
                "wqkv": ("params" in eng._dev and tuple(
                    eng._dev["params"]["layers"]["wqkv"].shape))}

    def logged(chan, *a, **kw):
        channel(chan, *a, **kw)
        chan.log = []

    ContinuousBatchingEngine._op_ready = spy
    FleetChannel.__init__ = logged
    result = None
    try:
        model = build()
        fleet = model.fleet
        first = fleet.config.replicas
        if rank == 0:
            try:
                result = drive(model)
            finally:
                model.shutdown()
        else:
            model.follow()
    finally:
        ContinuousBatchingEngine._op_ready = ready
        FleetChannel.__init__ = channel
    return {"result": result, "log": list(fleet.plans.log),
            "followed": dict(fleet.followed), "shards": shards}


def _routed(fleet, jobs: list) -> dict:
    """Each (prompt, budget, tenant) job routed and read to its end before
    the next (the fleet idle in between): the tokens, the decisions and
    each replica's counters."""
    tokens = [list(fleet.submit(np.asarray(p, np.int32), b, tenant_id=t))
              for p, b, t in jobs]
    snap = fleet.fleet_snapshot()
    return {"tokens": tokens,
            "decisions": [{k: v for k, v in d.items() if k != "ns"}
                          for d in snap["recent_decisions"]],
            "counters": [(r["replica"], r["routed"], r["affinity_hits"],
                          r["rerouted"]) for r in snap["rows"]]}


def _subsets(model, case: dict) -> dict:
    """The routed jobs over replicas on rank pairs, then a replica
    attached past the declared subsets (the default placement: an
    unsharded engine on rank 0) and the jobs again."""
    fleet = model.fleet
    first = _routed(fleet, case["fleet_jobs"])
    idx = fleet.attach_replica()
    eng = fleet.replicas[-1].engine
    placed = {"idx": idx, "mesh": eng._mesh is not None,
              "device": str(eng._device)}
    return {"first": first, "attached": placed,
            "second": _routed(fleet, case["fleet_jobs"])}


def _lifecycle(model, case: dict) -> dict:
    """Under the mesh, supervised: a drain of the replica a stream is on
    while it runs, a rolling restart, an attach, an injected crash of
    replica 1 (rebuilt by its supervisor), then every job once more."""
    import threading

    fleet = model.fleet
    prompt, budget, tenant = case["fleet_jobs"][0]
    failed, tokens = [], {}

    def read(key, it):
        try:
            tokens[key] = list(it)
        except Exception as e:  # noqa: BLE001 — counted as failed
            failed.append((key, repr(e)))

    it = fleet.submit(np.asarray(prompt, np.int32), 20, tenant_id=tenant)
    on = fleet.fleet_snapshot()["recent_decisions"][-1]["replica"]
    reader = threading.Thread(target=read, args=("mid_drain", it))
    reader.start()
    drained = fleet.drain(on)
    reader.join(timeout=120)
    restarted = fleet.rolling_restart()
    attached = fleet.attach_replica(warm_prompt=np.zeros(4, np.int32))
    inj = faultinject.get_injector()
    inj.arm([{"point": "engine_loop", "times": 1,
              "match": {"engine": f"{model.config.name}/r1"}}])
    sup = fleet.replicas[1].sup
    try:
        fleet.replicas[1].engine.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                sup.restarts == 1 and sup.healthy()):
            time.sleep(0.02)
    finally:
        inj.clear()
    after = _routed(fleet, case["fleet_jobs"])
    return {"mid_drain": tokens.get("mid_drain"), "drained": drained,
            "on": on, "restarted": restarted, "attached": attached,
            "failed": failed, "restarts": [
                r.sup.restarts for r in fleet.replicas],
            "after": after["tokens"], "replicas": len(fleet.replicas)}


def _autoscaled(model, case: dict) -> dict:
    """One controller step that attaches a replica under a held queue and
    one that drains and detaches it once idle (the reference's scale 1 ->
    2 -> 1 scenario)."""
    import threading

    fleet, ctl = model.fleet, model.autoscaler
    gate = threading.Event()
    inner = fleet.replicas[0].engine._dispatch

    def gated(*a, **kw):
        gate.wait(60)
        return inner(*a, **kw)

    fleet.replicas[0].engine._dispatch = gated
    its = [fleet.submit(np.asarray(p, np.int32), b, tenant_id=t)
           for p, b, t in case["fleet_jobs"][:4]]
    steps = [ctl.step(), ctl.step()]
    gate.set()
    tokens = [list(it) for it in its]
    end = time.monotonic() + 30
    while time.monotonic() < end and any(
            r.engine.load_depth() for r in fleet.replicas):
        time.sleep(0.01)
    steps += [ctl.step(), ctl.step()]
    return {"steps": [[{k: v for k, v in d.items() if k != "ns"}
                       for d in s] for s in steps],
            "tokens": tokens, "replicas": [r.idx for r in fleet.replicas]}


def _tiered(model, case: dict) -> dict:
    """The routed jobs over slot-layout replicas with the prefix cache and
    the host tier, each on a rank pair (replica 0 on ranks 2 and 3: rank
    0 drives it without a shard), then the tier families one tenant after
    another (cold prompts of one tenant go to one replica: more blocks
    than its pool holds, so blocks spill) and the first family again (its
    blocks come back from the tier), every dispatch's device time sampled
    synchronously: each replica's tier counters, its store's block size,
    its memory ledger and its sampled dispatches."""
    fleet = model.fleet
    jobs = _routed(fleet, case["fleet_jobs"])["tokens"]
    fams = [np.asarray(f, np.int32) for f in case["tier_families"]]
    families = [list(fleet.submit(f, 5, tenant_id="acme"))
                for f in fams + fams[:1]]
    reps = []
    for r in fleet.replicas:
        idx = r.engine._kv_index
        tier = idx.tier_snapshot() or {"spills": 0, "restores": 0}
        gp = r.engine.goodput
        reps.append({"spills": tier["spills"], "restores": tier["restores"],
                     "block_nbytes": idx.tier.block_nbytes
                     if idx.tier is not None else 0,
                     "memory": r.engine.runtime_snapshot()["memory"],
                     "sampled": gp.snapshot()["sampled_total"],
                     "blocks": gp.event_blocks})
    return {"jobs": jobs, "families": families, "replicas": reps}


def _gloo_indices() -> dict:
    """Integer device indices resolved on gloo ranks while the process
    sees cards (``torch.cuda.device_count`` stubbed to 2): each subset's
    ranks and device type, and a one-index subset's device."""
    from client_tpu_torch.server.generation import ContinuousBatchingEngine

    resolve = ContinuousBatchingEngine.resolve_engine_devices
    real = torch.cuda.device_count
    torch.cuda.device_count = lambda: 2
    try:
        out = {}
        for devs in ((0, 1), (2, 3), (3, 0)):
            m = resolve(devs)
            out[str(devs)] = (m.mesh.flatten().tolist(), m.device_type)
        out["(1,)"] = str(resolve((1,)))
        return out
    finally:
        torch.cuda.device_count = real


def mesh_fleet(rank, world, case: dict) -> dict:
    """4 gloo ranks (tests/test_torch_fleet_mesh.py): a 2-replica fleet
    under dp2 x tp2, a fleet over the rank pairs (0, 1) and (2, 3) with a
    replica attached past them, a slot-layout fleet with the host tier
    over the pairs (2, 3) and (0, 1), a supervised fleet's lifecycle
    under the mesh, and an autoscaled fleet under the mesh."""
    from client_tpu_torch.models.decoder_lm import (
        make_continuous_generator,
        make_replica_fleet,
    )

    spmd.HEARTBEAT_S = 0.5
    tiny = cfg_of(case["tiny"])
    tparams = tt.params_from_jax(case["tiny_params"], "cpu", torch.float32)
    knobs = case["fleet_knobs"]
    mesh = make_mesh({"dp": 2, "tp": 2}, device="cpu")
    out = {"indices": _gloo_indices()}
    out["mesh"] = _fleet_run(rank, lambda: make_continuous_generator(
        "fm_lm", cfg=tiny, params=tparams, mesh=mesh, fleet=2, **knobs),
        lambda m: _routed(m.fleet, case["fleet_jobs"]))
    out["subsets"] = _fleet_run(rank, lambda: make_replica_fleet(
        "fs_lm", replicas=2, cfg=tiny, params=tparams, device="cpu",
        replica_devices=[(0, 1), (2, 3)], **knobs),
        lambda m: _subsets(m, case))
    out["tier"] = _fleet_run(rank, lambda: make_replica_fleet(
        "ft_lm", replicas=2, cfg=tiny, params=tparams, device="cpu",
        replica_devices=[(2, 3), (0, 1)], n_slots=2, chunk_size=4,
        max_new_tokens=6, prefix_cache=True, prefix_blocks=4,
        prefix_block_len=8, host_tier_bytes=1 << 20,
        device_time_sample_every=1),
        lambda m: _tiered(m, case))
    out["lifecycle"] = _fleet_run(rank, lambda: make_replica_fleet(
        "fl_lm", replicas=2, cfg=tiny, params=tparams, mesh=mesh,
        supervision={"backoff_base_s": 0.05, "max_failures": 3,
                     "window_s": 300.0}, **knobs),
        lambda m: _lifecycle(m, case))
    out["autoscale"] = _fleet_run(rank, lambda: make_replica_fleet(
        "fa_lm", replicas=1, cfg=tiny, params=tparams, mesh=mesh,
        autoscale=case["autoscale"], **knobs),
        lambda m: _autoscaled(m, case))
    return out
