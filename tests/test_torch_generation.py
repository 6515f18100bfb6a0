"""The port's continuous-batching engine (client_tpu_torch.server.
generation) end to end on the CPU, held against the JAX package's paged
engine with the same f32 weights, and its served decoupled path.

Greedy streams must be token-identical to the reference engine's
(``kv_layout="paged"``, ``attn_impl="ref"``), whatever the port's fetch
stride and overlap; sampled streams must reproduce on resubmission with
the same seed. On the CPU the port's ``flash`` attention is K2's plain
version; the kernel itself runs on the card (tests/test_torch_cuda.py).
"""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import transformer as jt
from client_tpu.perf import bench_harness as jbh
from client_tpu.server.generation import (
    ContinuousBatchingEngine as JaxEngine,
)
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.models.decoder_lm import (
    make_continuous_generator,
    make_replica_fleet,
)
from client_tpu_torch.perf import bench_harness as tbh
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server.generation import ContinuousBatchingEngine
from client_tpu_torch.server.types import (
    InferRequest,
    InferTensor,
    ServerError,
)

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=64, causal=True)
ENGINE = dict(n_slots=4, chunk=4, kv_block_len=4)


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def jobs():
    got = tbh.ragged_generation_jobs(7, 64, 6, (1, 20), (3, 20), 64)
    want = jbh.ragged_generation_jobs(7, 64, 6, (1, 20), (3, 20), 64)
    assert all(np.array_equal(a[0], b[0]) and a[1] == b[1]
               for a, b in zip(got, want))
    return got


@pytest.fixture(scope="module")
def jax_streams(model, jobs):
    """The reference's paged engine on the same weights and jobs."""
    jcfg, jparams, _, _ = model
    eng = JaxEngine(jcfg, dict(jparams), kv_layout="paged", **ENGINE).start()
    try:
        _, _, toks = jbh.run_engine_jobs(eng, jobs, collect=True,
                                         join_timeout_s=300)
    finally:
        eng.stop()
    return toks


def _port_engine(model, **kw):
    _, _, tcfg, tparams = model
    return ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                    kv_layout="paged",
                                    **{**ENGINE, **kw}).start()


@pytest.mark.parametrize("stride,overlap", [(4, True), (1, True),
                                            (4, False)])
def test_greedy_streams_match_the_jax_engine(model, jobs, jax_streams,
                                             stride, overlap):
    eng = _port_engine(model, fetch_stride=stride, overlap=overlap)
    try:
        _, _, toks = tbh.run_engine_jobs(eng, jobs, collect=True,
                                         join_timeout_s=300)
        assert [len(t) for t in toks] == [b for _, b in jobs]
        assert toks == jax_streams
        stats = eng.stats()
        assert stats["tokens_emitted"] == sum(b for _, b in jobs)
        assert stats["chunks_dispatched"] > 0
    finally:
        eng.stop()
    # every block and reservation went back to the allocator
    occ = eng._kv_index.occupancy()
    assert occ["free"] == occ["usable"] and occ["reserved"] == 0


def test_sampled_streams_reproduce_with_their_seed(model, jobs):
    eng = _port_engine(model)
    try:
        kw = dict(temperature=0.8, top_k=8, top_p=0.95, seed=11)
        first = tbh.run_engine_jobs(eng, jobs, collect=True, **kw)[2]
        again = tbh.run_engine_jobs(eng, jobs, collect=True, **kw)[2]
        other = tbh.run_engine_jobs(eng, jobs, collect=True,
                                    **{**kw, "seed": 12})[2]
    finally:
        eng.stop()
    assert first == again
    assert first != other
    assert all(0 <= tok < 64 for s in first for tok in s)


def test_a_full_pool_parks_requests_until_blocks_free(model, jobs):
    """A pool of 9 usable blocks holds one worst-case stream of the jobs
    at a time: the rest wait at the queue head, and the streams are the
    same."""
    eng = _port_engine(model, kv_pool_blocks=10)
    try:
        _, _, toks = tbh.run_engine_jobs(eng, jobs, collect=True,
                                         join_timeout_s=300)
        one = list(eng.submit(jobs[0][0], jobs[0][1]))
    finally:
        eng.stop()
    assert toks[0] == one
    assert [len(t) for t in toks] == [b for _, b in jobs]


def test_submit_validates_like_the_reference(model):
    eng = _port_engine(model)
    try:
        with pytest.raises(ServerError, match="top_k") as ei:
            eng.submit([1, 2], 4, top_k=65)
        assert ei.value.status == 400
        with pytest.raises(ServerError, match="integer"):
            eng.submit(np.asarray([1.5]), 4)
        with pytest.raises(ServerError, match="max context"):
            eng.submit(np.zeros(64, np.int32), 4)
        with pytest.raises(ServerError, match="max_new_tokens"):
            eng.submit([1], 0)
        assert list(eng.submit(np.zeros(0, np.int32), 4)) == []
        # a budget past the context is clipped to it
        assert len(list(eng.submit(np.zeros(60, np.int32), 100))) == 4
    finally:
        eng.stop()
    with pytest.raises(ServerError) as ei:
        eng.submit([1], 2)
    assert ei.value.status == 503


def test_abandoned_stream_frees_its_slot(model):
    eng = _port_engine(model, n_slots=1, fetch_stride=1)
    dispatch = eng._dispatch

    def slow_dispatch():      # ~0.5 s for the whole 40-token budget
        time.sleep(0.05)
        return dispatch()

    eng._dispatch = slow_dispatch
    try:
        it = eng.submit([3, 4, 5], 40)
        assert isinstance(next(it), int)
        it.close()          # the consumer goes away
        assert len(list(eng.submit([3, 4, 5], 6))) == 6
        assert eng.gen_stats.cancelled == 1
        assert eng.stats()["tokens_emitted"] < 40 + 6
    finally:
        eng.stop()


def test_concurrent_submitters_stress(model):
    """More submitting threads than cores and slots, with a short switch
    interval: every stream ends with exactly its budget, the engine counts
    every accepted stream as closed, and every block comes back."""
    import sys

    eng = _port_engine(model, n_slots=3, chunk=2, fetch_stride=2,
                       queue_depth=4)
    rng = np.random.default_rng(5)
    jobs = [(rng.integers(0, 64, size=int(rng.integers(1, 6))).astype(
        np.int32), int(rng.integers(1, 6))) for _ in range(24)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _, _, toks = tbh.run_engine_jobs(eng, jobs, collect=True,
                                         join_timeout_s=120)
        assert eng.drain(timeout=30)
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert [len(t) for t in toks] == [b for _, b in jobs]
    assert eng._requests_accepted == eng._requests_closed == len(jobs)
    occ = eng._kv_index.occupancy()
    assert occ["free"] == occ["usable"] and occ["reserved"] == 0


# a dp2 mesh as the engine's validation reads it
_DP2 = types.SimpleNamespace(mesh_dim_names=("dp", "tp"), shape=(2, 1),
                             device_type="cpu")


@pytest.mark.parametrize("factory,kw", [
    ("generator", dict(fleet=2, mesh=_DP2)),
    ("replica_fleet", dict(replicas=2, mesh=_DP2)),
    ("generator", dict(
        fleet=2, device="cpu",
        replica_devices=[(torch.device("cpu", 0), torch.device("cpu", 1)),
                         None])),
    ("replica_fleet", dict(
        replicas=2, device="cpu",
        replica_devices=[(torch.device("cpu", 0), torch.device("cpu", 1)),
                         None]))],
    ids=["generator-mesh", "replica_fleet-mesh", "generator-subset",
         "replica_fleet-subset"])
def test_a_sharded_fleet_without_a_process_group_raises(model, factory, kw):
    """A fleet under a mesh and a replica over two devices run one process
    per device: without a live process group both raise ``ValueError``
    saying so, from the generator and from make_replica_fleet."""
    _, _, tcfg, tparams = model
    make = {"generator": make_continuous_generator,
            "replica_fleet": make_replica_fleet}[factory]
    with pytest.raises(ValueError, match="live process group"):
        make(cfg=tcfg, params=tparams, n_slots=2, **kw)


def test_a_bad_mesh_or_subset_raises(model):
    """A mesh that is not a DeviceMesh raises TypeError; a device subset
    with no process group of its ranks raises ValueError; an unknown knob
    raises TypeError."""
    _, _, tcfg, tparams = model
    with pytest.raises(TypeError, match="DeviceMesh"):
        ContinuousBatchingEngine(tcfg, tparams, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="live process group"):
        ContinuousBatchingEngine(
            tcfg, tparams, device="cpu",
            engine_devices=(torch.device("cpu"), torch.device("cuda", 0)))
    with pytest.raises(TypeError, match="unknown"):
        ContinuousBatchingEngine(tcfg, tparams, device="cpu", bogus=1)


def test_ported_goodput_knob_builds_engines(model):
    """``device_time_sample_every``, no longer refused, builds an engine
    and a generator that serve a stream; every 4th dispatch of a kind is
    sampled (on the CPU the wait is a no-op), and the tokens are those of
    an engine that samples nothing."""
    _, _, tcfg, tparams = model
    prompt = np.asarray([3, 17, 42], np.int32)
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                   device_time_sample_every=4)
    gen = make_continuous_generator(cfg=tcfg, params=tparams, device="cpu",
                                    device_time_sample_every=4)
    plain = ContinuousBatchingEngine(tcfg, tparams, device="cpu")
    try:
        toks = list(eng.submit(prompt, 40))
        gen_toks = list(gen.engine.submit(prompt, 40))
        plain_toks = list(plain.submit(prompt, 40))
    finally:
        for e in (eng, gen.engine, plain):
            e.stop()
    assert toks == gen_toks == plain_toks and len(toks) == 40
    for e in (eng, gen.engine):
        gp = e.goodput.snapshot()
        assert gp["sample_every"] == 4
        assert gp["sampled"] == {
            k: n // 4 for k, n in gp["dispatches"].items() if n >= 4}
        assert gp["sampled_total"] >= 1 and e.goodput.event_blocks == 0
    assert plain.goodput.snapshot()["sampled_total"] == 0
    assert "device_time_sample_every" not in gen.config.to_json()[
        "generation_engine"]


@pytest.mark.parametrize("knob", [
    "watchdog_thresholds", "watchdog", "watchdog_interval_s",
    "incident_store"])
def test_ported_watchdog_knobs_build_engines(model, knob, tmp_path):
    """The four watchdog knobs, no longer refused, build an engine and a
    generator that serve a stream (the generator's store is its own, so
    its ``incident_store`` case spills the store to ``incident_file``);
    each knob lands where the reference puts it."""
    from client_tpu_torch.server.watchdog import IncidentStore

    _, _, tcfg, tparams = model
    store = IncidentStore()
    value = {"watchdog_thresholds": {"stall_wall_s": 9.0},
             "watchdog": False, "watchdog_interval_s": 0.5,
             "incident_store": store}[knob]
    gen_kw = ({"incident_file": str(tmp_path / "inc.jsonl")}
              if knob == "incident_store" else {knob: value})
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                   **{knob: value})
    gen = make_continuous_generator(cfg=tcfg, params=tparams, device="cpu",
                                    **gen_kw)
    try:
        toks = list(eng.submit(np.asarray([3, 17, 42], np.int32), 4))
        gen_toks = list(gen.engine.submit(np.asarray([3, 17, 42], np.int32),
                                          4))
    finally:
        eng.stop()
        gen.engine.stop()
    assert toks == gen_toks and len(toks) == 4
    for e in (eng, gen.engine):
        wd = e.watchdog_snapshot()
        if knob == "watchdog":
            assert wd is None and e.incident_snapshot() is None
        elif knob == "watchdog_thresholds":
            assert e._watchdog.thresholds["stall_wall_s"] == 9.0
        elif knob == "watchdog_interval_s":
            assert wd["interval_s"] == 0.5
    if knob == "incident_store":
        assert eng.incidents is store
        assert gen.engine.incidents.spill_path == gen_kw["incident_file"]
    engine_json = gen.config.to_json()["generation_engine"]
    assert engine_json["watchdog"] is (knob != "watchdog")
    assert engine_json["watchdog_interval_s"] == (
        0.5 if knob == "watchdog_interval_s" else 0.25)


@pytest.mark.parametrize("knob,value", [
    ("host_tier_bytes", 1 << 20), ("scheduler", True),
    ("slo_classes", [{"name": "gold", "ttft_ms": 500.0}]),
    ("slo_window_s", 5.0), ("slo_max_tenants", 4), ("dispatch_duty", 0.5)])
def test_ported_scheduler_and_tier_knobs_build_engines(model, knob, value):
    """The six knobs of the scheduler and the host tier, no longer
    refused, build an engine and a generator that serve a stream (the
    tier needs the prefix cache it spills)."""
    _, _, tcfg, tparams = model
    kw = {knob: value, "prefix_cache": knob == "host_tier_bytes"}
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **kw)
    gen = make_continuous_generator(cfg=tcfg, params=tparams, device="cpu",
                                    **kw)
    try:
        toks = list(eng.submit(np.asarray([3, 17, 42], np.int32), 4))
        gen_toks = list(gen.engine.submit(np.asarray([3, 17, 42], np.int32),
                                          4))
    finally:
        eng.stop()
        gen.engine.stop()
    assert toks == gen_toks and len(toks) == 4
    assert eng.stats()["slo"]["tenant_classes"][0]["completed"] == 1



@pytest.mark.parametrize("knob,value", [
    ("prefill_slots", 2), ("prefill_lane_width", 8),
    ("prefill_lane_batch", 2)])
def test_ported_lane_knobs_build_engines(model, knob, value):
    """The three dedicated-lane knobs, no longer refused, build an engine
    and a generator on the paged layout with the chunked lane that serve
    a prompt longer than a chunk through a lane slot (width and batch
    ride a two-slot lane); the generator's config advertises the lane the
    engine runs."""
    _, _, tcfg, tparams = model
    kw = {"prefill_slots": 2, knob: value}
    kw.update(prefill_mode="chunked", prefill_chunk=16, kv_layout="paged",
              kv_block_len=4, n_slots=2, chunk=4)
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **kw)
    kw["chunk_size"] = kw.pop("chunk")
    gen = make_continuous_generator(cfg=tcfg, params=tparams, device="cpu",
                                    **kw)
    prompt = np.arange(1, 23, dtype=np.int32)
    try:
        toks = list(eng.submit(prompt, 4))
        gen_toks = list(gen.engine.submit(prompt, 4))
    finally:
        eng.stop()
        gen.engine.stop()
    assert toks == gen_toks and len(toks) == 4
    lane = eng.stats()["prefill_lane"]
    assert lane["dedicated"] and lane["handoffs"] == 1
    ge = gen.config.to_json()["generation_engine"]
    assert (ge["prefill_slots"], ge["prefill_lane_width"]) == (
        2, value if knob == "prefill_lane_width" else 16)
    assert ge["prefill_lane_batch"] == (2 if knob == "prefill_lane_batch"
                                        else 0)


@pytest.mark.parametrize("kv_layout", ["slot", "paged"])
def test_speculative_knobs_construct_a_speculating_engine(model, kv_layout):
    """The four speculative knobs, no longer refused, build an engine and
    a generator that speculate (a self-draft: every proposal accepted)."""
    from client_tpu_torch.server.speculation import DraftModel

    _, _, tcfg, tparams = model
    knobs = dict(speculative_draft=DraftModel(tcfg, tparams),
                 speculative_gamma=2, speculative_min_acceptance=0.25,
                 speculative_gamma_ladder=True)
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                   kv_layout=kv_layout, **knobs)
    gen = make_continuous_generator(cfg=tcfg, params=tparams, device="cpu",
                                    kv_layout=kv_layout, **knobs)
    try:
        toks = list(eng.submit(np.asarray([3, 17, 42], np.int32), 6))
        snap = eng.stats()["speculation"]
    finally:
        eng.stop()
        gen.engine.stop()
    assert len(toks) == 6
    assert snap["ladder"] == [1, 2] and snap["min_acceptance"] == 0.25
    assert snap["rounds"] > 0 and snap["accepted"] == snap["proposed"]
    assert gen.config.to_json()["speculative"]["gamma_ladder"] is True


# ---------------------------------------------------------------- serving

def _request(prompt, budget, **sampling):
    inputs = [InferTensor("PROMPT", "INT32", (len(prompt),),
                          data=np.asarray(prompt, np.int32)),
              InferTensor("MAX_TOKENS", "INT32", (1,),
                          data=np.asarray([budget], np.int32))]
    for name, dt, val in (("TEMPERATURE", "FP32", "temperature"),
                          ("TOP_K", "INT32", "top_k"),
                          ("SEED", "INT32", "seed")):
        if val in sampling:
            np_dt = np.float32 if dt == "FP32" else np.int32
            inputs.append(InferTensor(name, dt, (1,), data=np.asarray(
                [sampling[val]], np_dt)))
    return InferRequest(model_name="gen", inputs=inputs)


def _stream(core, req):
    got, done = [], threading.Event()

    def cb(resp, final):
        got.append((resp, final))
        if final:
            done.set()

    core.infer(req, response_callback=cb)
    assert done.wait(120)
    return got


def test_served_decoupled_path_streams_tokens_then_the_final_flag(
        model, jobs, jax_streams):
    _, _, tcfg, tparams = model
    core = TorchInferenceServer()
    core.register_model(make_continuous_generator(
        "gen", cfg=tcfg, params=tparams, device="cpu", n_slots=4,
        chunk_size=4, kv_layout="paged", kv_block_len=4), warmup=True)
    try:
        cfg_json = core.model_config("gen")
        assert cfg_json["model_transaction_policy"] == {"decoupled": True}
        prompt, budget = jobs[1]
        got = _stream(core, _request(prompt, budget))
        assert len(got) == budget + 1
        assert all(not final and resp.error is None
                   for resp, final in got[:-1])
        toks = [int(resp.output("TOKEN").data[0]) for resp, _ in got[:-1]]
        assert toks == jax_streams[1]
        last, final = got[-1]
        assert final and last.outputs == []
        assert last.parameters == {"triton_final_response": True}
        # sampled through the wire inputs, reproducible by seed
        a = _stream(core, _request(prompt, 5, temperature=0.9, top_k=4,
                                   seed=3))
        b = _stream(core, _request(prompt, 5, temperature=0.9, top_k=4,
                                   seed=3))
        assert [r.output("TOKEN").data[0] for r, _ in a[:-1]] == \
            [r.output("TOKEN").data[0] for r, _ in b[:-1]]
        # a decoupled model answers a call without a callback with 400
        with pytest.raises(ServerError, match="decoupled") as ei:
            core.infer(_request(prompt, 2))
        assert ei.value.status == 400
        # a top_k past the sampling width is a 400 response, not a clamp
        bad = _stream(core, _request(prompt, 2, top_k=65))
        assert len(bad) == 1 and bad[0][1]
        assert bad[0][0].error_status == 400
        stats = core.statistics("gen")["model_stats"][0]
        assert stats["inference_count"] >= 3
    finally:
        core.stop()
