"""The runtime compile plane: the port against the JAX package, on the CPU.

- ``CompileWatch``: the reference's watch cases (first signature, novel
  shape, dtype and static value, pytree signatures, the sealed-set
  violation with its WARNING and COMPILE span, the histogram through a
  recompile storm, reset) run on both packages' watches with the same
  inputs, giving equal tables apart from seconds; ``describe_signature``
  of torch tensors is the reference's string for jnp arrays of the same
  shape and dtype.
- ``TorchModel`` against ``JaxModel`` at the same buckets: the same kinds
  and counts, sealed, no growth under traffic, a forced compile after the
  seal counted, warned and stamped the same way, reset on unload;
  ``SequenceModel`` is never sealed.
- The engine in every configuration (slot, paged, prefix cache, chunked
  prefill, lanes, speculation, int8 KV, the host tier): compile counts per
  kind equal the JAX engine's after warmup and after the same jobs, with 0
  unexpected in both, and the same tokens.
- The readers: ``/metrics`` passes the reference's naming lint with the
  runtime families and compile counters equal to the reference's; the
  watchdog's ``compile_violation`` fires on a real engine; the fleet's and
  the autoscaler's compile fields equal the reference's; a supervised
  restart re-seals at 0 unexpected.
- Tensor identity: the tensors a chunk step reads (the KV state or pool,
  the ring and its counts, the positions, the pending tokens) keep their
  ``data_ptr`` from warmup through serving with every plane on, as a CUDA
  graph of the chunk needs on the card.

On the CPU nothing is captured: a watched entry point's first call per
signature is its recorded compile, as a JAX compile on the CPU is.
"""

import collections
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import add_sub as jadd
from client_tpu.models import decoder_lm as jlm
from client_tpu.models import streaming as jstreaming
from client_tpu.models import transformer as jt
from client_tpu.server import TpuInferenceServer
from client_tpu.server import faultinject as jfi
from client_tpu.server import runtime_stats as jrs
from client_tpu.server import trace as jtrace
from client_tpu.server import watchdog as jwd
from client_tpu.server.config import SpeculativeConfig as JSpecConfig
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import make_add_sub
from client_tpu_torch.models import streaming as tstreaming
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server import faultinject as tfi
from client_tpu_torch.server import runtime_stats as trs
from client_tpu_torch.server import trace as ttrace
from client_tpu_torch.server import watchdog as twd
from client_tpu_torch.server.config import SpeculativeConfig as TSpecConfig

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import check_metrics_names  # noqa: E402  (the reference's lint)

SIDES = ("ref", "port")
RS = {"ref": jrs, "port": trs}
TRACE = {"ref": jtrace, "port": ttrace}
FI = {"ref": jfi, "port": tfi}


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    jfi.get_injector().clear()
    tfi.get_injector().clear()


def _table(snap: dict) -> dict:
    """A watch snapshot without its wall seconds."""
    out = {k: v for k, v in snap.items()
           if k not in ("warmup_compile_seconds", "hist")}
    out["compiles"] = [{k: v for k, v in e.items() if k != "seconds"}
                       for e in snap["compiles"]]
    out["hist"] = {kind: (sum(counts), count)
                   for kind, (counts, _s, count) in snap["hist"].items()}
    return out


# ---------------------------------------------------------- CompileWatch

def _case_first_signature(rs, _trace, _caplog):
    watch = rs.CompileWatch("m")
    calls = []
    f = watch.watch("k", lambda *a: calls.append(a) or len(calls))
    f(np.zeros((2, 3), np.float32))
    f(np.zeros((2, 3), np.float32))
    return watch.snapshot(), len(calls)


def _case_novel_shape_dtype_static(rs, _trace, _caplog):
    watch = rs.CompileWatch("m")
    f = watch.watch("k", lambda *a: None)
    f(np.zeros((2,), np.float32))
    f(np.zeros((3,), np.float32))
    f(np.zeros((3,), np.int32))
    f(np.zeros((3,), np.int32), 4)
    f(np.zeros((3,), np.int32), 4)
    return watch.snapshot(), None


def _case_pytree_signature(rs, _trace, _caplog):
    watch = rs.CompileWatch("m")
    f = watch.watch("k", lambda *a: None)
    f({"a": np.zeros((2,), np.int32), "b": [True, 7]}, "s")
    return watch.snapshot(), rs.describe_signature(
        ({"a": np.zeros((2,), np.int32), "b": [True, 7]},))


def _case_sealed_violation(rs, trace_mod, caplog):
    watch = rs.CompileWatch("engine-x")
    f = watch.watch("chunk_kernel", lambda *a: None)
    f(np.zeros((2,), np.float32))
    watch.seal()
    trace = trace_mod.Trace("t1", "m", "1")
    watch.current_trace = trace
    caplog.clear()
    with caplog.at_level("WARNING", logger=rs.__name__):
        f(np.zeros((5,), np.float32))
    warned = [r.getMessage() for r in caplog.records
              if r.name == rs.__name__]
    spans = [(name, {k: v for k, v in fields.items() if k != "seconds"})
             for name, _ns, fields in trace.timestamps
             if name == trace_mod.COMPILE]
    return watch.snapshot(), (len(warned), "unexpected serving-phase "
                              "XLA compile" in warned[0],
                              "engine-x" in warned[0], spans)


def _case_histogram_storm(rs, _trace, _caplog):
    watch = rs.CompileWatch("m")
    f = watch.watch("k", lambda *a: None)
    for i in range(rs.COMPILE_TABLE_CAP + 10):
        f(np.zeros((i + 1,), np.int8))
    snap = watch.snapshot()
    return snap, (len(snap["compiles"]), rs.COMPILE_TABLE_CAP)


def _case_reset_reopens(rs, _trace, _caplog):
    watch = rs.CompileWatch("m")
    f = watch.watch("k", lambda *a: None)
    f(np.zeros((2,)))
    watch.seal()
    watch.reset()
    sealed = watch.sealed
    f(np.zeros((9,)))
    return watch.snapshot(), sealed


WATCH_CASES = {
    "first_signature": _case_first_signature,
    "novel_shape_dtype_static": _case_novel_shape_dtype_static,
    "pytree_signature": _case_pytree_signature,
    "sealed_violation": _case_sealed_violation,
    "histogram_storm": _case_histogram_storm,
    "reset_reopens": _case_reset_reopens,
}


@pytest.mark.parametrize("case", sorted(WATCH_CASES))
def test_compile_watch_cases_match_the_reference(case, caplog):
    got = {}
    for side in SIDES:
        snap, extra = WATCH_CASES[case](RS[side], TRACE[side], caplog)
        got[side] = (_table(snap), extra)
    assert got["port"] == got["ref"]
    table, _extra = got["port"]
    if case == "sealed_violation":
        assert table["unexpected_compiles"] == 1
        assert table["compiles"][-1]["phase"] == "serving"


@pytest.mark.parametrize("shape", [(16, 12, 64), (), (3,), (2, 0, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "bool",
                                   "int8"])
def test_describe_signature_of_tensors_is_the_references(dtype, shape):
    j = jnp.zeros(shape, getattr(jnp, dtype))
    t = torch.zeros(shape, dtype=getattr(torch, dtype))
    want = jrs.describe_signature(({"x": j, "n": 3}, [j], True))
    got = trs.describe_signature(({"x": t, "n": 3}, [t], True))
    assert got == want
    assert trs.signature_key((t,)) == trs.signature_key((t.clone(),))


def test_capture_disabled_is_decided_when_a_watch_is_made():
    with trs.capture_disabled():
        assert not trs.capture_enabled()
        inside = trs.CompileWatch("m")
        with trs.capture_disabled():
            pass
        assert not trs.capture_enabled()
    assert trs.capture_enabled()
    assert not inside.graphs and trs.CompileWatch("m").graphs
    # a watch made inside runs a captured entry point eagerly for its life
    calls = []
    f = inside.watch("k", lambda x: calls.append(x) or x + 1,
                     capture=trs.capture_inputs(lambda x: x, (0,), "cpu"))
    assert f(torch.zeros(2)).tolist() == [1.0, 1.0]
    assert f(torch.ones(2)).tolist() == [2.0, 2.0]
    assert len(calls) == 2 and inside.captured() == 0
    assert inside.snapshot()["total_compiles"] == 1


# --------------------------------------------------------------- models

def _add_sub(side, **kw):
    if side == "ref":
        return jadd.make_add_sub("m", 4, "INT32", **kw)
    return make_add_sub("m", 4, "INT32", device="cpu", **kw)


def _kinds(snap: dict) -> dict:
    return dict(sorted(collections.Counter(
        (e["kind"], e["phase"]) for e in snap["compiles"]).items()))


def _counts(snap: dict) -> tuple:
    return (snap["sealed"], snap["total_compiles"],
            snap["unexpected_compiles"], snap["warmup_compiles"])


@pytest.mark.parametrize("batching", [dict(),
                                      dict(max_batch_size=8,
                                           dynamic_batching=True)],
                         ids=["no_batch", "dynamic"])
def test_torch_model_compile_table_matches_the_jax_model(batching):
    got = {}
    x = np.arange(4, dtype=np.int32)
    for side in SIDES:
        m = _add_sub(side, **batching)
        m.load()
        m.warmup()
        warm = m.compile_watch.snapshot()
        b = m.config.batch_buckets()
        for rows in (b or (0,)):
            inp = np.repeat(x[None], rows, 0) if rows else x
            m.execute({"INPUT0": inp, "INPUT1": inp})
        if b:
            part = m.device_put_inputs({"INPUT0": x[None],
                                        "INPUT1": x[None]})
            m.execute_parts_fused([part] * 3, 4)
            m.execute_parts_fused_split([part], 2)
        served = m.compile_watch.snapshot()
        rt = m.runtime_observability()
        m.unload()
        got[side] = (_kinds(warm), _counts(warm), _kinds(served),
                     _counts(served), sorted(rt),
                     _counts(m.compile_watch.snapshot()))
    assert got["port"] == got["ref"]
    warm_kinds, warm_counts, _, served_counts, _, unloaded = got["port"]
    assert warm_counts == served_counts and warm_counts[0]
    assert unloaded == (False, 0, 0, 0)
    want = 4 if batching else 1
    assert warm_kinds[("apply", "warmup")] == want


def test_a_forced_compile_after_the_seal_counts_warns_and_stamps(caplog):
    got = {}
    x = np.arange(4, dtype=np.int32)
    for side in SIDES:
        m = _add_sub(side, max_batch_size=8, dynamic_batching=True)
        m.load()
        m.warmup()
        trace = TRACE[side].Trace("t1", "m", "1")
        m.compile_watch.current_trace = trace
        caplog.clear()
        with caplog.at_level("WARNING", logger=RS[side].__name__):
            m.execute({"INPUT0": np.repeat(x[None], 3, 0),
                       "INPUT1": np.repeat(x[None], 3, 0)})
        warned = [r.getMessage() for r in caplog.records
                  if r.name == RS[side].__name__]
        spans = [fields["kernel"] for name, _ns, fields in trace.timestamps
                 if name == TRACE[side].COMPILE]
        snap = m.compile_watch.snapshot()
        got[side] = (_counts(snap), snap["compiles"][-1]["phase"],
                     snap["compiles"][-1]["signature"], len(warned), spans)
    assert got["port"] == got["ref"]
    assert got["port"][0] == (True, 13, 1, 12)
    assert got["port"][3:] == (1, ["apply"])


def test_sequence_model_is_watched_and_never_sealed():
    got = {}
    for side in SIDES:
        mod = jstreaming if side == "ref" else tstreaming
        kw = {} if side == "ref" else {"device": "cpu"}
        m = mod.make_accumulator("acc", **kw)
        m.load()
        m.warmup()
        state = m.init_state()
        for v in (1, 2, 3):
            _out, state = m.step({"INPUT": np.array([v], np.int32)}, state)
        snap = m.compile_watch.snapshot()
        got[side] = (_kinds(snap), _counts(snap))
        m.unload()
    assert got["port"] == got["ref"]
    assert got["port"][1][0] is False and got["port"][1][1] >= 1


# --------------------------------------------------------------- engines

KW = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, head_dim=16,
          d_ff=128, max_seq=64, causal=True)
PAGED = dict(kv_layout="paged", kv_block_len=8, prefix_block_len=8)
DRAFT = {"n_layers": 1, "d_model": 32, "n_heads": 2, "head_dim": 16,
         "d_ff": 64}
LANES = dict(prefill_mode="chunked", prefill_chunk=8, prefill_slots=2,
             prefill_lane_width=8, prefill_lane_batch=2)
ENGINES = {
    "slot": {},
    "paged": dict(PAGED),
    "prefix_slot": dict(prefix_cache=True, prefix_block_len=8),
    "prefix_paged": dict(prefix_cache=True, **PAGED),
    "chunked_slot": dict(prefill_mode="chunked", prefill_chunk=16),
    "chunked_paged": dict(prefill_mode="chunked", prefill_chunk=16, **PAGED),
    "batched_prefill": dict(prefill_mode="batched"),
    "lanes_slot": dict(prefix_cache=True, prefix_block_len=8, **LANES),
    "lanes_paged": dict(prefix_cache=True, scheduler=True,
                        kv_pool_blocks=24, **LANES, **PAGED),
    "speculation_slot": dict(draft=True),
    "speculation_paged": dict(draft=True, **PAGED),
    "int8_kv": dict(kv_quant=True),
    "int8_kv_paged": dict(kv_quant=True, **PAGED),
    "host_tier": dict(prefix_cache=True, host_tier_bytes=1 << 20, **PAGED),
}
PROMPTS = [(np.arange(n, dtype=np.int32) * 7 + n) % 60 + 1
           for n in (3, 11, 20, 33)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    return jparams, tparams


def _gen(side, weights, name="lm", **knobs):
    jparams, tparams = weights
    knobs = dict(knobs)
    draft = knobs.pop("draft", False)
    quant = knobs.pop("kv_quant", False)
    if side == "ref":
        cfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref",
                                   kv_quant=quant, **KW)
        if draft:
            knobs["speculative_draft"] = JSpecConfig(enabled=True, gamma=2,
                                                     draft=DRAFT)
        return jlm.make_continuous_generator(
            name, cfg=cfg, params=dict(jparams), n_slots=2, chunk_size=4,
            **knobs)
    cfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash",
                               kv_quant=quant, **KW)
    if draft:
        knobs["speculative_draft"] = TSpecConfig(enabled=True, gamma=2,
                                                 draft=DRAFT)
    return tlm.make_continuous_generator(
        name, cfg=cfg, params=tparams, n_slots=2, chunk_size=4,
        device="cpu", **knobs)


def _engine_kinds(snap: dict) -> tuple:
    return (dict(sorted(collections.Counter(
        e["kind"] for e in snap["compiles"]).items())),
        snap["sealed"], snap["unexpected_compiles"])


@pytest.mark.parametrize("config", sorted(ENGINES))
def test_engine_compile_counts_match_the_reference(weights, config):
    got = {}
    for side in SIDES:
        gen = _gen(side, weights, **ENGINES[config])
        try:
            list(gen.engine.submit(np.array([1, 2], np.int32), 2))
            warm = _engine_kinds(gen.engine.compile_watch.snapshot())
            toks = [list(gen.engine.submit(p, 6)) for p in PROMPTS * 2]
            served = _engine_kinds(gen.engine.compile_watch.snapshot())
        finally:
            gen.shutdown()
        got[side] = (warm, served, toks)
    assert got["port"] == got["ref"]
    warm, served, _ = got["port"]
    assert warm == served and warm[1] and warm[2] == 0
    if config == "slot":
        # the reference's test_warmup_seals_and_serving_stays_compile_free
        assert warm[0] == {"chunk_kernel": 1, "chunk_kernel_greedy": 1}


def test_engine_runtime_snapshot_carries_the_compile_table(weights):
    got = {}
    for side in SIDES:
        gen = _gen(side, weights, **PAGED)
        try:
            list(gen.engine.submit(PROMPTS[1], 4))
            rt = gen.runtime_observability()
            ev = gen.engine._incident_evidence("stall", {})
            sig = gen.engine._watchdog_signals()
        finally:
            gen.shutdown()
        got[side] = (sorted(rt), _engine_kinds(rt), ev["compile"],
                     sig["unexpected_compiles"])
    assert got["port"] == got["ref"]
    assert got["port"][2] == {"sealed": True, "total_compiles": 8,
                              "unexpected_compiles": 0}


def test_the_watchdog_compile_violation_fires_on_a_real_engine(weights):
    got = {}
    for side in SIDES:
        wd_mod = jwd if side == "ref" else twd
        gen = _gen(side, weights)
        try:
            eng = gen.engine
            list(eng.submit(PROMPTS[0], 4))
            wd = wd_mod.Watchdog(engine="lm", store=wd_mod.IncidentStore(),
                                 interval_s=0.0)
            before = wd.observe(1, eng._watchdog_signals())
            # a serving-phase compile: a novel signature after the seal
            eng.compile_watch.watch("probe", lambda x: x)(np.zeros(7))
            fired = wd.observe(2, eng._watchdog_signals())
        finally:
            gen.shutdown()
        got[side] = ([f["detector"] for f in before],
                     [(f["detector"], f["breach"]) for f in fired],
                     eng.compile_watch.unexpected)
    assert got["port"] == got["ref"]
    assert got["port"][1] == [("compile_violation",
                               {"unexpected_compiles": 1, "new": 1})]


def test_metrics_carry_the_runtime_families_of_the_reference(weights):
    got = {}
    for side in SIDES:
        core = TpuInferenceServer() if side == "ref" \
            else TorchInferenceServer()
        try:
            gen = _gen(side, weights, **PAGED)
            core.register_model(gen)
            m = _add_sub(side, max_batch_size=8, dynamic_batching=True)
            core.register_model(m, warmup=True)
            list(gen.engine.submit(PROMPTS[2], 5))
            # one serving-phase compile on the add_sub model
            x = np.zeros((3, 4), np.int32)
            m.execute({"INPUT0": x, "INPUT1": x})
            text = core.metrics_text()
        finally:
            core.stop()
        parsed = jm_parse(text) if side == "ref" else tm_parse(text)
        got[side] = (text, sorted(
            (n, sorted(lab.items()), v) for n, lab, v in parsed["samples"]
            if n.startswith("client_tpu_runtime_")
            and not n.startswith("client_tpu_runtime_compile_seconds")
            and "warmup_compile_seconds" not in n),
            sorted(f for f in parsed["families"]
                   if f.startswith("client_tpu_runtime_")))
    assert check_metrics_names.check(got["port"][0]) == []
    assert got["port"][1:] == got["ref"][1:]
    samples = dict(((n, tuple(lab)), v) for n, lab, v in got["port"][1])
    assert samples[("client_tpu_runtime_unexpected_compiles_total",
                    (("model", "m"), ("version", "1")))] == 1


def jm_parse(text):
    from client_tpu.server import metrics as jm

    return jm.parse_prometheus_text(text)


def tm_parse(text):
    from client_tpu_torch.server import metrics as tm

    return tm.parse_prometheus_text(text)


FLEET_KNOBS = dict(kv_layout="paged", kv_block_len=8, prefill_mode="chunked",
                   prefill_chunk=16, max_new_tokens=6)


def _fleet(side, weights, **kw):
    jparams, tparams = weights
    if side == "ref":
        cfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
        return jlm.make_replica_fleet("fl", cfg=cfg, params=dict(jparams),
                                      n_slots=2, chunk_size=4,
                                      **FLEET_KNOBS, **kw)
    cfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="ref", **KW)
    return tlm.make_replica_fleet("fl", cfg=cfg, params=tparams, n_slots=2,
                                  chunk_size=4, device="cpu", **FLEET_KNOBS,
                                  **kw)


def test_fleet_compile_fields_match_the_reference(weights):
    got = {}
    for side in SIDES:
        m = _fleet(side, weights, replicas=2)
        try:
            toks = [list(m.fleet.submit(p, 6)) for p in PROMPTS]
            m.fleet.replicas[1].engine.compile_watch.watch(
                "probe", lambda x: x)(np.zeros(5))
            rows = [r["unexpected_compiles"]
                    for r in m.fleet_snapshot()["rows"]]
            rt = m.runtime_observability()
        finally:
            m.shutdown()
        got[side] = (toks, rows, {k: rt[k] for k in (
            "sealed", "total_compiles", "unexpected_compiles",
            "warmup_compiles", "compiles")},
            {kind: count for kind, (_c, _s, count) in rt["hist"].items()})
    assert got["port"] == got["ref"]
    assert got["port"][1] == [0, 1]
    assert got["port"][2]["unexpected_compiles"] == 1


def test_autoscale_scale_down_reads_the_victims_compiles(weights):
    got = {}
    for side in SIDES:
        m = _fleet(side, weights, replicas=2, autoscale=dict(
            min_replicas=1, max_replicas=2, queue_high=100, queue_low=0,
            burn_high=100.0, burn_low=50.0, hold_rounds=1, idle_rounds=1,
            cooldown_s=0.0, interval_s=0.0))
        try:
            for p in PROMPTS[:2]:
                list(m.fleet.submit(p, 4))
            for rep in m.fleet.replicas:
                rep.engine.compile_watch.watch("probe", lambda x: x)(
                    np.zeros(3))
            decisions = []
            end = time.time() + 30
            while not any(d["action"] == "scale_down" for d in decisions):
                assert time.time() < end, decisions
                decisions += m.autoscaler.step()
        finally:
            m.shutdown()
        down = next(d for d in decisions if d["action"] == "scale_down")
        got[side] = (down["unexpected_compiles"], down["replica"])
    assert got["port"] == got["ref"]
    assert got["port"][0] == 1


def test_a_supervised_restart_reseals_at_zero_unexpected(weights):
    got = {}
    for side in SIDES:
        gen = _gen(side, weights, supervision={"backoff_base_s": 0.02,
                                               "max_failures": 5}, **PAGED)
        sup = gen.engine_supervisor
        try:
            first = list(gen.engine.submit(PROMPTS[2], 8))
            before = _engine_kinds(gen.engine.compile_watch.snapshot())
            dead = gen.engine
            FI[side].get_injector().arm([{"point": "engine_loop",
                                          "after": 1, "times": 1}])
            with pytest.raises(Exception):
                list(dead.submit(PROMPTS[2], 8))
            FI[side].get_injector().clear()
            end = time.time() + 60
            while not (sup.healthy() and sup.restarts == 1):
                assert time.time() < end, "no restart"
                time.sleep(0.01)
            again = list(gen.engine.submit(PROMPTS[2], 8))
            after = _engine_kinds(gen.engine.compile_watch.snapshot())
            fresh = gen.engine is not dead
        finally:
            gen.shutdown()
        got[side] = (first, again, before, after, fresh)
    assert got["port"] == got["ref"]
    first, again, before, after, fresh = got["port"]
    assert first == again and before == after and fresh
    assert after[1] and after[2] == 0


# ------------------------------------------------------- tensor identity

IDENTITY = {
    "paged_every_plane": dict(
        prefix_cache=True, host_tier_bytes=1 << 16, scheduler=True,
        kv_pool_blocks=40, draft=True, **LANES, **PAGED),
    "slot_every_plane": dict(prefix_cache=True, prefix_block_len=8,
                             draft=True, kv_quant=True, **LANES),
}


@pytest.mark.parametrize("config", sorted(IDENTITY))
def test_chunk_step_tensors_keep_their_storage_through_serving(weights,
                                                               config):
    gen = _gen("port", weights, **IDENTITY[config])
    eng = gen.engine
    try:
        list(eng.submit(np.array([1, 2], np.int32), 2))
        held = eng._graph_state()
        ptrs = [t.data_ptr() for t in held[1:]]
        long = [(np.arange(40, dtype=np.int32) * (i + 3)) % 60 + 1
                for i in range(3)]
        streams = [eng.submit(p, 12, temperature=0.7 if i % 2 else 0.0,
                              seed=i)
                   for i, p in enumerate(long + PROMPTS * 2)]
        toks = [list(s) for s in streams]
        now = eng._graph_state()
        stats = eng.stats()
        snap = eng.compile_watch.snapshot()
    finally:
        gen.shutdown()
    assert all(len(t) == 12 for t in toks)
    assert all(a is b for a, b in zip(now, held))
    assert [t.data_ptr() for t in now[1:]] == ptrs
    assert stats["chunks_dispatched"] > 0
    assert snap["sealed"] and snap["unexpected_compiles"] == 0
    if "draft" in IDENTITY[config]:
        assert stats["speculation"]["rounds"] > 0


def test_a_rebound_state_tensor_is_refused_by_the_chunk_capture(weights):
    """The chunk graph's feed holds every tensor it reads by identity: a
    rebound one raises instead of leaving a graph on freed memory."""
    gen = _gen("port", weights, **PAGED)
    eng = gen.engine
    try:
        list(eng.submit(PROMPTS[0], 2))
        packed = torch.zeros(4, dtype=torch.int32)
        _run, feed = eng._chunk_capture(lambda *a: None).bind(packed, ())
        feed(packed, ())
        eng._dev["last"] = eng._dev["last"].clone()
        with pytest.raises(RuntimeError, match="rebound"):
            feed(torch.zeros(4, dtype=torch.int32), ())
    finally:
        gen.shutdown()
