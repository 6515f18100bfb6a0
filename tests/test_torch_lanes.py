"""The port's dedicated prefill lanes (``prefill_slots``,
``prefill_lane_width``, ``prefill_lane_batch``) on the CPU, held against the
JAX package's engine (the groups of tests/test_disagg_lanes.py).

- Validation: the same errors from the same resolvers, in the engine and
  in the generator.
- Identity: greedy streams equal to the JAX lane engine's on the paged
  layout (with shared-prefix hits, the handoff a table move: no
  ``pool_to_slot``/``slot_to_pool`` call) and on the slot layout (the
  handoff through the prefix pool's commit and restore), per-slot and
  batched; a prompt within one lane bucket of max_seq; with speculation
  (the streams of the plain lane); seeded sampling equal to the piggyback
  lane's. The decode chunks never carry a prefill rider.
- Hygiene: cancel and deadline while a prompt is in a lane slot, engine
  death, and ``stop`` leave no slot, lane slot, pin, stream block or
  reservation behind.
- The lane with the host tier, the generator's config block, and the two
  batched chunk functions (``prefill_chunk_batch``,
  ``paged_prefill_chunk_batch``) against the reference's with ragged
  offsets and lengths and a padding row, in f32 and under int8 KV.

Tolerance: tokens, counters, errors and config blocks exact; the batched
chunks' logits and rows 1e-5 (f32), int8 as tests/test_torch_kv_quant.py
states it.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import decoder_lm as jlm
from client_tpu.models import transformer as jt
from client_tpu.perf import bench_harness as jbh
from client_tpu.server.generation import (
    ContinuousBatchingEngine as JaxEngine,
)
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.perf import bench_harness as tbh
from client_tpu_torch.server import generation as tgen
from client_tpu_torch.server.generation import ContinuousBatchingEngine
from client_tpu_torch.server.speculation import DraftModel
from client_tpu_torch.server.types import ServerError, now_ns

TOL = 1e-5
FLIP_TOL = 1e-3
KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=64, causal=True)
PAGED = dict(kv_layout="paged", kv_block_len=8, prefix_cache=True,
             prefix_block_len=8)
SLOT = dict(prefix_cache=True, prefix_block_len=8, prefix_blocks=64)
LANE = dict(prefill_mode="chunked", prefill_chunk=16, prefill_slots=2,
            prefill_lane_width=16)
PIGGY = dict(prefill_mode="chunked", prefill_chunk=16)
LAYOUTS = {"paged": PAGED, "slot": SLOT}

RNG = np.random.default_rng(31)
# ragged prompts spanning direct decode (<= chunk), one lane bucket and
# several lane chunks (the reference's jobs)
JOBS = [(RNG.integers(0, 64, size=p).astype(np.int32), b)
        for p, b in ((37, 8), (3, 5), (50, 6), (12, 12), (29, 4),
                     (5, 7), (44, 3), (21, 9))]
BASE = RNG.integers(0, 64, size=40).astype(np.int32)
# paged: two prompts that share 32 tokens with the first (prefix hits)
SHARED = [(BASE, 6), (np.concatenate([BASE[:32], [9, 9, 9]]).astype(
    np.int32), 6), (BASE, 6)]
# a prompt one token short of max_seq
EDGE = [(RNG.integers(0, 64, size=63).astype(np.int32), 1)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    return jcfg, jparams, tcfg, tparams


def _engine(side, weights, **kw):
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(n_slots=2, chunk=4, **kw)
    if side == "ref":
        return JaxEngine(jcfg, dict(jparams), **kw).start()
    return ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                    **kw).start()


def _run(eng, jobs, **submit_kw):
    mod = jbh if isinstance(eng, JaxEngine) else tbh
    _, _, toks = mod.run_engine_jobs(eng, jobs, collect=True,
                                     join_timeout_s=120, **submit_kw)
    return toks


def _serve(side, weights, jobs, sequential=False, **kw):
    """Serve ``jobs`` (together, or one after another) and return the
    streams with the engine's handoffs and prefix hits."""
    eng = _engine(side, weights, **kw)
    try:
        if sequential:
            toks = [list(eng.submit(p, b)) for p, b in jobs]
        else:
            toks = _run(eng, jobs)
        lane = eng.stats()["prefill_lane"]
        return {"tokens": toks, "handoffs": lane and lane.get("handoffs"),
                "prefix_hits": eng.gen_stats.snapshot()["prefix_hits"]}
    finally:
        eng.stop()


def _lane_jobs(layout):
    return JOBS + (SHARED if layout == "paged" else [])


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX lane engine's streams, per layout: the jobs together, and
    the edge prompt with a 5-token lane budget."""
    out = {}
    for layout, kw in LAYOUTS.items():
        out[layout] = _serve("ref", weights, _lane_jobs(layout),
                             **LANE, **kw)
        out[f"{layout}_edge"] = _serve("ref", weights, EDGE,
                                       prefill_token_budget=5, **LANE, **kw)
    return out


def _routed(layout, jobs):
    """The jobs the lane takes: prompts longer than a chunk, and under
    the slot layout with a full block to hand off."""
    return sum(1 for p, _ in jobs if len(p) > 4
               and (layout == "paged" or (len(p) - 1) // 8 > 0))


class _Copies:
    """Counts the engine's pool<->slot copies."""

    def __init__(self, monkeypatch):
        self.n = {"pool_to_slot": 0, "slot_to_pool": 0}
        for name in self.n:
            real = getattr(tgen, name)

            def counted(*a, _real=real, _name=name, **k):
                self.n[_name] += 1
                return _real(*a, **k)

            monkeypatch.setattr(tgen, name, counted)


# ------------------------------------------------------------ validation

def _both_raise(call_port, call_ref):
    with pytest.raises(ValueError) as got:
        call_port()
    with pytest.raises(ValueError) as want:
        call_ref()
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("case", [
    dict(prefill_slots=2, **PAGED),
    dict(prefill_mode="chunked", prefill_slots=2),
    dict(prefill_mode="chunked", prefill_slots=2, prefix_cache=True,
         prefix_block_len=8, prefix_commit_policy="none"),
    dict(prefill_slots=-1),
    dict(prefill_slots=1, prefill_lane_width=65, **PIGGY, **PAGED),
    dict(prefill_lane_batch=2, **PIGGY, **PAGED),
    dict(prefill_lane_batch=-1, **PIGGY),
], ids=["needs_chunked", "slot_needs_prefix_cache",
        "slot_needs_writable_policy", "negative_slots", "width_bound",
        "batch_needs_lane", "negative_batch"])
def test_lane_knobs_refused_like_the_reference(weights, case):
    """The reference's validation cases: the same error text from the
    engine and from the generator."""
    jcfg, jparams, tcfg, tparams = weights
    _both_raise(
        lambda: ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                         **case),
        lambda: JaxEngine(jcfg, dict(jparams), **case))
    _both_raise(
        lambda: tlm.make_continuous_generator("lm", cfg=tcfg,
                                              params=tparams, device="cpu",
                                              **case),
        lambda: jlm.make_continuous_generator("lm", cfg=jcfg,
                                              params=dict(jparams), **case))


def test_lane_resolvers_match_the_reference(weights):
    jcfg, _, tcfg, _ = weights
    for args in (("token", 0, 0, 64, "slot", False, "all"),
                 ("chunked", 3, 0, 16, "paged", False, "all"),
                 ("chunked", 2, 24, 16, "slot", True, "no-evict")):
        assert ContinuousBatchingEngine.resolve_disagg(tcfg, *args) \
            == JaxEngine.resolve_disagg(jcfg, *args)
    for slots, batch in ((0, 0), (0, 1), (3, 2), (3, 8), (4, 1)):
        assert ContinuousBatchingEngine.resolve_lane_batch(slots, batch) \
            == JaxEngine.resolve_lane_batch(slots, batch)


# -------------------------------------------------------------- identity

@pytest.mark.parametrize("batch", [0, 2], ids=["per_slot", "batched"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_streams_equal_the_jax_lane_engine(weights, reference,
                                                  monkeypatch, layout,
                                                  batch):
    """Every stream equal to the JAX lane engine's; every routed prompt
    handed off once; on the paged layout prefix hits and not one
    pool<->slot copy (the handoff moves the table), on the slot layout a
    commit from the lane's rows per handoff."""
    copies = _Copies(monkeypatch)
    jobs = _lane_jobs(layout)
    got = _serve("port", weights, jobs, prefill_lane_batch=batch,
                 **LANE, **LAYOUTS[layout])
    want = reference[layout]
    assert got["tokens"] == want["tokens"]
    assert got["handoffs"] == want["handoffs"] == _routed(layout, jobs)
    if layout == "paged":
        assert copies.n == {"pool_to_slot": 0, "slot_to_pool": 0}
        assert got["prefix_hits"] > 0
    else:
        assert copies.n["slot_to_pool"] >= got["handoffs"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_a_prompt_near_max_seq_hands_off_its_tail(weights, reference,
                                                  layout):
    """63 tokens at max_seq 64 with a 5-token lane budget: the lane stops
    where no bucket fits (paged) or at the last full block (slot), and the
    decode slot feeds the rest token by token, as the reference does."""
    got = _serve("port", weights, EDGE, prefill_token_budget=5, **LANE,
                 **LAYOUTS[layout])
    assert got == reference[f"{layout}_edge"]
    assert got["handoffs"] == 1


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_lane_with_speculation_keeps_the_greedy_streams(weights, reference,
                                                        layout):
    """A self-draft on lane-fed slots (the draft catches up on the decode
    slot after the handoff): the streams of the JAX lane engine without
    speculation, every proposal accepted."""
    _, _, tcfg, tparams = weights
    eng = _engine("port", weights, speculative_draft=DraftModel(
        tcfg, tparams), speculative_gamma=2, **LANE, **LAYOUTS[layout])
    try:
        toks = [list(eng.submit(p, b)) for p, b in JOBS[:4]]
        spec = eng.stats()["speculation"]
    finally:
        eng.stop()
    assert toks == reference[layout]["tokens"][:4]
    assert spec["rounds"] > 0 and spec["accepted"] == spec["proposed"]


def test_seeded_sampling_equals_the_piggyback_lane(weights):
    """Sampling noise is keyed by position, so the dedicated lane (per
    slot and batched) reproduces the piggyback lane's sampled streams."""
    runs = []
    for kw in (PIGGY, LANE, dict(LANE, prefill_lane_batch=2)):
        eng = _engine("port", weights, **kw, **PAGED)
        try:
            runs.append(_run(eng, JOBS[:5], temperature=0.8, top_k=8,
                             seed=7))
        finally:
            eng.stop()
    assert runs[0] == runs[1] == runs[2]


def test_decode_chunks_never_carry_prefill_passengers(weights):
    """With the dedicated lane no decode slot is ever in the lane (no
    frozen prompt rider in a decode chunk), even for a long prompt."""
    eng = _engine("port", weights, **LANE, **PAGED)
    modes = []
    real = eng._slot_modes

    def spy():
        got = real()
        modes.extend(got[0])
        return got

    eng._slot_modes = spy
    try:
        _run(eng, JOBS)
        assert eng._lane_on and "prefill" not in modes and "chunk" in modes

        class _R:
            prompt = np.arange(30, dtype=np.int32)

        assert not eng._in_lane(eng._slots[0], _R())
    finally:
        eng.stop()


# --------------------------------------------------------------- hygiene

def _slow(eng, delay=0.05):
    """Pace the engine: each dispatch round sleeps first (the reference's
    kernel_delay fault)."""
    real = eng._dispatch

    def slow():
        time.sleep(delay)
        return real()

    eng._dispatch = slow


def _wait(pred, timeout=30.0):
    end = time.time() + timeout
    while time.time() < end:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _clean(eng) -> None:
    """No slot of either kind, pin, stream block or reservation left."""
    assert _wait(lambda: eng.active_slots() == 0
                 and eng.active_lane_slots() == 0)
    assert eng._prefix_index.pinned_nodes() == 0
    if eng._paged:
        occ = eng._kv_index.occupancy()
        assert occ["stream"] == 0 and occ["reserved"] == 0, occ


LONG = RNG.integers(0, 64, size=50).astype(np.int32)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cancel_mid_ingestion_frees_everything(weights, layout):
    eng = _engine("port", weights, prefill_token_budget=8, **LANE,
                  **LAYOUTS[layout])
    _slow(eng)
    cancel, out = threading.Event(), []

    def consume():
        try:
            out.extend(eng.submit(LONG, 8, cancel_event=cancel))
        except ServerError as e:
            out.append(e.status)

    th = threading.Thread(target=consume)
    th.start()
    try:
        assert _wait(lambda: eng.active_lane_slots() == 1)
        # the slot tables show the prompt in a lane slot, none decoding
        stats = eng.stats()
        held = [r for r in stats["lane_slots"] if r["active"]]
        assert len(held) == 1 and held[0]["prompt_tokens"] == len(LONG)
        assert held[0]["emitted"] == 0
        assert stats["prefill_lane"]["active"] == 1
        cancel.set()
        th.join(60)
        assert out == [499]
        _clean(eng)
        assert eng.gen_stats.snapshot()["cancelled"] == 1
    finally:
        cancel.set()
        eng.stop()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_deadline_mid_ingestion_is_504_and_leak_free(weights, layout):
    eng = _engine("port", weights, prefill_token_budget=8, **LANE,
                  **LAYOUTS[layout])
    _slow(eng)
    try:
        with pytest.raises(ServerError) as err:
            list(eng.submit(LONG, 8, deadline_ns=now_ns() + int(0.15e9)))
        assert err.value.status == 504
        _clean(eng)
        # the engine still serves
        assert len(list(eng.submit(JOBS[0][0], 3))) == 3
    finally:
        eng.stop()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_death_fails_lane_residents(weights, layout):
    """A loop fault while a prompt sits in a lane slot answers it with
    the error (the lane walk of ``_fail_all``) and frees its slot and,
    paged, its blocks."""
    eng = _engine("port", weights, prefill_token_budget=8, **LANE,
                  **LAYOUTS[layout])
    real = eng._dispatch_lane_dedicated
    calls = []

    def faulty():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected fault")
        return real()

    eng._dispatch_lane_dedicated = faulty
    try:
        with pytest.raises(RuntimeError, match="injected fault"):
            list(eng.submit(LONG, 8))
        assert eng._failed is not None
        assert eng.active_lane_slots() == 0 and eng.active_slots() == 0
        assert eng._prefix_index.pinned_nodes() == 0
        if eng._paged:
            assert eng._kv_index.occupancy()["stream"] == 0
    finally:
        eng.stop()


def test_stop_closes_lane_residents(weights):
    eng = _engine("port", weights, prefill_token_budget=8, **LANE, **PAGED)
    _slow(eng)
    out = []

    def consume():
        try:
            out.extend(eng.submit(LONG, 8))
            out.append(None)
        except ServerError as e:
            out.append(e.status)

    th = threading.Thread(target=consume)
    th.start()
    assert _wait(lambda: eng.active_lane_slots() == 1)
    eng.stop()
    th.join(60)
    assert not th.is_alive()
    assert out[-1] in (None, 503)
    assert eng.active_lane_slots() == 0
    occ = eng._kv_index.occupancy()
    assert occ["stream"] == 0 and occ["reserved"] == 0


# ---------------------------------------------- the tier and the config

def test_lane_with_the_host_tier_matches_the_jax_engine(weights):
    """Three 41-token families through a 14-block pool with a tier, the
    first again last: its chain restores from the tier ahead of its first
    lane chunk, and the streams, spills, restores and tier hits are the
    JAX engine's."""
    fams = [((np.arange(0, 41) + off) % 64).astype(np.int32)
            for off in (0, 7, 19, 0)]
    runs = {}
    for side in ("ref", "port"):
        eng = _engine(side, weights, kv_pool_blocks=14,
                      host_tier_bytes=1 << 22, **LANE, **PAGED)
        try:
            toks = [list(eng.submit(p, 8)) for p in fams]
            tier = eng._kv_index.tier_snapshot()
            runs[side] = (toks, tier["spills"], tier["restores"],
                          eng.gen_stats.snapshot()["tier_hits"],
                          eng.stats()["prefill_lane"]["handoffs"])
        finally:
            eng.stop()
    assert runs["port"] == runs["ref"]
    assert runs["port"][1] > 0 and runs["port"][3] > 0


@pytest.mark.parametrize("case", ["paged", "slot", "batched", "off"])
def test_generator_advertises_the_lane_like_the_reference(weights, case):
    jcfg, jparams, tcfg, tparams = weights
    kw = {"paged": dict(LANE, **PAGED), "slot": dict(LANE, **SLOT),
          "batched": dict(LANE, prefill_lane_batch=8, **PAGED),
          "off": dict(PIGGY)}[case]
    kw = dict(n_slots=2, chunk_size=4, **kw)
    ref = jlm.make_continuous_generator("lm", cfg=jcfg, params=dict(jparams),
                                        **kw)
    port = tlm.make_continuous_generator("lm", cfg=tcfg, params=tparams,
                                         device="cpu", **kw)
    want, got = ref.config.to_json(), port.config.to_json()
    ref.engine.stop()
    port.engine.stop()
    engine = got["generation_engine"]
    assert engine == {k: want["generation_engine"][k] for k in engine}
    assert engine["prefill_slots"] == (0 if case == "off" else 2)
    assert engine["prefill_lane_batch"] == (2 if case == "batched" else 0)


# ----------------------------------------------- the batched chunk functions

BATCH_CONFIGS = {
    "mha": dict(KW),
    "gqa": dict(KW, n_heads=4, n_kv_heads=2, head_dim=8, ffn="swiglu"),
    "rope": dict(KW, rope=True),
}


@pytest.fixture(scope="module",
                params=[(c, q) for c in sorted(BATCH_CONFIGS)
                        for q in (False, True)],
                ids=lambda p: f"{p[0]}-{'int8' if p[1] else 'f32'}")
def batch_model(request):
    name, quant = request.param
    kw = dict(BATCH_CONFIGS[name], kv_quant=quant)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **kw)
    jparams = jt.init_params(jax.random.key(3), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **kw)
    return jcfg, jparams, tcfg, tparams


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _rows_close(got: dict, want: dict, quant: bool, sl=(slice(None),)):
    """KV rows of both sides: f32 within 1e-5; int8 values equal, or one
    step apart where the row's scale differs by an ulp, scales within 1e-5
    relative. Returns the int8 values one step apart."""
    if not quant:
        for name in want:
            np.testing.assert_allclose(_np(got[name])[sl],
                                       _np(want[name])[sl], rtol=0,
                                       atol=TOL)
        return 0
    steps = 0
    for name in ("k", "v"):
        gq = _np(got[name])[sl].astype(np.int32)
        wq = _np(want[name])[sl].astype(np.int32)
        gs, ws = _np(got[f"{name}_scale"])[sl], _np(want[f"{name}_scale"])[sl]
        np.testing.assert_allclose(gs, ws, rtol=TOL, atol=0)
        diff = np.abs(gq - wq)
        assert diff.max(initial=0) <= 1
        assert not (diff.astype(bool) & (gs == ws)[..., None]).any()
        steps += int(diff.sum())
    return steps


def _batch_inputs(vocab, rng):
    """Three real rows resuming at ragged offsets with ragged lengths in a
    bucket of 16, and one padding row (offset 0, one real token, as the
    engine pads)."""
    pos0 = np.asarray([0, 8, 21, 0], np.int32)
    clen = np.asarray([16, 5, 11, 1], np.int32)
    toks = rng.integers(0, vocab, size=(4, 16)).astype(np.int32)
    for r, c in enumerate(clen):
        toks[r, c:] = 0
    toks[3] = 0
    return toks, pos0, clen


def _random_kv(names, shape, rng, quant: bool) -> dict:
    out = {}
    for name in names:
        if name.endswith("_scale"):
            out[name] = rng.uniform(0.001, 0.05, shape[:-1]).astype(
                np.float32)
        elif quant:
            out[name] = rng.integers(-127, 128, shape).astype(np.int8)
        else:
            out[name] = rng.standard_normal(shape).astype(np.float32)
    return out


def test_prefill_chunk_batch_matches_the_reference(batch_model):
    """Logits of the real rows within the tolerance; their slabs written
    into the port's cache in place, every other row of theirs untouched;
    the padding row writes only its scratch row (row 3 here)."""
    jcfg, jparams, tcfg, tparams = batch_model
    rng = np.random.default_rng(6)
    toks, pos0, clen = _batch_inputs(jcfg.vocab_size, rng)
    shape = (4, jcfg.n_layers, jcfg.max_seq, jcfg.kv_heads, jcfg.head_dim)
    init = _random_kv(tt.kv_names(tcfg), shape, rng, jcfg.kv_quant)
    jslabs, jl = jt.prefill_chunk_batch(
        jcfg, jparams, jnp.asarray(toks),
        {k: jnp.asarray(v) for k, v in init.items()}, jnp.asarray(pos0),
        jnp.asarray(clen))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    tl = tt.prefill_chunk_batch(tcfg, tparams, torch.from_numpy(toks),
                                tcache, torch.from_numpy(pos0),
                                torch.from_numpy(clen),
                                rows=torch.arange(4))
    steps = 0
    for r in range(3):
        span = slice(pos0[r], pos0[r] + 16)
        steps += _rows_close({k: v[r][:, span] for k, v in tcache.items()},
                             {k: np.asarray(v)[r] for k, v in jslabs.items()},
                             jcfg.kv_quant)
        outside = np.ones(jcfg.max_seq, bool)
        outside[span] = False
        for name, arr in tcache.items():
            np.testing.assert_array_equal(arr[r][:, outside].numpy(),
                                          init[name][r][:, outside])
    np.testing.assert_allclose(tl[:3].numpy(), np.asarray(jl)[:3], rtol=0,
                               atol=TOL if not steps else FLIP_TOL)


def test_paged_prefill_chunk_batch_matches_the_reference(batch_model):
    """Each real row through its own full-width table of shuffled blocks,
    the padding row's all-zero table on scratch block 0: logits of the
    real rows and every pool block but the scratch one."""
    jcfg, jparams, tcfg, tparams = batch_model
    rng = np.random.default_rng(7)
    toks, pos0, clen = _batch_inputs(jcfg.vocab_size, rng)
    bl, n_blocks = 8, 28
    width = jcfg.max_seq // bl
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((4, width), np.int32)
    for r in range(3):
        tables[r] = perm[r * width:(r + 1) * width]
    shape = (jcfg.n_layers, n_blocks, bl, jcfg.kv_heads, jcfg.head_dim)
    init = _random_kv(tt.kv_names(tcfg), shape, rng, jcfg.kv_quant)
    jpool, jl = jt.paged_prefill_chunk_batch(
        jcfg, jparams, jnp.asarray(toks), jnp.asarray(tables),
        jnp.asarray(pos0), {k: jnp.asarray(v) for k, v in init.items()},
        jnp.asarray(clen))
    tpool = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    tpool, tl = tt.paged_prefill_chunk_batch(
        tcfg, tparams, torch.from_numpy(toks), torch.from_numpy(tables),
        torch.from_numpy(pos0), tpool, torch.from_numpy(clen))
    steps = _rows_close(tpool, jpool, jcfg.kv_quant,
                        (slice(None), slice(1, None)))
    np.testing.assert_allclose(tl[:3].numpy(), np.asarray(jl)[:3], rtol=0,
                               atol=TOL if not steps else FLIP_TOL)
