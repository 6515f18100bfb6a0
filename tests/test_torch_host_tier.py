"""The port's host-RAM prefix tier (client_tpu_torch.server.kv_cache's
HostTierStore, the tier half of RadixBlockIndex and the engine's movers)
on the CPU, held against the JAX package's.

- ``HostTierStore``: the same sequence of puts, takes and drops (pinned,
  child-anchoring and protected entries among them) gives the same
  answers, drops, sizes and dropped-node markers in both stores.
- The index: a seeded sequence of the paged layout's operations with a
  tier of 3 blocks attached (host movers in both packages) gives the same
  matches, restored-block counts, occupancy, snapshots and tier
  snapshots after every step.
- The engines: three shared-prefix families cycled A, B, C, A, B, A
  through a pool that holds about 1.5 of them (the reference's
  ``kv_pool_blocks=14`` case) give the JAX engine's greedy tokens, equal
  to a tier-less run, and the same spills, restores, tier hits and drops,
  with ``occupancy()["spilled"]`` equal to the tier's ``spilled_nodes``,
  on the paged layout (chunked lane) and on the slot layout's prefix
  pool; a tier of one block drops entries and still serves the same
  tokens; a cancel right after a restore leaks no block or pin.
- The generator advertises the tier, the scheduler and the SLO classes
  as the reference does.

Tolerance: tokens, counts and config blocks exact.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import decoder_lm as jlm
from client_tpu.models import transformer as jt
from client_tpu.server import kv_cache as jkv
from client_tpu.server.generation import (
    ContinuousBatchingEngine as JaxEngine,
)
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import kv_cache as tkv
from client_tpu_torch.server.generation import ContinuousBatchingEngine
from client_tpu_torch.server.types import ServerError

# the reference's tiny config (tests/test_disagg_lanes.py)
KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=64, causal=True)
FAMILIES = {"A": 0, "B": 7, "C": 19}
CYCLE = ("A", "B", "C", "A", "B", "A")
LAYOUTS = {
    "paged_chunked": dict(kv_layout="paged", kv_block_len=8,
                          kv_pool_blocks=14, prefix_cache=True,
                          prefix_block_len=8, prefill_mode="chunked",
                          prefill_chunk=16),
    "slot_token": dict(prefix_cache=True, prefix_block_len=8,
                       prefix_blocks=14),
}


def _family(name: str) -> np.ndarray:
    return ((np.arange(0, 41) + FAMILIES[name]) % 64).astype(np.int32)


# ------------------------------------------------------------- the store

class _FakeNode:
    __slots__ = ("children", "refs", "block_id", "name")

    def __init__(self, name, refs=0, children=()):
        self.name = name
        self.refs = refs
        self.children = dict.fromkeys(children, None)
        self.block_id = -1


def _store_trace(mod) -> list:
    store = mod.HostTierStore(budget_bytes=300, block_nbytes=100)
    nodes = {n: _FakeNode(n) for n in "abcdefg"}
    nodes["b"].refs = 1                    # pinned: never dropped
    nodes["c"].children = {"x": None}      # anchors a child: never dropped
    trace = [store.capacity_blocks]
    for name in "abc":
        trace.append(store.put(nodes[name], {"k": name}))
    # full: d drops the oldest droppable (a)
    trace.append(store.put(nodes["d"], {"k": "d"}))
    # e with d protected: nothing else is droppable -> refused
    trace.append(store.put(nodes["e"], {"k": "e"},
                           protect=frozenset({nodes["d"]})))
    trace.append(store.take(nodes["b"]))
    trace.append(store.put(nodes["f"], {"k": "f"}))
    store.drop(nodes["c"])
    trace.append(store.put(nodes["g"], {"k": "g"}))
    trace.append(store.take(nodes["a"]))
    store.drain()
    trace.append({n: (v.block_id, v.refs) for n, v in nodes.items()})
    trace.append((len(store), store.used_bytes, store.snapshot()))
    return trace


def test_host_tier_store_matches_the_reference():
    assert _store_trace(tkv) == _store_trace(jkv)
    with pytest.raises(ValueError):
        tkv.HostTierStore(0, 10)
    with pytest.raises(ValueError):
        tkv.HostTierStore(10, 0)


# ------------------------------------------------------------- the index

class _Movers:
    """Host movers over a numpy pool: spilled rows are the block's
    contents, restores write them back; both packages get the same
    pool, so the rows a restore writes can be compared."""

    def __init__(self, n_blocks: int, torch_side: bool):
        self.pool = np.arange(n_blocks * 3, dtype=np.int64).reshape(
            n_blocks, 3)
        self.torch_side = torch_side
        self.log = []

    def spill(self, bid):
        self.log.append(("spill", bid))
        rows = {"k": self.pool[bid].copy()}
        return (rows, None) if self.torch_side else rows

    def restore(self, bid, rows):
        self.log.append(("restore", bid, rows["k"].tolist()))
        self.pool[bid] = rows["k"]


def _random_tokens(rng, bases) -> list:
    base = bases[rng.integers(len(bases))]
    keep = int(rng.integers(0, len(base) + 1))
    tail = rng.integers(0, 6, size=int(rng.integers(0, 10))).tolist()
    return base[:keep] + tail


def test_tiered_index_op_sequence_matches_the_reference():
    rng = np.random.default_rng(3)
    bl, n = 4, 12
    sides = {}
    for name, mod in (("port", tkv), ("ref", jkv)):
        ix = mod.RadixBlockIndex(n, bl)
        mv = _Movers(n, name == "port")
        ix.attach_tier(mod.HostTierStore(3 * 24, 24), mv.spill, mv.restore)
        sides[name] = (ix, mv)
    bases = [rng.integers(0, 6, size=24).tolist() for _ in range(4)]
    handles, streams = [], []
    ops = ("acquire", "release", "commit_stream", "reserve", "free")
    restored_total = 0
    for step in range(500):
        op = ops[rng.integers(len(ops))]
        if op == "acquire":
            toks = _random_tokens(rng, bases)
            hs = {name: ix.acquire(toks) for name, (ix, _) in sides.items()}
            a, b = hs["port"], hs["ref"]
            assert (a is None) == (b is None), step
            if a is not None:
                assert (a.block_ids, a.matched_tokens, a.restored_blocks) \
                    == (b.block_ids, b.matched_tokens, b.restored_blocks)
                restored_total += a.restored_blocks
                handles.append((a, b))
        elif op == "release" and handles:
            a, b = handles.pop(int(rng.integers(len(handles))))
            sides["port"][0].release(a)
            sides["ref"][0].release(b)
        elif op == "commit_stream":
            toks = _random_tokens(rng, bases)
            need = len(toks) // bl
            ok = {name: ix.reserve(need) for name, (ix, _) in sides.items()}
            assert ok["port"] == ok["ref"], step
            if ok["port"]:
                ids = {name: ix.alloc(need)
                       for name, (ix, _) in sides.items()}
                assert ids["port"] == ids["ref"]
                don = {name: ix.commit_stream(toks, ids[name])
                       for name, (ix, _) in sides.items()}
                assert don["port"] == don["ref"]
                streams.append([b for b in ids["port"]
                                if b not in don["port"]])
        elif op == "reserve":
            k = int(rng.integers(1, 4))
            ok = [ix.reserve(k) for ix, _ in sides.values()]
            assert ok[0] == ok[1], step
            if ok[0]:
                for ix, _ in sides.values():
                    ix.unreserve(k)
        elif op == "free" and streams:
            blocks = streams.pop(int(rng.integers(len(streams))))
            for ix, _ in sides.values():
                ix.free(blocks)
        port, ref = sides["port"][0], sides["ref"][0]
        assert port.occupancy() == ref.occupancy(), (step, op)
        assert port.snapshot() == ref.snapshot(), (step, op)
        assert port.tier_snapshot() == ref.tier_snapshot(), (step, op)
        assert sides["port"][1].log == sides["ref"][1].log, (step, op)
    snap = sides["port"][0].tier_snapshot()
    # the sequence exercised every path: spills, restores, drops
    assert snap["spills"] > 0 and snap["restores"] > 0
    assert snap["dropped"] > 0 and restored_total > 0


# ----------------------------------------------------------- the engines

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


def _cycle(eng) -> dict:
    toks = [list(eng.submit(_family(name), 8)) for name in CYCLE]
    tier = eng.stats()["kv_tier"]
    gs = eng.gen_stats.snapshot()
    occ = eng._kv_index.occupancy()
    return {"tokens": toks, "tier": tier, "tier_hits": gs["tier_hits"],
            "prefix_hits": gs["prefix_hits"],
            "saved": gs["prefix_saved_tokens"], "occupancy": occ}


@pytest.fixture(scope="module")
def tierless(weights):
    """Each layout's cycle on a tier-less port engine: the tokens a
    restored stream must reproduce."""
    out = {}
    for layout, kw in LAYOUTS.items():
        eng = _engine("port", weights, **kw)
        try:
            out[layout] = _cycle(eng)
            assert out[layout]["tier"] is None
        finally:
            eng.stop()
    return out


@pytest.mark.parametrize("tier_bytes", [1 << 22, 1])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_three_family_cycle_matches_the_jax_engine(weights, tierless,
                                                   layout, tier_bytes):
    runs = {}
    for side in ("ref", "port"):
        eng = _engine(side, weights, host_tier_bytes=tier_bytes,
                      **LAYOUTS[layout])
        try:
            runs[side] = _cycle(eng)
        finally:
            eng.stop()
    port, ref = runs["port"], runs["ref"]
    assert port == ref
    assert port["tokens"] == tierless[layout]["tokens"]
    tier = port["tier"]
    assert tier["spills"] > 0
    assert port["occupancy"]["spilled"] == tier["spilled_nodes"]
    if tier_bytes == 1:
        # the floor of one block: spills push older entries out
        assert tier["capacity_blocks"] == 1 and tier["blocks"] <= 1
        assert tier["dropped"] > 0
    else:
        assert tier["restores"] > 0 and port["tier_hits"] > 0
        assert tier["dropped"] == 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cancel_after_a_restore_leaks_nothing(weights, layout):
    """A stream whose admission restored its chain from the tier is
    cancelled while it holds its slot (the engine held at its sweep until
    the Event is set): it ends with a 499, and the drained engine holds no
    pin, stream block or reservation, and its spilled count is the
    tier's."""
    eng = _engine("port", weights, host_tier_bytes=1 << 22,
                  **LAYOUTS[layout])
    held, go = threading.Event(), threading.Event()
    sweep = eng._reap_slots

    def reap():
        if not go.is_set() and any(s.req is not None
                                   and s.req.tenant == "victim"
                                   for s in eng._slots):
            held.set()
            go.wait(60)
        sweep()

    try:
        for name in ("A", "B", "C"):
            list(eng.submit(_family(name), 8))
        assert eng._kv_index.tier_snapshot()["spills"] > 0
        restores = eng._kv_index.tier_snapshot()["restores"]
        eng._reap_slots = reap
        cancel, out = threading.Event(), []

        def consume():
            try:
                out.extend(eng.submit(_family("A"), 30, tenant_id="victim",
                                      cancel_event=cancel))
            except ServerError as e:
                out.append(e.status)

        th = threading.Thread(target=consume)
        th.start()
        assert held.wait(60)
        assert eng._kv_index.tier_snapshot()["restores"] > restores
        cancel.set()
        go.set()
        th.join(60)
        assert out[-1:] == [499]
        assert eng.gen_stats.snapshot()["cancelled"] == 1
        assert list(eng.submit(_family("B"), 4))
        assert eng.drain(timeout=30)
        end = eng._kv_index.occupancy()
        assert eng._kv_index.pinned_nodes() == 0
        assert end["stream"] == 0 and end["reserved"] == 0
        assert end["spilled"] == eng._kv_index.tier_snapshot()[
            "spilled_nodes"]
    finally:
        go.set()
        eng.stop()


def test_tier_needs_the_prefix_cache(weights):
    _, _, tcfg, tparams = weights
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                 host_tier_bytes=1 << 20)
    with pytest.raises(ValueError) as want:
        JaxEngine.resolve_host_tier(1 << 20, False)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=">= 0"):
        ContinuousBatchingEngine.resolve_host_tier(-1, True)


# ------------------------------------------------- the generator's blocks

GENERATORS = {
    "tier_paged": dict(kv_layout="paged", kv_block_len=8, prefix_cache=True,
                       prefix_block_len=8, host_tier_bytes=1 << 20),
    "tier_slot": dict(prefix_cache=True, prefix_block_len=8,
                      host_tier_bytes=12345),
    "scheduler": dict(prefix_cache=True, prefix_block_len=8,
                      scheduler={"class_weights": {"gold": 4.0},
                                 "preemption": True, "controller": True},
                      slo_classes=[{"name": "gold", "ttft_ms": 250.0},
                                   {"name": "bronze", "itl_ms": 50.0,
                                    "target_percentile": 95.0}]),
    "scheduler_true": dict(scheduler=True, dispatch_duty=0.5,
                           slo_window_s=5.0, slo_max_tenants=4),
    "none": dict(),
}


@pytest.mark.parametrize("case", sorted(GENERATORS))
def test_generator_blocks_match_the_reference(weights, case):
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(n_slots=2, chunk_size=4, **GENERATORS[case])
    ref = jlm.make_continuous_generator("lm", cfg=jcfg, params=dict(jparams),
                                        **kw)
    port = tlm.make_continuous_generator("lm", cfg=tcfg, params=tparams,
                                         device="cpu", **kw)
    want, got = ref.config.to_json(), port.config.to_json()
    ref.engine.stop()
    port.engine.stop()
    engine = got["generation_engine"]
    assert engine == {k: want["generation_engine"][k] for k in engine}
    assert engine["host_tier_bytes"] \
        == GENERATORS[case].get("host_tier_bytes", 0)
    for block in ("scheduler", "slo_classes"):
        assert got.get(block) == want.get(block), block
    assert ("scheduler" in got) == ("scheduler" in GENERATORS[case])
    assert port.scheduler_snapshot() is None \
        or port.scheduler_snapshot()["enabled"]
    assert port.slo_snapshot()["max_tenants"] \
        == GENERATORS[case].get("slo_max_tenants", 32)


def test_generator_refuses_like_the_reference(weights):
    jcfg, jparams, tcfg, tparams = weights
    for kw in (dict(host_tier_bytes=1),
               dict(scheduler={"preemption": True}),
               dict(scheduler={"class_weights": {"gold": 0}})):
        with pytest.raises(ValueError) as want:
            jlm.make_continuous_generator("lm", cfg=jcfg,
                                          params=dict(jparams), **kw)
        with pytest.raises(ValueError) as got:
            tlm.make_continuous_generator("lm", cfg=tcfg, params=tparams,
                                          device="cpu", **kw)
        assert str(got.value) == str(want.value)
