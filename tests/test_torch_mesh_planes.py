"""The engine's optional planes over a dp×tp mesh, held against the JAX
package on the CPU: one ``run_ranks`` launch of 4 gloo ranks (dp2·tp2;
rank body ``mesh_planes`` in ``tests/torch_mesh_ranks.py``, which imports
no JAX) runs every scenario, and the reference's tokens are computed here
from the same weights (``params_from_jax``).

- speculation with a self-draft on both layouts (the reference's
  tests/test_speculation.py:656 on the slot layout): greedy streams equal
  to the reference's offline greedy tokens; on the slot layout every
  proposal is accepted, on the paged one the counters are the unsharded
  engine's (a round past a stream's reservation reads scratch rows, in
  the reference too);
- the dedicated lanes, per slot and batched, on both layouts: the offline
  greedy tokens, with a handoff whose lane slot and decode slot sit on
  different dp ranks;
- the host tier on both layouts: a prefix written from dp rank 0,
  spilled, and restored for a stream on dp rank 1, its streams the
  offline greedy tokens; the driver's store counts whole blocks;
- int8 KV on both layouts: the JAX int8 engine's streams;
- supervision: an injected crash of the driver's engine, every follower
  rebuilt with it, the streams again the reference's, and a second crash
  that trips the breaker, whose STOP ends every follower;
- each rank's shard: draft state S/dp with the draft whole, lane state
  S/dp plus a scratch row at Hkv/tp, scale tables at Hkv/tp, a
  follower's tier rows at Hkv/tp.

Tokens and counters exact (f32 weights).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from client_tpu.models import transformer as jt
from client_tpu.server.generation import (
    ContinuousBatchingEngine as JaxEngine,
)
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.parallel import collectives
from client_tpu_torch.server.generation import ContinuousBatchingEngine
from client_tpu_torch.server.kv_cache import HostTierStore
from client_tpu_torch.server.speculation import DraftModel

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
            d_ff=64, max_seq=64, attn_impl="ref")
JOBS = [([3, 17, 42], 7), ([5, 11], 3), ([1], 9), ([9, 8, 7, 6, 5], 5),
        ([2, 4], 6)]
# prompts longer than a chunk: each goes through a lane slot
LONG_JOBS = [(list(range(2, 15)), 6), (list(range(20, 31)), 5),
             ([7] * 9, 4), (list(range(30, 50)), 5)]
# three 41-token families; A's five full blocks spill while B and C run
FAMILIES = [[int(x) for x in (np.arange(0, 41) + off) % 64]
            for off in (0, 7, 19)]
FAMILY_BUDGET = 8
FILLER = [7, 7, 7]
LAUNCH_S = 240.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _offline_greedy(step, cfg, params, prompt, n):
    """The reference's offline greedy decode (one slot, token by
    token)."""
    with jax.default_matmul_precision("float32"):
        state = jt.init_decode_state(cfg)
        nxt = None
        for tok in prompt:
            logits, state = step(params, jnp.int32(tok), state)
            nxt = int(jnp.argmax(logits))
        out = []
        for _ in range(n):
            out.append(nxt)
            logits, state = step(params, jnp.int32(nxt), state)
            nxt = int(jnp.argmax(logits))
    return out


def _jax_int8_streams(params, layout: str) -> list:
    """The JAX package's int8 engine on the same weights and jobs."""
    cfg = jt.TransformerConfig(dtype=jnp.float32, kv_quant=True, **TINY)
    kw = dict(kv_layout="paged", kv_block_len=8) if layout == "paged" else {}
    eng = JaxEngine(cfg, dict(params), n_slots=4, chunk=4, **kw).start()
    try:
        its = [eng.submit(np.asarray(p, np.int32), b) for p, b in JOBS]
        return [list(it) for it in its]
    finally:
        eng.stop()


def _unsharded_spec(tparams) -> dict:
    """The port's unsharded paged engine with the same self-draft: the
    speculation counters the sharded one must repeat."""
    cfg = tt.TransformerConfig(dtype=torch.float32, **TINY)
    eng = ContinuousBatchingEngine(
        cfg, tparams, n_slots=4, chunk=4, device="cpu", kv_layout="paged",
        kv_block_len=8, speculative_draft=DraftModel(cfg, tparams),
        speculative_gamma=3)
    try:
        ranks._concurrent(eng, JOBS)
        return eng.stats()["speculation"]
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def planes_run():
    cfg = jt.TransformerConfig(dtype=jnp.float32, **TINY)
    params = jt.init_params(jax.random.key(0), cfg)
    case = {"tiny": TINY, "tiny_params": _np(params), "jobs": JOBS,
            "long_jobs": LONG_JOBS, "families": FAMILIES,
            "family_budget": FAMILY_BUDGET, "filler": FILLER}
    got = collectives.run_ranks(ranks.mesh_planes, 4, "gloo", LAUNCH_S,
                                args=(case,))
    step = jax.jit(functools.partial(jt.decode_step, cfg))
    greedy = functools.partial(_offline_greedy, step, cfg, params)
    tparams = tt.params_from_jax(_np(params), "cpu", torch.float32)
    ref = {
        "tiny": [greedy(p, b) for p, b in JOBS],
        "long": [greedy(p, b) for p, b in LONG_JOBS],
        "family": greedy(FAMILIES[0], FAMILY_BUDGET),
        "int8_slot": _jax_int8_streams(params, "slot"),
        "int8_paged": _jax_int8_streams(params, "paged"),
        "spec_paged": _unsharded_spec(tparams),
    }
    return got, ref


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_speculation_streams_match_the_jax_offline_tokens(planes_run,
                                                          layout):
    got, ref = planes_run
    r = got[0][f"spec_{layout}"]
    assert r["tokens"] == ref["tiny"]
    assert r["spec"]["rounds"] > 0
    assert all(g[f"spec_{layout}"] is None for g in got[1:])


def test_a_self_draft_accepts_every_proposal_on_the_slot_layout(planes_run):
    """The reference's sharded speculation test: every verify round of a
    self-draft accepts all its proposals."""
    got, _ = planes_run
    spec = got[0]["spec_slot"]["spec"]
    assert spec["proposed"] > 0
    assert spec["accepted"] == spec["proposed"]


def test_paged_rounds_count_as_the_unsharded_engines(planes_run):
    got, ref = planes_run
    spec = got[0]["spec_paged"]["spec"]
    want = ref["spec_paged"]
    for key in ("rounds", "proposed", "accepted", "rejected"):
        assert spec[key] == want[key], key


LANES = ["slot_0", "slot_2", "paged_0", "paged_2"]


@pytest.mark.parametrize("lane", LANES)
def test_dedicated_lanes_match_the_jax_offline_tokens(planes_run, lane):
    """Per-slot (0) and batched (2) dedicated lanes on both layouts: every
    long prompt ingests in a lane slot and hands off."""
    got, ref = planes_run
    r = got[0][f"lane_{lane}"]
    assert r["tokens"] == ref["long"]
    assert len(r["handoffs"]) == len(LONG_JOBS)


@pytest.mark.parametrize("lane", LANES)
def test_a_handoff_crosses_dp_ranks(planes_run, lane):
    """Lane slot l sits on dp rank l (one lane slot per rank), decode slot
    d on dp rank d // 2: at least one handoff moves a prompt between dp
    ranks (paged: its position and token broadcast; slot layout: its rows
    committed through the replicated pool)."""
    got, _ = planes_run
    handoffs = got[0][f"lane_{lane}"]["handoffs"]
    assert any(l_idx != d_idx // 2 for l_idx, d_idx in handoffs), handoffs


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_the_tier_restores_a_prefix_across_dp_ranks(planes_run, layout):
    """Family A's blocks, written from decode slot 0 (dp rank 0), spill
    while B and C run; A again on slot 1 (dp rank 1) restores them from
    the host tier: a tier hit, and both of A's streams the reference's."""
    got, ref = planes_run
    r = got[0][f"tier_{layout}"]
    assert r["slots"] == [0, 0, 0, 0, 1]
    assert r["spills"] > 0 and r["restores"] > 0 and r["tier_hits"] == 1
    assert r["tokens"] == [ref["family"]] * 2


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_the_tier_budget_counts_whole_blocks(planes_run, layout):
    """The driver's store sizes its budget and its LRU by a block's whole
    bytes: its tp=2 shard's twice."""
    got, _ = planes_run
    r = got[0][f"tier_{layout}"]
    assert r["block_nbytes"] == 2 * r["shard_block_nbytes"]


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_int8_streams_match_the_jax_int8_engine(planes_run, layout):
    got, ref = planes_run
    assert got[0][f"int8_{layout}"] == ref[f"int8_{layout}"]


def test_each_rank_holds_its_draft_shard(planes_run):
    """The draft state is the rank's dp block of the slots (4 / dp = 2)
    at the draft's whole heads; its params are whole on every rank."""
    got, _ = planes_run
    for r in got:
        for layout in ("slot", "paged"):
            s = r["shards"][f"spec_{layout}"]
            assert s["dcache_k"] == (2, 2, 64, 2, 16)
            assert s["dpos"] == (2,)
            assert s["dparams_wqkv"] == (2, 32, 3, 2, 16)


def test_each_rank_holds_its_lane_shard(planes_run):
    """Two lane slots over dp 2: one lane slot and the scratch row per
    rank; the slot layout's lane rows at Hkv / tp = 1 head."""
    got, _ = planes_run
    for r in got:
        for lane in LANES:
            s = r["shards"][f"lane_{lane}"]
            assert s["lane_pos"] == s["lane_last"] == (2,)
            if lane.startswith("slot"):
                assert s["lane_cache_k"] == (2, 2, 64, 1, 16)


def test_each_rank_holds_its_scale_tables(planes_run):
    """The int8 scale tables split over tp with the heads: the slot
    state's [S/dp, layers, max_seq, Hkv/tp], the pool's [layers, blocks,
    block_len, Hkv/tp] (its blocks whole)."""
    got, _ = planes_run
    for r in got:
        assert r["shards"]["int8_slot"]["k_scale"] == (2, 2, 64, 1)
        assert r["shards"]["int8_slot"]["k"] == (2, 2, 64, 1, 16)
        assert r["shards"]["int8_paged"]["k_scale"] == (2, 33, 8, 1)


def test_a_follower_files_its_heads_of_a_spilled_block(planes_run):
    """A follower keeps only its own heads of a spilled block, under the
    driver's key: [layers, block_len, Hkv/tp, Dh]."""
    got, _ = planes_run
    for r in got[1:]:
        for layout in ("slot", "paged"):
            assert r["shards"][f"tier_{layout}"]["rows"] == [
                {"k": (2, 8, 1, 16), "v": (2, 8, 1, 16)}]


def test_a_supervised_mesh_engine_restarts_on_every_rank(planes_run):
    got, ref = planes_run
    sup = got[0]["supervision"]
    assert sup["before"] == ref["tiny"][:2]
    assert sup["after"] == ref["tiny"][:2]
    assert "restarting" in sup["first_crash"]
    assert [r["supervision"]["restarts"] for r in got] == [1] * 4


def test_the_breaker_stops_every_follower(planes_run):
    got, _ = planes_run
    sup = got[0]["supervision"]
    assert "breaker tripped" in sup["second_crash"]
    assert sup["healthy"] is False
    assert [r["supervision"]["crash_looped"] for r in got] == [True] * 4


class _Node:
    """What the store reads of a trie node: no children, its pins."""

    def __init__(self):
        self.children, self.refs, self.block_id = {}, 0, 1


def test_the_tier_store_reports_every_entry_it_lets_go():
    """The driver's store calls ``on_drop`` with each entry that leaves
    other than by a restore (dropped for room, dropped with its node, or
    refused), so a follower never keeps the rows of an entry the driver
    let go; a restored entry is not reported."""
    dropped = []
    store = HostTierStore(2 * 64, 64, on_drop=dropped.append)
    a, b, c = _Node(), _Node(), _Node()
    assert store.put(a, (1, "a")) and store.put(b, (2, "b"))
    assert store.put(c, (3, "c"))               # drops a, the oldest
    assert dropped == [(1, "a")]
    store.drop(b)
    assert dropped == [(1, "a"), (2, "b")]
    assert store.take(c) == (3, "c")            # a restore: not reported
    assert store.put(a, (4, "a")) and store.put(b, (5, "b"))
    a.refs = b.refs = 1                         # every entry pinned
    assert not store.put(c, (6, "c"))           # no room: refused
    assert dropped == [(1, "a"), (2, "b"), (6, "c")]
