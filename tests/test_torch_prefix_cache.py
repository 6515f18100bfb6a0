"""The port's prefix cache (client_tpu_torch.server.kv_cache and its engine
integration) on the CPU, held against the JAX package's.

- The radix index is pure host code in both packages: a seeded random
  sequence of the index operations each KV layout makes drives both side
  by side, and the returned ids, matches, occupancy and counters must be
  equal after every step (their ``spilled`` counts included, 0 without a
  host tier; ``tests/test_torch_host_tier.py`` drives the tier). The
  reference's own index cases (tests/test_prefix_cache.py) run on
  both.
- ``pool_to_slot`` and ``slot_to_pool`` must be bit-equal to the
  reference's copy kernels, scratch padding and per-block offsets
  included.
- Shared-prefix jobs submitted one after another must give the JAX
  engine's greedy streams and the same hit, miss, saved-token, commit,
  node and eviction counts on slot x {token, batched, chunked} and
  paged x {token, chunked}.
- Concurrent shared-prefix streams give the same tokens with the cache on
  and off; eviction keeps them right; pins are released on cancel and on
  failure; a small hit under batched prefill counts as a miss; knob errors
  match the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import transformer as jt
from client_tpu.server import kv_cache as jkv
from client_tpu.server.generation import (
    ContinuousBatchingEngine as JaxEngine,
)
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.perf import bench_harness as tbh
from client_tpu_torch.server import kv_cache as tkv
from client_tpu_torch.server.generation import ContinuousBatchingEngine
from client_tpu_torch.server.types import ServerError

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=64, causal=True)
BL = 4
ENGINE = dict(n_slots=2, chunk=4, prefix_cache=True, prefix_blocks=32,
              prefix_block_len=BL)
CASES = {
    "slot_token": dict(prefill_mode="token"),
    "slot_batched": dict(prefill_mode="batched"),
    "slot_chunked": dict(prefill_mode="chunked", prefill_chunk=16),
    "paged_token": dict(kv_layout="paged", kv_block_len=BL,
                        prefill_mode="token"),
    "paged_chunked": dict(kv_layout="paged", kv_block_len=BL,
                          prefill_mode="chunked", prefill_chunk=16),
}
SHARED = [3, 17, 42, 9, 8, 7, 6, 5, 30, 31, 32, 33]  # 3 blocks of 4


def _refs(index) -> list:
    """Every trie node's ref count."""
    refs, stack = [], list(index._root.children.values())
    while stack:
        node = stack.pop()
        refs.append(node.refs)
        stack.extend(node.children.values())
    return refs


# ---------------------------------------------------------------- (a) index

def _random_tokens(rng, bases) -> list:
    """A prompt that shares a random number of blocks with one of
    ``bases``, then diverges (sometimes inside a block)."""
    base = bases[rng.integers(len(bases))]
    keep = int(rng.integers(0, len(base) + 1))
    tail = rng.integers(0, 6, size=int(rng.integers(0, 10))).tolist()
    return base[:keep] + tail


# the operations each engine layout makes (the two never share an index):
# the slot layout's commits copy into blocks they allocate, the paged
# layout's streams reserve, allocate and donate their own
INDEX_OPS = {
    "slot": ("acquire", "release", "plan_commit", "finish_commit"),
    "paged": ("acquire", "release", "commit_stream", "reserve", "alloc",
              "free", "unreserve"),
}


@pytest.mark.parametrize("layout", sorted(INDEX_OPS))
def test_index_op_sequence_matches_the_reference(layout):
    rng = np.random.default_rng(0)
    port, ref = tkv.RadixBlockIndex(24, BL), jkv.RadixBlockIndex(24, BL)
    bases = [rng.integers(0, 6, size=20).tolist() for _ in range(3)]
    handles, plans, streams = [], [], []
    reserved = 0
    ops = INDEX_OPS[layout]
    counts = dict.fromkeys(ops, 0)
    for step in range(600):
        op = ops[rng.integers(len(ops))]
        if op == "acquire":
            toks = _random_tokens(rng, bases)
            a, b = port.acquire(toks), ref.acquire(toks)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.block_ids == b.block_ids
                assert a.matched_tokens == b.matched_tokens
                handles.append((a, b))
        elif op == "release" and handles:
            a, b = handles.pop(int(rng.integers(len(handles))))
            port.release(a)
            ref.release(b)
        elif op == "plan_commit":
            toks = _random_tokens(rng, bases)
            policy = ("all", "no-evict", "none")[rng.integers(3)]
            a, b = port.plan_commit(toks, policy), ref.plan_commit(toks,
                                                                   policy)
            assert [x[:2] for x in a] == [x[:2] for x in b]
            if a:
                plans.append((a, b))
        elif op == "finish_commit" and plans:
            a, b = plans.pop(int(rng.integers(len(plans))))
            port.finish_commit(a)
            ref.finish_commit(b)
        elif op == "commit_stream" and streams:
            ids = streams.pop(int(rng.integers(len(streams))))
            toks = _random_tokens(rng, bases)
            policy = ("all", "no-evict", "none")[rng.integers(3)]
            a = port.commit_stream(toks, ids, policy)
            assert a == ref.commit_stream(toks, ids, policy)
            rest = [x for x in ids if x not in a]
            port.free(rest)
            ref.free(rest)
        elif op == "reserve":
            n = int(rng.integers(1, 5))
            ok = port.reserve(n)
            assert ok == ref.reserve(n)
            reserved += n if ok else 0
        elif op == "alloc" and reserved:
            n = int(rng.integers(1, reserved + 1))
            got = port.alloc(n)
            assert got == ref.alloc(n)
            reserved -= n
            streams.append(got)
        elif op == "free" and streams:
            ids = streams.pop(int(rng.integers(len(streams))))
            port.free(ids)
            ref.free(ids)
        elif op == "unreserve" and reserved:
            n = int(rng.integers(1, reserved + 1))
            port.unreserve(n)
            ref.unreserve(n)
            reserved -= n
        else:
            continue
        counts[op] += 1
        assert port.occupancy() == ref.occupancy(), (step, op)
        assert port.snapshot() == ref.snapshot(), (step, op)
        assert sorted(_refs(port)) == sorted(_refs(ref)), (step, op)
    # every operation ran, and the pool was pressed into evicting
    assert min(counts.values()) > 10, counts
    assert port.snapshot()["evictions"] > 0


def _case_match_is_full_block_granular(ix):
    toks = list(range(14))  # 3 full blocks of 4 + 2 tail tokens
    assert ix.acquire(toks) is None
    plan = ix.plan_commit(toks)
    assert [off for _b, off, _n in plan] == [0, 4, 8]
    ix.finish_commit(plan)
    h = ix.acquire(toks)
    assert h.matched_tokens == 12
    ix.release(h)


def _case_whole_prompt_match_is_capped_one_token_short(ix):
    toks = list(range(8))  # exactly 2 blocks
    ix.finish_commit(ix.plan_commit(toks))
    h = ix.acquire(toks)
    assert h.matched_tokens == 4
    ix.release(h)


def _case_divergence_mid_block_matches_last_full_boundary(ix):
    toks = list(range(12))
    ix.finish_commit(ix.plan_commit(toks))
    h = ix.acquire(toks[:6] + [60, 61, 62, 63, 59, 58])
    assert h.matched_tokens == 4
    ix.release(h)


def _case_refcount_pins_chain_against_eviction(ix):
    a = list(range(8))
    ix.finish_commit(ix.plan_commit(a))
    h = ix.acquire(a + [9])
    assert h.matched_tokens == 8
    for s in range(6):
        ix.finish_commit(ix.plan_commit([40 + s, 41, 42, 43]))
    h2 = ix.acquire(a + [9])
    assert h2 is not None and h2.matched_tokens == 8
    ix.release(h)
    ix.release(h2)
    assert all(r == 0 for r in _refs(ix))
    for s in range(8):
        ix.finish_commit(ix.plan_commit([50, 51 + s, 52, 53]))
    assert ix.snapshot()["evictions"] > 0


def _case_release_is_idempotent_and_survives_eviction(ix):
    a = list(range(8))
    ix.finish_commit(ix.plan_commit(a))
    h = ix.acquire(a)
    ix.release(h)
    ix.release(h)
    h2 = ix.acquire(a + [9])
    ix.release(h2)
    for s in range(4):
        ix.finish_commit(ix.plan_commit([30 + s, 31, 32, 33]))
    ix.release(h2)
    assert all(r == 0 for r in _refs(ix))


def _case_commit_never_evicts_its_own_walk_path(ix):
    a = list(range(4))
    ix.finish_commit(ix.plan_commit(a))
    assert ix.plan_commit(a + [9, 8, 7, 6]) == []
    snap = ix.snapshot()
    assert snap["evictions"] == 0
    assert snap["blocks_used"] == 1 and snap["nodes"] == 1
    h = ix.acquire(a + [9])
    assert h is not None and h.matched_tokens == 4
    ix.release(h)
    plan = ix.plan_commit([50, 51, 52, 53])
    assert len(plan) == 1
    ix.finish_commit(plan)
    assert ix.snapshot()["evictions"] == 1


def _case_commit_policies(ix):
    assert ix.plan_commit(list(range(8)), policy="none") == []
    ix.finish_commit(ix.plan_commit(list(range(8)), policy="no-evict"))
    assert ix.plan_commit([90, 91, 92, 93], policy="no-evict") == []
    assert ix.snapshot()["evictions"] == 0
    plan = ix.plan_commit([90, 91, 92, 93], policy="all")
    assert len(plan) == 1 and ix.snapshot()["evictions"] == 1
    ix.finish_commit(plan)
    with pytest.raises(ValueError):
        ix.plan_commit([1], policy="bogus")


# the reference's named cases with their pool sizes (n_blocks, block_len)
INDEX_CASES = {
    "match_is_full_block_granular":
        (_case_match_is_full_block_granular, 16),
    "whole_prompt_match_is_capped_one_token_short":
        (_case_whole_prompt_match_is_capped_one_token_short, 16),
    "divergence_mid_block_matches_last_full_boundary":
        (_case_divergence_mid_block_matches_last_full_boundary, 16),
    "refcount_pins_chain_against_eviction":
        (_case_refcount_pins_chain_against_eviction, 5),
    "release_is_idempotent_and_survives_eviction":
        (_case_release_is_idempotent_and_survives_eviction, 3),
    "commit_never_evicts_its_own_walk_path":
        (_case_commit_never_evicts_its_own_walk_path, 2),
    "commit_policies": (_case_commit_policies, 3),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_reference_index_cases(case):
    fn, n_blocks = INDEX_CASES[case]
    port, ref = tkv.RadixBlockIndex(n_blocks, BL), \
        jkv.RadixBlockIndex(n_blocks, BL)
    fn(port)
    fn(ref)
    assert port.snapshot() == ref.snapshot()
    assert port.occupancy() == ref.occupancy()


# ---------------------------------------------------------------- (b) copies

def _pool_and_state(seed: int):
    """A block-major pool of 10 blocks and a 3-slot state at max_seq 24,
    random f32 values, as numpy."""
    rng = np.random.default_rng(seed)
    pool = {n: rng.standard_normal((10, 2, BL, 2, 8)).astype(np.float32)
            for n in ("k", "v")}
    state = {n: rng.standard_normal((3, 2, 24, 2, 8)).astype(np.float32)
             for n in ("k", "v")}
    state["pos"] = np.asarray([5, 9, 2], np.int32)
    return pool, state


@pytest.fixture(scope="module")
def copy_kernels():
    cfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref",
                               **{**KW, "max_seq": 24})
    return jkv.make_copy_kernels(cfg, BL)


def _torch(tree: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


# (ids, bucket): partial and full buckets; the last bucket's B * bl is
# max_seq itself
P2S_CASES = {"one_of_1": ([7], 1), "three_padded_to_4": ([3, 7, 2], 4),
             "six_of_6": ([1, 2, 3, 4, 5, 6], 6)}
# (ids, offsets, bucket): a tail run of 3 blocks from row 12 padded to 4
# would run to row 28, past max_seq 24; per-block offsets stay in range
S2P_CASES = {"tail_run_padded_past_max_seq": ([4, 5, 6], [12, 16, 20], 4),
             "two_exact": ([8, 9], [0, 4], 2),
             "one_padded_to_2": ([3], [20], 2)}


@pytest.mark.parametrize("case", sorted(P2S_CASES))
def test_pool_to_slot_is_bit_equal_to_the_reference(copy_kernels, case):
    p2s, _ = copy_kernels
    ids, bucket = P2S_CASES[case]
    pool, state = _pool_and_state(1)
    padded = tkv.pad_block_ids(ids, bucket)
    n_tok = len(ids) * BL
    want = p2s({k: jnp.asarray(v) for k, v in pool.items()},
               {k: jnp.asarray(v) for k, v in state.items()},
               jnp.int32(1), jnp.asarray(padded), jnp.int32(n_tok))
    tpool, tstate = _torch(pool), _torch(state)
    tkv.pool_to_slot(tpool, tstate, tstate["pos"], 1,
                     torch.from_numpy(padded), n_tok)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(tstate[name].numpy(),
                                      np.asarray(want[name]))
    for name in ("k", "v"):   # the pool is only read
        np.testing.assert_array_equal(tpool[name].numpy(), pool[name])


@pytest.mark.parametrize("case", sorted(S2P_CASES))
def test_slot_to_pool_is_bit_equal_to_the_reference(copy_kernels, case):
    _, s2p = copy_kernels
    ids, offs, bucket = S2P_CASES[case]
    pool, state = _pool_and_state(2)
    pids = tkv.pad_block_ids(ids, bucket)
    poffs = np.zeros(bucket, np.int32)
    poffs[:len(offs)] = offs
    state_j = {k: jnp.asarray(v) for k, v in state.items()}
    want = s2p({k: jnp.asarray(v) for k, v in pool.items()}, state_j,
               jnp.int32(2), jnp.asarray(pids), jnp.asarray(poffs))
    tpool, tstate = _torch(pool), _torch(state)
    tkv.slot_to_pool(tpool, tstate, 2, torch.from_numpy(pids),
                     torch.from_numpy(poffs))
    for name in ("k", "v"):
        np.testing.assert_array_equal(tpool[name].numpy(),
                                      np.asarray(want[name]))
        # each real block holds exactly its slot rows
        for bid, off in zip(ids, offs):
            np.testing.assert_array_equal(
                tpool[name][bid].numpy(), state[name][2][:, off:off + BL])


# ---------------------------------------------------------------- engines

@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    return jcfg, jparams, tcfg, tparams


def _port_engine(model, **kw):
    _, _, tcfg, tparams = model
    return ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                    **{**ENGINE, **kw}).start()


def _shared_prefix_jobs(seed: int, n: int) -> list:
    """``n`` (prompt, budget) jobs over one 22-token prefix (5 full blocks
    and 2 tokens) with suffixes of 0 to 9 tokens; the prompts come back
    in a rotation, so the later ones hit their own committed suffix too."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 64, size=22)
    suffixes = [rng.integers(0, 64, size=k) for k in (0, 3, 9, 5, 1, 7)]
    jobs = []
    for i in range(n):
        prompt = np.concatenate([prefix, suffixes[i % len(suffixes)]])
        jobs.append((prompt.astype(np.int32), 3 + i % 4))
    return jobs


def _sequential(engine, jobs) -> list:
    return [list(engine.submit(p, b)) for p, b in jobs]


def _counters(engine) -> dict:
    snap = engine.gen_stats.snapshot()
    index = engine._prefix_index.snapshot()
    return {"prefix_hits": snap["prefix_hits"],
            "prefix_misses": snap["prefix_misses"],
            "prefix_saved_tokens": snap["prefix_saved_tokens"],
            **{k: index[k] for k in ("commits", "nodes", "evictions")}}


@pytest.fixture(scope="module")
def seq_jobs():
    return _shared_prefix_jobs(3, 9)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequential_shared_prefix_jobs_match_the_jax_engine(model, seq_jobs,
                                                            case):
    jcfg, jparams, _, _ = model
    ref = JaxEngine(jcfg, dict(jparams), **ENGINE, **CASES[case]).start()
    try:
        want = _sequential(ref, seq_jobs)
        want_counts = _counters(ref)
        assert all(r == 0 for r in _refs(ref._prefix_index))
    finally:
        ref.stop()
    eng = _port_engine(model, **CASES[case])
    try:
        got = _sequential(eng, seq_jobs)
        got_counts = _counters(eng)
        stats = eng.stats()
    finally:
        eng.stop()
    assert got == want
    assert got_counts == want_counts
    assert got_counts["prefix_hits"] > 0
    assert stats["prefix_cache"] == eng._prefix_index.snapshot()
    assert eng._prefix_index.pinned_nodes() == 0
    if "paged" in case:
        occ = eng._kv_index.occupancy()
        assert occ["stream"] == 0 and occ["reserved"] == 0
        assert occ["free"] + occ["prefix"] == occ["usable"]


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_concurrent_streams_match_with_the_cache_on_and_off(model, layout):
    jobs = _shared_prefix_jobs(5, 10)
    kw = (dict(kv_layout="paged", kv_block_len=BL) if layout == "paged"
          else {})
    streams = {}
    for on in (True, False):
        eng = _port_engine(model, n_slots=3, prefix_cache=on, **kw)
        try:
            # warm the cache with one committed prompt, then the wave
            list(eng.submit(jobs[0][0], 2))
            streams[on] = tbh.run_engine_jobs(eng, jobs, collect=True,
                                              join_timeout_s=300)[2]
            snap = eng.gen_stats.snapshot()
        finally:
            eng.stop()
        if on:
            assert snap["prefix_hits"] > snap["prefix_misses"]
            assert eng._prefix_index.pinned_nodes() == 0
        else:
            assert snap["prefix_hits"] == snap["prefix_misses"] == 0
    assert streams[True] == streams[False]


# ---------------------------------------------------------------- (e)-(g)

def test_eviction_under_pool_pressure_stays_correct(model):
    prompts = [np.asarray([(s * 13 + i) % 64 for i in range(13)], np.int32)
               for s in range(4)]
    plain = _port_engine(model, prefix_cache=False)
    try:
        want = _sequential(plain, [(p, 4) for p in prompts])
    finally:
        plain.stop()
    # 5 usable blocks, prompts of 3 full blocks each: the second distinct
    # prompt already has to evict
    eng = _port_engine(model, prefix_blocks=6)
    try:
        assert _sequential(eng, [(p, 4) for p in prompts]) == want
        snap = eng.stats()["prefix_cache"]
    finally:
        eng.stop()
    assert snap["evictions"] > 0 and snap["blocks_used"] <= 5


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_pins_are_released_on_cancel_and_on_failure(model, layout):
    kw = (dict(kv_layout="paged", kv_block_len=BL) if layout == "paged"
          else {})
    warm = np.asarray(SHARED + [1], np.int32)
    eng = _port_engine(model, overlap=False, **kw)
    try:
        list(eng.submit(warm, 2))
        # cancel: the consumer abandons a hit mid-stream
        it = eng.submit(np.asarray(SHARED + [2], np.int32), 30)
        next(it)
        it.close()
        # failure: the engine stops under a hit mid-stream
        it = eng.submit(np.asarray(SHARED + [3], np.int32), 30)
        next(it)
    finally:
        eng.stop()
    with pytest.raises(ServerError):
        list(it)
    snap = eng.gen_stats.snapshot()
    assert snap["cancelled"] == 1 and snap["failed"] >= 1
    assert snap["prefix_hits"] == 2
    assert eng._prefix_index.pinned_nodes() == 0
    if layout == "paged":
        occ = eng._kv_index.occupancy()
        assert occ["stream"] == 0 and occ["reserved"] == 0


def test_small_hit_defers_to_batched_prefill_for_a_long_remainder(model):
    short = np.asarray(SHARED[:4] + [1], np.int32)          # 1 block
    long_p = np.asarray(SHARED[:4] + list(range(50, 62)), np.int32)
    plain = _port_engine(model, prefix_cache=False, prefill_mode="batched")
    try:
        want = _sequential(plain, [(short, 3), (long_p, 3)])
    finally:
        plain.stop()
    eng = _port_engine(model, prefill_mode="batched")
    try:
        got = _sequential(eng, [(short, 3), (long_p, 3)])
        snap = eng.gen_stats.snapshot()
    finally:
        eng.stop()
    assert got == want
    assert snap["prefix_hits"] == 0 and snap["prefix_misses"] == 2
    assert eng._prefix_index.pinned_nodes() == 0


BAD_KNOBS = {
    "unknown_policy": dict(prefix_commit_policy="bogus"),
    "block_len_max_seq": dict(prefix_block_len=KW["max_seq"]),
    "block_len_zero": dict(prefix_block_len=0),
    "one_block": dict(prefix_blocks=1),
    "paged_block_len_mismatch": dict(kv_layout="paged", kv_block_len=8,
                                     prefix_block_len=4),
    "paged_unknown_policy": dict(kv_layout="paged", prefix_cache=False,
                                 prefix_commit_policy="bogus"),
}


@pytest.mark.parametrize("case", sorted(BAD_KNOBS))
def test_knob_errors_match_the_reference(model, case):
    jcfg, jparams, tcfg, tparams = model
    kw = {"prefix_cache": True, **BAD_KNOBS[case]}
    with pytest.raises(ValueError) as want:
        JaxEngine(jcfg, dict(jparams), **kw)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(tcfg, tparams, device="cpu", **kw)
    # the same rule fails: the messages agree up to the dash style
    assert str(got.value).split(":")[0].split(" (")[0] \
        == str(want.value).split(":")[0].split(" (")[0]
