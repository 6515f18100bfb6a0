"""The port's int8 KV cache (``TransformerConfig(kv_quant=True)``) on the
CPU, held against the JAX package's.

- ``_kv_quantize`` / ``_kv_dequantize`` on the same f32 rows: int8 values
  and scales equal (exact halves round to even in both).
- Every path that writes or reads KV under ``kv_quant`` against the
  reference's function on the same weights (``params_from_jax``) and
  inputs: ``decode_step`` (batched against ``jax.vmap``), ``verify_steps``,
  ``prefill``, ``prefill_chunk``, ``paged_decode_steps`` (the einsum route
  even with ``attn_impl="flash"``; an ``attention`` override raises),
  ``paged_verify_steps`` and ``paged_prefill_chunk`` (the batched lane
  chunks' int8 cases are in tests/test_torch_lanes.py). Verify under int8
  equals serial decode.
- The pools take their tensors from ``init_decode_state``; the pool<->slot
  copies and a host-tier round trip carry all four tensors bit for bit.
- Engines under ``kv_quant`` give the JAX engine's greedy streams on slot x
  {token, batched, chunked} and paged x {token, chunked}, with a prefix
  hit, through the host tier, through the dedicated lane and with a
  self-draft, and ``kv_quant`` reaches the engine through the generator.

Tolerances: scales 1e-5 relative, logits 1e-5 (f32; the frameworks sum
in other orders). int8 values equal, except that where a row's f32 scale
differs by an ulp between the two (its K/V differ by an ulp before
quantising) a value may differ by one step. Such a step moves one K or V
element by its row's scale (about 1% of the row's largest value), so once
one is present the logits of that call and of later calls on the same
state are held at FLIP_TOL, 1e-3, instead. Tokens and counters exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import decoder_lm as jlm
from client_tpu.models import transformer as jt
from client_tpu.perf.bench_harness import run_engine_jobs
from client_tpu.server import kv_cache as jkv
from client_tpu.server.generation import (
    ContinuousBatchingEngine as JaxEngine,
)
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import kv_cache as tkv
from client_tpu_torch.server.generation import ContinuousBatchingEngine

TOL = 1e-5
FLIP_TOL = 1e-3
# the reference's tiny engine config (tests/test_disagg_lanes.py), int8
KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=64, causal=True, kv_quant=True)
CONFIGS = {
    "mha": dict(KW),
    "gqa": dict(KW, n_heads=4, n_kv_heads=2, head_dim=8, ffn="swiglu"),
    "rope": dict(KW, rope=True),
}
RNG = np.random.default_rng(31)
JOBS = [(RNG.integers(0, 64, size=p).astype(np.int32), b)
        for p, b in ((37, 8), (3, 5), (50, 6), (12, 12), (29, 4),
                     (5, 7), (44, 3), (21, 9))]


def _pair(kw: dict, seed: int = 0):
    """The reference's config with the einsum attention and the port's
    with ``attn_impl="flash"`` (under kv_quant the port must not take K2
    for it), on one set of f32 weights."""
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **kw)
    jparams = jt.init_params(jax.random.key(seed), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash",
                                **kw)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    return _pair(CONFIGS[request.param], seed=3)


@pytest.fixture(scope="module")
def tiny():
    return _pair(KW)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


def _int8_close(got: dict, want: dict, sl=(slice(None),)) -> int:
    """The int8 tensors and scales of a state or pool (``sl`` picks the
    part both sides define): scales within 1e-5 relative, int8 values
    equal, or one step apart where the row's scale differs. Returns the
    count of values one step apart."""
    steps = 0
    for name in ("k", "v"):
        gq = _np(got[name])[sl].astype(np.int32)
        wq = _np(want[name])[sl].astype(np.int32)
        gs = _np(got[f"{name}_scale"])[sl]
        ws = _np(want[f"{name}_scale"])[sl]
        np.testing.assert_allclose(gs, ws, rtol=TOL, atol=0)
        diff = np.abs(gq - wq)
        assert diff.max(initial=0) <= 1, name
        assert not (diff.astype(bool) & (gs == ws)[..., None]).any(), name
        assert _np(got[name]).dtype == np.int8
        steps += int(diff.sum())
    return steps


def _tol(steps: int) -> float:
    return TOL if not steps else FLIP_TOL


# ------------------------------------------------------------- the rows

def test_int8_state_is_under_six_tenths_of_the_bytes():
    """At Dh 64 (bench.py's model) the int8 state, the paged pool and the
    slot layout's block pool hold (64 + 4) / 128 = 0.53x the bytes of
    bf16 ones."""
    kw = dict(vocab_size=64, d_model=128, n_layers=2, n_heads=2,
              head_dim=64, d_ff=64, max_seq=64)
    bf = tt.TransformerConfig(dtype=torch.bfloat16, **kw)
    i8 = dataclasses.replace(bf, kv_quant=True)

    def nbytes(tree):
        return sum(v.numel() * v.element_size() for k, v in tree.items()
                   if k != "pos")

    for build in (lambda c: tt.init_decode_state(c, 4, "cpu"),
                  lambda c: tkv.init_paged_pool(c, 9, 16, "cpu"),
                  lambda c: tkv.init_block_pool(c, 9, 16, "cpu")):
        ratio = nbytes(build(i8)) / nbytes(build(bf))
        assert ratio == pytest.approx(68 / 128)
        assert ratio < 0.6


def test_kv_quantize_matches_the_reference():
    """Random rows over six decades of scale, a zero row (the 1e-8
    floor) and rows of exact halves (0.5, 1.5, 2.5 at scale 1): the same
    int8 values (half to even) and scales, and the same dequantised f32
    and bf16 rows."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((512, 16)) * 10.0 ** rng.uniform(
        -3, 3, (512, 1))).astype(np.float32)
    halves = np.tile(np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                 3.5, 0, 0, 0, 0, 0, 0, 0, -126.5],
                                np.float32), (2, 1))
    x = np.concatenate([x, np.zeros((1, 16), np.float32), halves])
    jq, js = jt._kv_quantize(jnp.asarray(x))
    tq, ts = tt._kv_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[-1, 1:8].tolist() == [0, 2, 2, 0, -2, -2, 4]
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jt._kv_dequantize(jq, js, jd).astype(jnp.float32))
        got = tt._kv_dequantize(tq, ts, td).float().numpy()
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ slot paths

def _jax_steps(jcfg, jparams, tokens, state):
    return jax.vmap(lambda tk, st: jt.decode_step(jcfg, jparams, tk, st))(
        jnp.asarray(tokens), state)


def test_decode_step_int8_matches_the_vmapped_reference(model):
    """Three slots, six steps from an empty int8 state: logits each step,
    then the int8 rows, the scales and the positions."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(1)
    jstate = jax.vmap(lambda _: jt.init_decode_state(jcfg))(jnp.arange(3))
    tstate = tt.init_decode_state(tcfg, 3, "cpu")
    assert set(tstate) == set(jstate)
    steps = 0
    for _ in range(6):
        toks = rng.integers(0, 64, size=3).astype(np.int32)
        jl, jstate = _jax_steps(jcfg, jparams, toks, jstate)
        tl, tstate = tt.decode_step(tcfg, tparams, torch.from_numpy(toks),
                                    tstate)
        steps = _int8_close(tstate, jstate)
        _close(tl, jl, _tol(steps))
    assert tstate["pos"].tolist() == [6, 6, 6]


def test_verify_steps_int8_matches_the_reference(model):
    """Four decode steps, then a verify of 5 tokens on two of three slots
    (``rows``): the reference's vmapped verify_steps on those slots, the
    third slot's rows bit-unchanged."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(2)
    jstate = jax.vmap(lambda _: jt.init_decode_state(jcfg))(jnp.arange(3))
    tstate = tt.init_decode_state(tcfg, 3, "cpu")
    for _ in range(4):
        toks = rng.integers(0, 64, size=3).astype(np.int32)
        _, jstate = _jax_steps(jcfg, jparams, toks, jstate)
        _, tstate = tt.decode_step(tcfg, tparams, torch.from_numpy(toks),
                                   tstate)
    _int8_close(tstate, jstate)
    vt = rng.integers(0, 64, size=(2, 5)).astype(np.int32)
    rows = np.asarray([2, 0])
    sub = jax.tree.map(lambda a: a[rows], jstate)
    jl, jsub = jax.vmap(lambda tk, st: jt.verify_steps(jcfg, jparams, tk,
                                                       st))(jnp.asarray(vt),
                                                            sub)
    before = {k: v.clone() for k, v in tstate.items()}
    tl, tstate = tt.verify_steps(tcfg, tparams, torch.from_numpy(vt),
                                 tstate, rows=torch.from_numpy(rows))
    steps = _int8_close({k: v[rows] for k, v in tstate.items()}, jsub)
    _close(tl, jl, _tol(steps))
    for name in tt.kv_names(tcfg):
        assert torch.equal(tstate[name][1], before[name][1])
    assert tstate["pos"].tolist() == [9, 4, 9]


def test_verify_under_int8_equals_serial_decode(tiny):
    """The reference's round trip (tests/test_speculation.py:172): a
    verify of (3, 17, 42) from an empty int8 state ends where three
    decode steps end: the last logits within 1e-5, the same argmax, the
    same int8 rows and scales."""
    _, _, tcfg, tparams = tiny
    st = tt.init_decode_state(tcfg, 1, "cpu")
    lgs, st = tt.verify_steps(tcfg, tparams,
                              torch.tensor([[3, 17, 42]], dtype=torch.int32),
                              st)
    ref = tt.init_decode_state(tcfg, 1, "cpu")
    for tok in (3, 17, 42):
        lg, ref = tt.decode_step(tcfg, tparams,
                                 torch.tensor([tok], dtype=torch.int32), ref)
    assert int(st["pos"][0]) == 3
    _close(lgs[0, -1], lg[0])
    assert int(lgs[0, -1].argmax()) == int(lg[0].argmax())
    _int8_close({k: v[0, :, :3] for k, v in st.items() if k != "pos"},
                {k: v[0, :, :3] for k, v in ref.items() if k != "pos"})


@pytest.mark.parametrize("pad_to_max", [True, False])
def test_prefill_int8_matches_the_reference(model, pad_to_max):
    """A 21-token prompt in a bucket of 32: the int8 state (the prompt's
    own attention read the dequantised rows) and the last real logits."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(4)
    toks = np.zeros(32, np.int32)
    toks[:21] = rng.integers(0, 64, size=21)
    jst, jl = jt.prefill(jcfg, jparams, jnp.asarray(toks), 21,
                         pad_to_max=pad_to_max)
    tst, tl = tt.prefill(tcfg, tparams, torch.from_numpy(toks), 21,
                         pad_to_max=pad_to_max)
    assert set(tst) == set(jst)
    _close(tl, jl, _tol(_int8_close(tst, jst)))
    assert int(tst["pos"]) == 21


def test_prefill_chunk_int8_matches_the_reference(model):
    """A 40-token prompt in chunks of 16, 16 and 8 (padded to 16) into one
    slot's int8 rows: each chunk's logits and slab, and the slot's rows
    equal the reference's chunk-by-chunk cache."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 64, size=40).astype(np.int32)
    jcache = {k: v for k, v in jt.init_decode_state(jcfg).items()
              if k != "pos"}
    tcache = {k: v[0] for k, v in tt.init_decode_state(tcfg, 1,
                                                       "cpu").items()
              if k != "pos"}
    steps = 0
    for pos0, clen in ((0, 16), (16, 16), (32, 8)):
        chunk = np.zeros(16, np.int32)
        chunk[:clen] = prompt[pos0:pos0 + clen]
        jslab, jl = jt.prefill_chunk(jcfg, jparams, jnp.asarray(chunk),
                                     jcache, jnp.int32(pos0), clen)
        tslab, tl = tt.prefill_chunk(tcfg, tparams, torch.from_numpy(chunk),
                                     tcache, pos0, clen)
        steps += _int8_close(tslab, jslab)
        _close(tl, jl, _tol(steps))
        jcache = {name: jax.lax.dynamic_update_slice(
            arr, jslab[name], (0, pos0) + (0,) * (arr.ndim - 2))
            for name, arr in jcache.items()}
    _int8_close(tcache, jcache)


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


# ----------------------------------------------------------- paged paths

def _paged_setup(jcfg, tcfg, rng, n_slots=3, bl=8, n_blocks=26):
    width = jcfg.max_seq // bl
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = perm[:n_slots * width].reshape(n_slots, width).astype(np.int32)
    jpool = jkv.init_paged_pool(jcfg, n_blocks, bl)
    tpool = tkv.init_paged_pool(tcfg, n_blocks, bl, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tpool.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jpool.items()}
    return tables, jpool, tpool


def test_paged_decode_steps_int8_takes_the_einsum(model, monkeypatch):
    """attn_impl="flash" under kv_quant never reaches the paged decode
    kernel (spied to raise): eight steps of three slots through shuffled
    tables give the reference's logits and int8 pool."""
    jcfg, jparams, tcfg, tparams = model
    assert tcfg.attn_impl == "flash"

    def no_k2(*_a, **_k):
        raise AssertionError("the paged decode kernel read an int8 pool")

    monkeypatch.setattr(tt, "paged_decode_attention", no_k2)
    rng = np.random.default_rng(8)
    tables, jpool, tpool = _paged_setup(jcfg, tcfg, rng)
    for p in range(8):
        toks = rng.integers(0, 64, size=3).astype(np.int32)
        pos = np.asarray([p, p + 3, 2 * p], np.int32)
        jl, jpool = jt.paged_decode_steps(jcfg, jparams, jnp.asarray(toks),
                                          jnp.asarray(pos),
                                          jnp.asarray(tables), jpool)
        tl, tpool = tt.paged_decode_steps(
            tcfg, tparams, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(tables), tpool)
        steps = _int8_close(tpool, jpool, (slice(None), slice(1, None)))
        _close(tl, jl, _tol(steps))


def test_paged_decode_int8_refuses_an_attention_override(tiny):
    """An ``attention`` override reads the raw slabs: under kv_quant those
    are int8, so the call raises instead of handing them to it."""
    _, _, tcfg, tparams = tiny
    pool = tkv.init_paged_pool(tcfg, 9, 8, "cpu")
    toks = torch.zeros(2, dtype=torch.int32)
    tables = torch.ones((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int8"):
        tt.paged_decode_steps(tcfg, tparams, toks, toks, tables, pool,
                              attention=lambda *a: None)


def test_paged_verify_and_prefill_chunk_int8_match_the_reference(model):
    """paged_prefill_chunk of a 21-token prompt (16 + 5 padded to 8) into
    slot 0's table, then paged_verify_steps of 4 tokens on all three slots
    with slot 1 not writing: logits and the int8 pool."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(9)
    tables, jpool, tpool = _paged_setup(jcfg, tcfg, rng)
    prompt = rng.integers(0, 64, size=21).astype(np.int32)
    real = (slice(None), slice(1, None))
    for pos0, clen, bucket in ((0, 16, 16), (16, 5, 8)):
        chunk = np.zeros(bucket, np.int32)
        chunk[:clen] = prompt[pos0:pos0 + clen]
        jpool, jl = jt.paged_prefill_chunk(
            jcfg, jparams, jnp.asarray(chunk), jnp.asarray(tables[0]),
            jnp.int32(pos0), jpool, clen)
        tpool, tl = tt.paged_prefill_chunk(
            tcfg, tparams, torch.from_numpy(chunk),
            torch.from_numpy(tables[0]), pos0, tpool, clen)
        _close(tl, jl, _tol(_int8_close(tpool, jpool, real)))
    vt = rng.integers(0, 64, size=(3, 4)).astype(np.int32)
    pos0 = np.asarray([21, 5, 0], np.int32)
    write = np.asarray([True, False, True])
    jl, jpool = jt.paged_verify_steps(jcfg, jparams, jnp.asarray(vt),
                                      jnp.asarray(pos0), jnp.asarray(tables),
                                      jpool, jnp.asarray(write))
    tl, tpool = tt.paged_verify_steps(
        tcfg, tparams, torch.from_numpy(vt), torch.from_numpy(pos0),
        torch.from_numpy(tables), tpool, torch.from_numpy(write))
    _close(tl, jl, _tol(_int8_close(tpool, jpool, real)))


# ------------------------------------------------------------- the pools

def test_pools_carry_the_scale_tables_bit_for_bit(tiny):
    """init_block_pool / init_paged_pool take their tensors from
    init_decode_state (int8 k/v, f32 4-D scales), as the reference's do;
    a pool->slot->pool round trip through pool_to_slot and slot_to_pool
    and a host-tier spill and restore carry all four tensors bit for
    bit."""
    jcfg, _, tcfg, _ = tiny
    rng = np.random.default_rng(10)
    bpool = tkv.init_block_pool(tcfg, 6, 8, "cpu")
    want = jkv.init_block_pool(jcfg, 6, 8)
    assert {k: tuple(v.shape) for k, v in bpool.items()} == \
        {k: v.shape for k, v in want.items()}
    _fill(bpool, rng)
    state = tt.init_decode_state(tcfg, 2, "cpu")
    cache = {k: v for k, v in state.items() if k != "pos"}
    ids = torch.tensor([3, 1, 4, 0], dtype=torch.int32)
    tkv.pool_to_slot(bpool, cache, state["pos"], 1, ids, 24)
    assert int(state["pos"][1]) == 24
    for name in cache:
        for j, bid in enumerate((3, 1, 4)):
            assert torch.equal(cache[name][1][:, 8 * j:8 * j + 8],
                               bpool[name][bid])
    back = {k: torch.zeros_like(v) for k, v in bpool.items()}
    tkv.slot_to_pool(back, cache, 1, torch.tensor([2, 5]),
                     torch.tensor([0, 16]))
    for name in bpool:
        assert torch.equal(back[name][2], bpool[name][3])
        assert torch.equal(back[name][5], bpool[name][4])
    ppool = tkv.init_paged_pool(tcfg, 6, 8, "cpu")
    _fill(ppool, rng)
    for layer_major, pool in ((False, bpool), (True, ppool)):
        assert tkv.pool_block_nbytes(pool, layer_major) \
            == 2 * 2 * 8 * 2 * (16 + 4)
        rows, ready = tkv.tier_spill(pool, 3, layer_major)
        assert ready is None
        saved = {k: v.clone() for k, v in rows.items()}
        tkv.tier_restore(pool, 5, rows, layer_major)
        for name, arr in pool.items():
            src = arr[:, 3] if layer_major else arr[3]
            dst = arr[:, 5] if layer_major else arr[5]
            assert torch.equal(dst, src) and torch.equal(saved[name], src)


def _fill(pool: dict, rng) -> None:
    """Random int8 rows and positive scales into an int8 pool."""
    for name, arr in _random_kv(tuple(pool), tuple(pool["k"].shape), rng,
                                True).items():
        pool[name].copy_(torch.from_numpy(arr))


# ------------------------------------------------------------ the engines

MODES = {
    "slot_token": dict(),
    "slot_batched": dict(prefill_mode="batched"),
    "slot_chunked": dict(prefill_mode="chunked", prefill_chunk=16),
    "paged_token": dict(kv_layout="paged", kv_block_len=8),
    "paged_chunked": dict(kv_layout="paged", kv_block_len=8,
                          prefill_mode="chunked", prefill_chunk=16),
}


def _engine(side, weights, **kw):
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(n_slots=2, chunk=4, **kw)
    if side == "ref":
        return JaxEngine(jcfg, dict(jparams), **kw).start()
    return ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                    **kw).start()


def _streams(side, weights, jobs, sequential=False, **kw) -> dict:
    eng = _engine(side, weights, **kw)
    try:
        if sequential:
            toks = [list(eng.submit(p, b)) for p, b in jobs]
        else:
            _, _, toks = run_engine_jobs(eng, jobs, collect=True,
                                         join_timeout_s=120)
        snap = eng.gen_stats.snapshot()
        tier = (eng._kv_index.tier_snapshot()
                if eng._kv_index is not None else None)
        lane = eng.stats()["prefill_lane"]
        return {"tokens": toks, "prefix_hits": snap["prefix_hits"],
                "tier_hits": snap["tier_hits"],
                "tier": None if tier is None else (tier["spills"],
                                                   tier["restores"]),
                "handoffs": lane and lane.get("handoffs")}
    finally:
        eng.stop()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_int8_engines_match_the_jax_engine(tiny, mode):
    """The reference's ragged jobs together under kv_quant: greedy
    streams identical to the JAX engine's in the same configuration."""
    got = _streams("port", tiny, JOBS, **MODES[mode])
    want = _streams("ref", tiny, JOBS, **MODES[mode])
    assert got["tokens"] == want["tokens"]


SHARED = list(range(1, 33))


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_int8_prefix_hit_matches_the_jax_engine(tiny, layout):
    """Two prompts sharing 32 tokens one after another: the second
    restores (slot: pool_to_slot of the int8 blocks and their scales) or
    shares (paged) the first's committed chain; streams and the hit equal
    the JAX engine's (tests/test_prefix_cache.py:332's case)."""
    kw = dict(prefix_cache=True, prefix_block_len=8)
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block_len=8)
    jobs = [(np.asarray(SHARED + [1], np.int32), 5),
            (np.asarray(SHARED + [2], np.int32), 5)]
    got = _streams("port", tiny, jobs, sequential=True, **kw)
    assert got == _streams("ref", tiny, jobs, sequential=True, **kw)
    assert got["prefix_hits"] == 1


def _families() -> list:
    return [(((np.arange(0, 41) + off) % 64).astype(np.int32), 8)
            for off in (0, 7, 19, 0, 7, 0)]


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_int8_tier_cycle_matches_the_jax_engine(tiny, layout):
    """Three families cycled A B C A B A through a pool of 14 blocks with a
    host tier: int8 blocks and their scales spill and restore bit for bit,
    so the streams are the tier-less run's, and the spills, restores and
    tier hits are the JAX engine's."""
    kw = dict(prefix_cache=True, prefix_block_len=8)
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block_len=8, kv_pool_blocks=14,
                  prefill_mode="chunked", prefill_chunk=16)
    else:
        kw.update(prefix_blocks=14)
    got = _streams("port", tiny, _families(), sequential=True,
                   host_tier_bytes=1 << 22, **kw)
    want = _streams("ref", tiny, _families(), sequential=True,
                    host_tier_bytes=1 << 22, **kw)
    assert got == want
    assert got["tier"][0] > 0 and got["tier"][1] > 0 and got["tier_hits"] > 0
    plain = _streams("port", tiny, _families(), sequential=True, **kw)
    assert got["tokens"] == plain["tokens"]


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_int8_lane_matches_the_jax_engine(tiny, layout):
    """The dedicated lane under kv_quant (slot: its int8 rows commit to
    the pool with their scales and restore into the decode slot; paged:
    the int8 blocks' table moves), batched: the JAX engine's streams and
    handoffs."""
    kw = dict(prefill_mode="chunked", prefill_chunk=16, prefill_slots=2,
              prefill_lane_width=16, prefill_lane_batch=2, prefix_cache=True,
              prefix_block_len=8)
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block_len=8)
    got = _streams("port", tiny, JOBS, **kw)
    want = _streams("ref", tiny, JOBS, **kw)
    assert got["tokens"] == want["tokens"]
    assert got["handoffs"] == want["handoffs"] > 0


def test_int8_speculation_keeps_the_greedy_streams(tiny):
    """A self-draft on an int8 target (the draft's own cache int8 as
    well): verify rounds write and read the int8 cache, and the greedy
    streams are the JAX engine's without speculation."""
    from client_tpu_torch.server.speculation import DraftModel

    _, _, tcfg, tparams = tiny
    eng = _engine("port", tiny, speculative_draft=DraftModel(tcfg, tparams),
                  speculative_gamma=3)
    try:
        toks = [list(eng.submit(p, b)) for p, b in JOBS[:4]]
        spec = eng.stats()["speculation"]
    finally:
        eng.stop()
    assert toks == _streams("ref", tiny, JOBS[:4], sequential=True)["tokens"]
    assert spec["rounds"] > 0 and spec["accepted"] == spec["proposed"]


def test_kv_quant_reaches_the_engine_through_the_generator(tiny):
    """make_continuous_generator on an int8 config builds an engine whose
    state is int8 with scale tables, serves the JAX generator's stream,
    and advertises the JAX generator's engine block."""
    jcfg, jparams, tcfg, tparams = tiny
    kw = dict(n_slots=2, chunk_size=4, kv_layout="paged", kv_block_len=8)
    ref = jlm.make_continuous_generator("lm", cfg=jcfg, params=dict(jparams),
                                        **kw)
    port = tlm.make_continuous_generator("lm", cfg=tcfg, params=tparams,
                                         device="cpu", **kw)
    try:
        prompt = np.asarray(JOBS[0][0], np.int32)
        assert list(port.engine.submit(prompt, 6)) \
            == list(ref.engine.submit(prompt, 6))
        pool = port.engine._dev["pool"]
        assert pool["k"].dtype == torch.int8 and "v_scale" in pool
        want = ref.config.to_json()["generation_engine"]
        got = port.config.to_json()["generation_engine"]
        assert got == {k: want[k] for k in got}
    finally:
        ref.engine.stop()
        port.engine.stop()
