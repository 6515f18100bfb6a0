"""Parity of the port's paged decode path with the JAX package's, on the
CPU, in f32 at small widths: the paged decode attention kernel's plain
version (client_tpu_torch.ops.paged_attention) against the Pallas kernel
in interpret mode, ``paged_decode_steps`` against the reference's, and the
token ring, pool and allocator helpers.

On the CPU the K2 wrapper takes its plain version (the tensors lie on the
CPU); the CUDA kernel itself is held against that plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import transformer as jt
from client_tpu.ops.paged_attention import paged_decode_attention as jax_k2
from client_tpu.server import kv_cache as jkv
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.ops import paged_attention as pa
from client_tpu_torch.server import kv_cache as tkv

# the JAX suite's own tolerance for the Pallas kernel against its
# reference (tests/test_paged_attention.py:302): f32, sums in other orders
K2_ATOL = 1e-5
# f32 logits after 2 layers and a vocab-wide product (the forward
# parity tests' tolerance)
LOGITS_ATOL = 1e-4
# f32 K/V rows written into the pool: one projection of the same inputs
POOL_ATOL = 1e-5

# (S, H, Hkv, Dh, block_len, N, B, positions)
K2_CASES = {
    # tests/test_paged_attention.py:283-291
    "jax_suite": (3, 4, 2, 16, 4, 32, 6, [0, 7, 21]),
    "mha": (3, 4, 4, 16, 4, 32, 6, [2, 13, 23]),
    # the last row of block 0, the first of block 1, the first of block 2
    "block_edge": (3, 4, 2, 16, 4, 32, 6, [3, 4, 8]),
    # positions at and past B*bl (= 24): every table row is live
    "past_table": (3, 4, 2, 16, 4, 32, 6, [23, 24, 50]),
    "wide_group": (2, 8, 2, 32, 8, 16, 3, [5, 17]),
}


def _k2_inputs(case, seed=5):
    s, h, hkv, dh, bl, n, b, pos = K2_CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(s, h, dh)).astype(np.float32)
    kp = rng.normal(size=(n, bl, hkv, dh)).astype(np.float32)
    vp = rng.normal(size=(n, bl, hkv, dh)).astype(np.float32)
    tables = rng.integers(1, n, size=(s, b)).astype(np.int32)
    return q, kp, vp, tables, np.asarray(pos, np.int32)


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_plain_version_matches_pallas_kernel(case):
    arrays = _k2_inputs(case)
    want = np.asarray(jax_k2(*(jnp.asarray(a) for a in arrays),
                             interpret=True))
    got = pa.paged_decode_attention(*(torch.from_numpy(a) for a in arrays))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=K2_ATOL)


def _split_merge(q, kp, vp, tables, pos, n_ctas):
    """K2's split of each slot's table over a cluster of ``n_ctas`` CTAs, in
    plain PyTorch: CTA c takes the contiguous share
    [c * per, (c + 1) * per) of the slot's live blocks (per = ceil(live /
    n_ctas)), scores it in one pass (logits scaled and masked to -1e30
    past the position, its max starting at -1e30, f32 probabilities) and
    keeps (m, l, acc); the merge weights each CTA's state by exp(m_c -
    max m), so a CTA with no live block (m = -1e30, l = 0, acc = 0) adds
    exactly zero, and divides once."""
    s, h, dh = q.shape
    bl, hkv = kp.shape[1], kp.shape[2]
    r = h // hkv
    width = tables.shape[1]
    out = torch.empty((s, hkv, r, dh))
    for slot in range(s):
        p = int(pos[slot])
        live = 0 if p < 0 else min(p // bl + 1, width)
        per = -(-live // n_ctas)
        qg = q[slot].float().reshape(hkv, r, dh)
        states = []
        for c in range(n_ctas):
            b0 = min(c * per, live)
            b1 = min(b0 + per, live)
            m = torch.full((hkv, r), pa.MASK_VALUE)
            l = torch.zeros((hkv, r))
            acc = torch.zeros((hkv, r, dh))
            if b1 > b0:
                ids = tables[slot, b0:b1].long()
                k = kp[ids].float().reshape(-1, hkv, dh)
                v = vp[ids].float().reshape(-1, hkv, dh)
                logits = torch.einsum("grd,tgd->grt", qg, k) * dh ** -0.5
                t_pos = b0 * bl + torch.arange(k.shape[0])
                logits = torch.where(t_pos <= p, logits,
                                     torch.full_like(logits, pa.MASK_VALUE))
                m = torch.maximum(m, logits.amax(dim=-1))
                prob = torch.exp(logits - m[..., None])
                l = prob.sum(dim=-1)
                acc = torch.einsum("grt,tgd->grd", prob, v)
            states.append((m, l, acc))
        top = torch.stack([m for m, _, _ in states]).amax(dim=0)
        num = torch.zeros((hkv, r, dh))
        den = torch.zeros((hkv, r))
        for m, l, acc in states:
            w = torch.exp(m - top)
            num = num + w[..., None] * acc
            den = den + w * l
        out[slot] = num / den[..., None]
    return out.reshape(s, h, dh)


@functools.lru_cache(maxsize=None)
def _pallas_k2(case):
    return np.asarray(jax_k2(*(jnp.asarray(a) for a in _k2_inputs(case)),
                             interpret=True))


@pytest.mark.parametrize("n_ctas", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_cluster_split_merge_matches_pallas_kernel(case, n_ctas):
    """The algebra of the card kernel's split over a thread-block cluster
    (shares empty, uneven and whole) equals the Pallas kernel's sequential
    sweep and the plain version, in f32."""
    arrays = [torch.from_numpy(a) for a in _k2_inputs(case)]
    got = _split_merge(*arrays, n_ctas)
    np.testing.assert_allclose(got.numpy(), _pallas_k2(case), rtol=0,
                               atol=K2_ATOL)
    want = pa.paged_decode_attention_reference(*arrays)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=K2_ATOL)


def test_k2_reads_strided_views_of_a_layer_major_pool():
    """One layer's slabs of a [L, N, bl, Hkv, Dh] pool, and a bf16 call
    that returns q's dtype."""
    q, kp, vp, tables, pos = _k2_inputs("jax_suite")
    big_k = torch.zeros((3,) + kp.shape)
    big_v = torch.zeros((3,) + vp.shape)
    big_k[1], big_v[1] = torch.from_numpy(kp), torch.from_numpy(vp)
    args = (torch.from_numpy(tables), torch.from_numpy(pos))
    got = pa.paged_decode_attention(torch.from_numpy(q), big_k[1], big_v[1],
                                    *args)
    want = pa.paged_decode_attention(torch.from_numpy(q),
                                     torch.from_numpy(kp),
                                     torch.from_numpy(vp), *args)
    assert torch.equal(got, want)
    bf = pa.paged_decode_attention(torch.from_numpy(q).bfloat16(),
                                   big_k[1].bfloat16(), big_v[1].bfloat16(),
                                   *args)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf.float(), want, rtol=0, atol=3e-2)


def test_k2_wrapper_checks_its_inputs():
    q, kp, vp, tables, pos = (torch.from_numpy(a)
                              for a in _k2_inputs("jax_suite"))
    with pytest.raises(TypeError, match="int32"):
        pa.paged_decode_attention(q, kp, vp, tables.long(), pos)
    with pytest.raises(ValueError, match="multiple"):
        pa.paged_decode_attention(q[:, :3], kp, vp, tables, pos)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention(q, kp[..., :8], vp[..., :8], tables, pos)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pa.paged_decode_attention(q.half(), kp.half(), vp.half(), tables,
                                  pos)


def test_k2_launch_counter_counts_kernel_launches_only():
    """On the CPU the wrapper takes the plain version: no launch."""
    before = pa.launches
    pa.paged_decode_attention(*(torch.from_numpy(a)
                                for a in _k2_inputs("mha")))
    assert pa.launches == before


# ---------------------------------------------------------------- decode step

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=16,
             d_ff=64, max_seq=32, causal=True)
VARIANTS = {"mha": {}, "rope_gqa": {"rope": True, "n_kv_heads": 2}}


def _decode_setup(variant):
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref",
                                **SMALL, **VARIANTS[variant])
    jparams = jt.init_params(jax.random.key(1), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    return jcfg, jparams, tparams


def _decode_inputs(steps=6):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 64, size=(steps, 3)).astype(np.int32)
    # slot 0 from 0, slot 1 across block edges from 5, slot 2 inactive (pos
    # 0 on an all-scratch table)
    pos0 = np.asarray([0, 5, 0], np.int32)
    step_pos = np.stack([pos0 + np.asarray([i, i, 0]) for i in range(steps)])
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    return toks, step_pos.astype(np.int32), tables


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("jax_impl", ["ref", "flash"])
def test_paged_decode_steps_match_jax(variant, jax_impl):
    """The port's step (``flash``: K2's plain version on the CPU, and
    ``ref``) against the reference's (``ref``, and ``flash``, which runs
    the Pallas kernel in interpret mode inside jit on the CPU): the same
    logits at every step and the same rows written into the pool."""
    jcfg, jparams, tparams = _decode_setup(variant)
    jcfg = jt.TransformerConfig(**{**jcfg.__dict__, "attn_impl": jax_impl})
    toks, step_pos, tables = _decode_inputs()
    jstep = jax.jit(lambda p, tk, ps, tb, pl: jt.paged_decode_steps(
        jcfg, p, tk, ps, tb, pl))
    jpool = jkv.init_paged_pool(jcfg, 16, 4)
    want = []
    for tk, ps in zip(toks, step_pos):
        lg, jpool = jstep(jparams, jnp.asarray(tk), jnp.asarray(ps),
                          jnp.asarray(tables), jpool)
        want.append(np.asarray(lg))
    for impl in ("flash", "ref"):
        tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl=impl,
                                    **SMALL, **VARIANTS[variant])
        tpool = tkv.init_paged_pool(tcfg, 16, 4, "cpu")
        for i, (tk, ps) in enumerate(zip(toks, step_pos)):
            lg, tpool = tt.paged_decode_steps(
                tcfg, tparams, torch.from_numpy(tk), torch.from_numpy(ps),
                torch.from_numpy(tables), tpool)
            assert lg.shape == (3, 64) and lg.dtype == torch.float32
            np.testing.assert_allclose(lg.numpy(), want[i], rtol=0,
                                       atol=LOGITS_ATOL)
        for name in ("k", "v"):
            got, ref = tpool[name].numpy(), np.asarray(jpool[name])
            # the same rows written (blocks 1-8 and scratch block 0) ...
            assert np.array_equal(np.abs(got).sum(-1).sum(-1) > 0,
                                  np.abs(ref).sum(-1).sum(-1) > 0)
            # ... with the same values
            np.testing.assert_allclose(got, ref, rtol=0, atol=POOL_ATOL)


def test_positions_past_the_table_clamp_onto_the_last_entry():
    """A position past B*bl writes the last table entry's block at
    pos % bl, as the reference's clip does, and its embedding row is the
    last one (pos_embed clamps like the reference's gather)."""
    jcfg, jparams, tparams = _decode_setup("mha")
    tables = np.asarray([[1, 2]], np.int32)     # covers positions 0..7
    tk, ps = np.asarray([7], np.int32), np.asarray([41], np.int32)
    jpool = jkv.init_paged_pool(jcfg, 4, 4)
    want, jpool = jt.paged_decode_steps(jcfg, jparams, jnp.asarray(tk),
                                        jnp.asarray(ps), jnp.asarray(tables),
                                        jpool)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **SMALL)
    tpool = tkv.init_paged_pool(tcfg, 4, 4, "cpu")
    got, tpool = tt.paged_decode_steps(tcfg, tparams, torch.from_numpy(tk),
                                       torch.from_numpy(ps),
                                       torch.from_numpy(tables), tpool)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGITS_ATOL)
    written = np.argwhere(np.abs(tpool["k"].numpy()).sum((-1, -2)) > 0)
    assert {(int(b), int(r)) for _, b, r in written} == {(2, 41 % 4)}


# ---------------------------------------------------------------- ring, pool

def test_emit_into_ring_matches_jax():
    rng = np.random.default_rng(0)
    ring = rng.integers(0, 9, size=(4, 3, 6)).astype(np.int32)
    cnt = rng.integers(0, 9, size=(4, 3)).astype(np.int32)
    toks = rng.integers(10, 99, size=(3, 4)).astype(np.int32)
    n = np.asarray([4, 0, 2], np.int32)
    want_r, want_c = jt.emit_into_ring(jnp.asarray(ring), jnp.asarray(cnt),
                                       jnp.int32(2), jnp.asarray(toks),
                                       jnp.asarray(n))
    tr, tc = torch.from_numpy(ring.copy()), torch.from_numpy(cnt.copy())
    got_r, got_c = tt.emit_into_ring(tr, tc, 2, torch.from_numpy(toks),
                                     torch.from_numpy(n))
    assert got_r is tr and got_c is tc      # in place
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_paged_pool_matches_jax_layout(variant):
    jcfg, _, _ = _decode_setup(variant)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **SMALL,
                                **VARIANTS[variant])
    want = jkv.init_paged_pool(jcfg, 7, 4)
    got = tkv.init_paged_pool(tcfg, 7, 4, "cpu")
    assert set(got) == set(want) == {"k", "v"}
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        assert got[name].dtype == torch.float32
        assert not got[name].any()
    assert tuple(tt.init_paged_state(5, "cpu")["pos"].shape) == (5,)


def test_init_paged_state_takes_the_card_unless_asked():
    """Without a device the state goes to the card, so without CUDA the
    call raises; ``device="cpu"`` puts it on the CPU."""
    state = tt.init_paged_state(3, device="cpu")
    assert state["pos"].device.type == "cpu"
    assert state["pos"].dtype == torch.int32 and not state["pos"].any()
    if torch.cuda.is_available():
        assert tt.init_paged_state(3)["pos"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.init_paged_state(3)


@pytest.mark.parametrize("args", [(12,), (16,), (1,), (5, 2), (64, 8, 8),
                                  (48, 8, 16)])
def test_block_count_buckets_match_jax(args):
    assert tkv.block_count_buckets(*args) == jkv.block_count_buckets(*args)


def test_pad_block_ids_matches_jax():
    assert np.array_equal(tkv.pad_block_ids([3, 9], 4),
                          jkv.pad_block_ids([3, 9], 4))


class TestPagedAllocator:
    """The allocator half of ``RadixBlockIndex``, on the reference's own
    accounting cases (tests/test_paged_attention.py:309)."""

    @pytest.mark.parametrize("impl", ["port", "jax"])
    def test_reserve_alloc_free_accounting(self, impl):
        mod = tkv if impl == "port" else jkv
        ix = mod.RadixBlockIndex(10, 4)
        assert ix.usable_blocks == 9
        assert ix.reserve(4)
        occ = ix.occupancy()
        assert occ["reserved"] == 4 and occ["free"] == 9
        got = ix.alloc(3)
        assert len(got) == 3 and len(set(got)) == 3 and 0 not in got
        occ = ix.occupancy()
        assert occ["free"] == 6 and occ["reserved"] == 1
        assert occ["stream"] == 3
        ix.unreserve(1)
        ix.free(got)
        occ = ix.occupancy()
        assert occ["free"] == 9 and occ["reserved"] == 0
        assert occ["stream"] == 0

    def test_reserve_beyond_capacity_fails(self):
        ix = tkv.RadixBlockIndex(10, 4)
        assert not ix.reserve(10)
        assert ix.reserve(9)
        assert not ix.reserve(1)  # everything promised

    def test_alloc_hands_out_low_ids_first_like_the_reference(self):
        port, ref = tkv.RadixBlockIndex(8, 2), jkv.RadixBlockIndex(8, 2)
        for ix in (port, ref):
            assert ix.reserve(5)
        assert port.alloc(3) == ref.alloc(3) == [1, 2, 3]
        port.free([2])
        ref.free([2])
        assert port.alloc(2) == ref.alloc(2)

    def test_alloc_outside_a_reservation_raises(self):
        ix = tkv.RadixBlockIndex(3, 4)
        with pytest.raises(RuntimeError, match="outside a reservation"):
            ix.alloc(3)
        with pytest.raises(ValueError):
            tkv.RadixBlockIndex(1, 4)
