"""The port's slot-layout decode and prefill paths (client_tpu_torch.models.
transformer) against the JAX package's, on the CPU.

The same f32 weights (``params_from_jax``) and the same numpy inputs from a
seed go through both: ``decode_step`` batched over slots against
``jax.vmap(decode_step)``, ``prefill`` with and without ``pad_to_max``,
``prefill_chunk`` resumed over three chunks against one ``prefill``, and
``paged_prefill_chunk`` through a shuffled block table. Three tiny
configurations: plain attention, grouped queries (with swiglu), rope.
Tolerance 1e-5 everywhere (f32; the two frameworks sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import transformer as jt
from client_tpu_torch.models import transformer as tt

TOL = 1e-5
BASE = dict(vocab_size=64, d_model=32, n_layers=2, d_ff=64, max_seq=64,
            causal=True)
CONFIGS = {
    "mha": dict(n_heads=2, head_dim=16),
    "gqa": dict(n_heads=4, n_kv_heads=2, head_dim=8, ffn="swiglu"),
    "rope": dict(n_heads=2, head_dim=16, rope=True),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    kw = {**BASE, **CONFIGS[request.param]}
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **kw)
    jparams = jt.init_params(jax.random.key(3), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="ref", **kw)
    return jcfg, jparams, tcfg, tparams


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def test_init_decode_state_holds_the_vmapped_reference_state(model):
    jcfg, _, tcfg, _ = model
    want = jax.vmap(lambda _: jt.init_decode_state(jcfg))(jnp.arange(3))
    got = tt.init_decode_state(tcfg, 3, device="cpu")
    for name in ("k", "v", "pos"):
        assert tuple(got[name].shape) == want[name].shape
        _close(got[name], want[name], 0)
    assert got["pos"].dtype == torch.int32


def test_decode_step_batched_matches_the_vmapped_reference(model):
    """Four slots at positions 0, 17, max_seq - 1 and max_seq (a slot past
    its budget in its last chunk: the write and the position gather
    clamp), over random caches; two steps, logits and caches compared."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(0)
    shape = (4, jcfg.n_layers, jcfg.max_seq, jcfg.kv_heads, jcfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    pos = np.asarray([0, 17, jcfg.max_seq - 1, jcfg.max_seq], np.int32)
    jstate = {"k": jnp.asarray(k), "v": jnp.asarray(v),
              "pos": jnp.asarray(pos)}
    tstate = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
              "pos": torch.from_numpy(pos.copy())}
    step = jax.vmap(lambda tok, st: jt.decode_step(jcfg, jparams, tok, st))
    for _ in range(2):
        toks = rng.integers(0, jcfg.vocab_size, size=4).astype(np.int32)
        jlogits, jstate = step(jnp.asarray(toks), jstate)
        tlogits, tstate = tt.decode_step(tcfg, tparams,
                                         torch.from_numpy(toks), tstate)
        _close(tlogits, jlogits)
        for name in ("k", "v"):
            _close(tstate[name], jstate[name])
        _close(tstate["pos"], jstate["pos"], 0)


@pytest.mark.parametrize("pad_to_max", [True, False])
def test_prefill_matches_the_reference(model, pad_to_max):
    """A 20-token prompt padded to a bucket of 32."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(1)
    toks = np.zeros(32, np.int32)
    toks[:20] = rng.integers(0, jcfg.vocab_size, size=20)
    jstate, jlogits = jt.prefill(jcfg, jparams, jnp.asarray(toks), 20,
                                 pad_to_max=pad_to_max)
    tstate, tlogits = tt.prefill(tcfg, tparams, torch.from_numpy(toks), 20,
                                 pad_to_max=pad_to_max)
    _close(tlogits, jlogits)
    rows = jcfg.max_seq if pad_to_max else 32
    for name in ("k", "v"):
        assert tuple(tstate[name].shape) == (jcfg.n_layers, rows,
                                             jcfg.kv_heads, jcfg.head_dim)
        _close(tstate[name], jstate[name])
    assert int(tstate["pos"]) == int(jstate["pos"]) == 20


def test_prefill_chunk_resumed_over_three_chunks_matches_one_prefill(model):
    """A 40-token prompt in chunks of 16, 16 and 8 (the last padded to a
    bucket of 16): each chunk's slab and logits equal the reference's
    prefill_chunk, and the resumed rows and final logits equal one
    reference prefill of the whole prompt."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab_size, size=40).astype(np.int32)
    shape = (jcfg.n_layers, jcfg.max_seq, jcfg.kv_heads, jcfg.head_dim)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for pos0, clen in ((0, 16), (16, 16), (32, 8)):
        chunk = np.zeros(16, np.int32)
        chunk[:clen] = prompt[pos0:pos0 + clen]
        jslab, jlogits = jt.prefill_chunk(jcfg, jparams, jnp.asarray(chunk),
                                          jcache, jnp.int32(pos0), clen)
        tslab, tlogits = tt.prefill_chunk(tcfg, tparams,
                                          torch.from_numpy(chunk), tcache,
                                          pos0, clen)
        _close(tlogits, jlogits)
        for name in ("k", "v"):
            _close(tslab[name], jslab[name])
            jcache[name] = jax.lax.dynamic_update_slice(
                jcache[name], jslab[name], (0, pos0, 0, 0))
            # the port wrote the chunk's rows into the slot in place
            _close(tcache[name][:, pos0:pos0 + 16], jslab[name])
    whole, wlogits = jt.prefill(jcfg, jparams, jnp.asarray(prompt))
    _close(tlogits, wlogits)
    for name in ("k", "v"):
        _close(tcache[name][:, :40], whole[name][:, :40])


def test_paged_prefill_chunk_through_a_shuffled_table(model):
    """The same prompt through one slot's full-width table of shuffled
    pool blocks, three chunks, the later blocks unallocated (scratch):
    logits equal the reference's paged_prefill_chunk, and the pool rows
    read back through the table equal the reference's."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(3)
    bl, n_blocks = 8, 24
    width = jcfg.max_seq // bl
    table = np.zeros(width, np.int32)
    table[:5] = rng.permutation(np.arange(1, n_blocks))[:5]  # 40 rows
    prompt = rng.integers(0, jcfg.vocab_size, size=40).astype(np.int32)
    shape = (jcfg.n_layers, n_blocks, bl, jcfg.kv_heads, jcfg.head_dim)
    jpool = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tpool = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for pos0, clen in ((0, 16), (16, 16), (32, 8)):
        chunk = np.zeros(16, np.int32)
        chunk[:clen] = prompt[pos0:pos0 + clen]
        jpool, jlogits = jt.paged_prefill_chunk(
            jcfg, jparams, jnp.asarray(chunk), jnp.asarray(table),
            jnp.int32(pos0), jpool, clen)
        tpool, tlogits = tt.paged_prefill_chunk(
            tcfg, tparams, torch.from_numpy(chunk), torch.from_numpy(table),
            pos0, tpool, clen)
        _close(tlogits, jlogits)
    live = table[:5]
    for name in ("k", "v"):
        _close(tpool[name][:, live], np.asarray(jpool[name])[:, live])
