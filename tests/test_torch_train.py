"""The port's training path on one device (client_tpu_torch.ops.moe, the
MoE, remat and ring parts of models/transformer.py, loss_fn,
value_and_grad, AdamW and make_train_step), held against the JAX package
on the CPU with seeded numpy inputs and weights carried by
``params_from_jax``, in f32:

- ``moe_ffn`` out and aux at rtol 1e-5 / atol 1e-6: full capacity, a
  partial capacity and the reference test's drop case (exactly 2 rows out
  of 8 non-zero); ``moe_ffn_sharded`` without a mesh equals ``moe_ffn``
  bit for bit;
- the MoE forward's logits at rtol 1e-4 / atol 1e-5 and aux at rtol 1e-5;
  ``loss_fn`` at rtol 1e-5; every gradient leaf against ``jax.grad`` at
  rtol 1e-4 / atol 1e-5;
- three ``make_train_step`` steps at lr 1e-2 on TINY
  (tests/test_transformer.py:17), its MoE variant and the llama-family
  config (tests/test_llama_family.py:11): losses at rtol 1e-4, parameters
  as ``torch_parallel_ranks.close_params`` holds them;
- one AdamW update against ``optax.adamw`` at its defaults;
- ``remat`` equal to no remat at atol 1e-6; ``"ring"`` without a mesh is
  the plain attention, as in the reference;
- every decode, prefill and verify entry raises the reference's
  ``NotImplementedError`` for an MoE config; ``attn_impl="flash"`` in a
  train step raises ``ValueError``; the MoE FLOP and byte terms.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from client_tpu.models import transformer as jt
from client_tpu.ops.moe import moe_ffn as j_moe
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.ops.moe import moe_ffn, moe_ffn_sharded
from client_tpu_torch.ops.ring_attention import ring_attention_local
from client_tpu_torch.ops.attention import mha_attention
from torch_parallel_ranks import close_params

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8,
            d_ff=64, max_seq=32)
CONFIGS = {
    "tiny": TINY,
    "moe": dict(TINY, n_experts=4),
    "llama": dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                  head_dim=16, d_ff=64, max_seq=32, n_kv_heads=2, rope=True,
                  ffn="swiglu"),
}


def _pair(kw, seed=1, **extra):
    kw = {**kw, **extra}
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **kw)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="ref", **kw)
    jparams = jt.init_params(jax.random.key(seed), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    return jcfg, jparams, tcfg, tparams


def _tokens(seed=3, shape=(4, 17)):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(
        np.int32)


def _close_tree(want, got, **tol):
    if isinstance(want, dict):
        assert set(want) == set(got)
        for k in want:
            _close_tree(want[k], got[k], **tol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _np(tree):
    return tt._tree_map(lambda t: t.detach().numpy(), tree)


# ---------------------------------------------------------------- moe_ffn

def _moe_inputs(t=16, d=8, e=4, f=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, d)).astype(np.float32),
            rng.standard_normal((d, e)).astype(np.float32),
            (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32),
            (rng.standard_normal((e, f, d)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("capacity_factor", [16.0, 1.0, 0.5])
def test_moe_ffn_matches_the_reference(capacity_factor):
    arrays = _moe_inputs()
    jout, jaux = j_moe(*map(jnp.asarray, arrays), capacity_factor)
    tout, taux = moe_ffn(*map(torch.from_numpy, arrays), capacity_factor)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-6)
    assert float(taux) > 0


def test_moe_capacity_drops_tokens_like_the_reference():
    t, d, e, f = 8, 4, 2, 8
    x = np.ones((t, d), np.float32)        # all tokens route identically
    router = np.zeros((d, e), np.float32)
    router[0, 0] = 1.0
    w1 = np.ones((e, d, f), np.float32)
    w2 = np.ones((e, f, d), np.float32)
    jout, _ = j_moe(*map(jnp.asarray, (x, router, w1, w2)), 0.5)
    tout, _ = moe_ffn(*map(torch.from_numpy, (x, router, w1, w2)), 0.5)
    # capacity = (8 / 2) * 0.5 = 2: exactly 2 tokens produce output
    assert int((tout != 0).any(dim=-1).sum()) == 2
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)


def test_the_sharded_moe_without_a_mesh_is_moe_ffn_bit_for_bit():
    x, router, w1, w2 = map(torch.from_numpy, _moe_inputs())
    for cf in (16.0, 0.5):
        out, aux = moe_ffn(x, router, w1, w2, cf)
        out2, aux2 = moe_ffn_sharded(x.reshape(2, 8, -1), router, w1, w2, cf,
                                     None)
        assert torch.equal(out2.reshape(out.shape), out)
        assert torch.equal(aux2, aux)


# ---------------------------------------------------------------- forward, loss

def test_moe_layout_forward_and_aux_match_the_reference():
    jcfg, jparams, tcfg, tparams = _pair(CONFIGS["moe"])
    shapes = tt._tree_map(lambda t: tuple(t.shape), tt.init_params(
        torch.Generator().manual_seed(0), tcfg))
    assert shapes == tt._tree_map(lambda t: tuple(t.shape), tparams)
    assert {"router", "we1", "we2"} <= set(tparams["layers"])
    assert "w1" not in tparams["layers"]
    toks = _tokens(shape=(2, 16))
    jl, ja = jax.jit(lambda p: jt.forward(jcfg, p, jnp.asarray(toks)))(
        jparams)
    tl, ta = tt.forward(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    assert float(ta) > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_every_gradient_leaf_match_jax_grad(name):
    jcfg, jparams, tcfg, tparams = _pair(CONFIGS[name])
    toks = _tokens()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, jnp.asarray(toks))))(jparams)
    tloss = tt.loss_fn(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    loss, grads = tt.value_and_grad(tcfg, tparams, torch.from_numpy(toks))
    assert float(loss) == float(tloss)
    _close_tree(jax.tree.map(np.asarray, jgrads), _np(grads), rtol=1e-4,
                atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_three_train_steps_match_the_reference(name):
    jcfg, jparams, tcfg, tparams = _pair(CONFIGS[name], seed=2)
    toks = _tokens(seed=5)
    jinit, jstep = jt.make_train_step(jcfg, learning_rate=1e-2)
    jstate = jinit(jax.random.key(2))
    tinit, tstep = tt.make_train_step(tcfg, learning_rate=1e-2)
    tstate = tt.init_state_from_params(tcfg, tparams)
    first_grads = jax.jit(jax.grad(
        lambda p: jt.loss_fn(jcfg, p, jnp.asarray(toks))))(jparams)
    jl, tl = [], []
    for _ in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert int(tstate["step"]) == 3 and int(jstate["step"]) == 3
    close_params(jax.tree.map(np.asarray, jstate["params"]),
                 _np(tstate["params"]),
                 jax.tree.map(np.asarray, first_grads), 1e-2, 3)


def test_init_state_has_the_references_keys_and_draws_from_the_generator():
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="ref", **TINY)
    init_state, _ = tt.make_train_step(tcfg)
    a = init_state(torch.Generator().manual_seed(7))
    b = init_state(torch.Generator().manual_seed(7))
    assert set(a) == {"params", "opt", "step"}
    assert int(a["step"]) == 0
    assert torch.equal(a["params"]["embed"], b["params"]["embed"])
    assert set(a["opt"]) == {"count", "mu", "nu"}
    assert float(a["opt"]["mu"]["embed"].abs().sum()) == 0.0


def test_one_adamw_update_matches_optax_adamw():
    rng = np.random.default_rng(11)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    jopt = optax.adamw(3e-3)
    jstate = jopt.init(jax.tree.map(jnp.asarray, params))
    topt = tt.AdamW(3e-3)
    tparams = tt._tree_map(torch.from_numpy, params)
    tstate = topt.init(tparams)
    jp = jax.tree.map(jnp.asarray, params)
    for step in range(3):
        grads = jax.tree.map(
            lambda p, s=step: (np.random.default_rng(s).standard_normal(
                p.shape) * 10.0 ** -s).astype(np.float32), params)
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                 jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = topt.update(tt._tree_map(torch.from_numpy, grads),
                                 tstate, tparams)
        tparams = tt.apply_updates(tparams, tu)
    _close_tree(jax.tree.map(np.asarray, jp), _np(tparams), rtol=1e-6,
                atol=1e-7)
    assert int(tstate["count"]) == 3
    assert tt.AdamW.WEIGHT_DECAY == 1e-4


# ---------------------------------------------------------------- remat, ring

@pytest.mark.parametrize("name", ["tiny", "moe"])
def test_remat_equals_no_remat(name):
    _, _, tcfg, tparams = _pair(CONFIGS[name])
    toks = torch.from_numpy(_tokens())
    loss, grads = tt.value_and_grad(tcfg, tparams, toks)
    rloss, rgrads = tt.value_and_grad(dataclasses.replace(tcfg, remat=True),
                                      tparams, toks)
    np.testing.assert_allclose(float(rloss), float(loss), atol=1e-6)
    _close_tree(_np(grads), _np(rgrads), rtol=0, atol=1e-6)


def test_ring_without_a_mesh_is_the_plain_attention_like_the_reference():
    jcfg, jparams, tcfg, tparams = _pair(TINY)
    toks = _tokens(shape=(2, 16))
    ring = dataclasses.replace(tcfg, attn_impl="ring")
    assert torch.equal(tt.forward(ring, tparams, torch.from_numpy(toks))[0],
                       tt.forward(tcfg, tparams, torch.from_numpy(toks))[0])
    jring = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ring", **TINY)
    np.testing.assert_allclose(
        tt.forward(ring, tparams, torch.from_numpy(toks))[0].numpy(),
        np.asarray(jt.forward(jring, jparams, jnp.asarray(toks))[0]),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_one_block_ring_attention_is_the_plain_attention(causal):
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 32, 4, 16)).astype(
        np.float32)) for _ in range(3))
    np.testing.assert_allclose(
        ring_attention_local(q, k, v, None, causal=causal).numpy(),
        mha_attention(q, k, v, causal=causal).numpy(), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------- refusals

def _decode_calls(cfg, params):
    s, t = 2, 3
    state = tt.init_decode_state(dataclasses.replace(cfg, n_experts=0), s,
                                 "cpu")
    toks = torch.zeros((s,), dtype=torch.int32)
    table = torch.zeros((s, 4), dtype=torch.int32)
    return {
        "decode_step": lambda: tt.decode_step(cfg, params, toks, state),
        "decode_loop": lambda: tt.decode_loop(cfg, params, toks, state, 2),
        "verify_steps": lambda: tt.verify_steps(
            cfg, params, torch.zeros((s, t), dtype=torch.int32), state),
        "prefill": lambda: tt.prefill(cfg, params, torch.zeros(
            (8,), dtype=torch.int32)),
        "prefill_chunk": lambda: tt.prefill_chunk(
            cfg, params, torch.zeros((4,), dtype=torch.int32), state, 0, 4),
        "prefill_chunk_batch": lambda: tt.prefill_chunk_batch(
            cfg, params, torch.zeros((s, 4), dtype=torch.int32), state,
            torch.zeros((s,), dtype=torch.int64),
            torch.zeros((s,), dtype=torch.int64),
            torch.full((s,), 4, dtype=torch.int64)),
        "paged_decode_steps": lambda: tt.paged_decode_steps(
            cfg, params, toks, torch.zeros((s,), dtype=torch.int32), table,
            None, 1),
        "paged_verify_steps": lambda: tt.paged_verify_steps(
            cfg, params, torch.zeros((s, t), dtype=torch.int32),
            torch.zeros((s,), dtype=torch.int32), table, None),
        "paged_prefill_chunk": lambda: tt.paged_prefill_chunk(
            cfg, params, torch.zeros((4,), dtype=torch.int32), table[0],
            None, 0, 4),
        "paged_prefill_chunk_batch": lambda: tt.paged_prefill_chunk_batch(
            cfg, params, torch.zeros((s, 4), dtype=torch.int32), table,
            None, torch.zeros((s,), dtype=torch.int64),
            torch.full((s,), 4, dtype=torch.int64)),
    }


@pytest.mark.parametrize("entry", sorted(_decode_calls(
    tt.TransformerConfig(n_experts=4), None)))
def test_every_decode_entry_refuses_moe_like_the_reference(entry):
    jcfg, jparams, tcfg, tparams = _pair(CONFIGS["moe"])
    with pytest.raises(NotImplementedError) as jerr:
        jt.decode_step(jcfg, jparams, jnp.int32(1),
                       jt.init_decode_state(dataclasses.replace(
                           jcfg, n_experts=0)))
    with pytest.raises(NotImplementedError) as terr:
        _decode_calls(tcfg, tparams)[entry]()
    assert str(terr.value) == str(jerr.value) == \
        "KV-cache decode supports dense FFN only"


def test_flash_refuses_to_train():
    cfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash",
                               **TINY)
    with pytest.raises(ValueError, match="no backward"):
        tt.make_train_step(cfg)
    # the same on the card: the refusal reads the config, not a device
    with pytest.raises(ValueError, match="no backward"):
        tt.make_train_step(cfg, learning_rate=1e-2)


def test_config_validation_is_the_references():
    with pytest.raises(ValueError, match="gate"):
        tt.TransformerConfig(n_experts=4, ffn="swiglu")
    with pytest.raises(ValueError, match="gate"):
        jt.TransformerConfig(n_experts=4, ffn="swiglu")
    assert tt.TransformerConfig(n_experts=4).moe
    assert not tt.TransformerConfig().moe
    for name in ("n_experts", "capacity_factor", "aux_loss_weight", "remat"):
        assert getattr(tt.TransformerConfig(), name) == \
            getattr(jt.TransformerConfig(), name), name


@pytest.mark.parametrize("extra", [dict(n_experts=4),
                                   dict(n_experts=8, n_kv_heads=2)])
def test_the_moe_flop_and_byte_terms_are_the_references(extra):
    kw = dict(TINY, **extra)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **kw)
    assert tt.layer_flops_per_token(tcfg) == jt.layer_flops_per_token(jcfg)
    for ctx in (1, 7, 30):
        assert tt.token_bytes(tcfg, ctx) == jt.token_bytes(jcfg, ctx)
        assert tt.token_flops(tcfg, ctx) == jt.token_flops(jcfg, ctx)
    assert tt.span_flops(tcfg, 3, 9) == jt.span_flops(jcfg, 3, 9)
