"""The port's mesh, collectives, ring attention, MoE under ep, the GPipe
pipeline and the sharded train step, held against the JAX package on the
CPU: each multi-rank case runs in gloo ranks started by ``run_ranks``
(rank bodies in ``tests/torch_parallel_ranks.py``, which imports no JAX),
and the reference runs here on the 8 virtual CPU devices.

Four ``run_ranks`` launches, one module-scoped fixture each:

- dp2·sp2·tp2, 8 ranks: TINY under ``"ref"`` from carried weights, the
  loss against the reference's single-device loss at rtol 1e-4 (the
  reference's own tolerance for its sharded step,
  tests/test_transformer.py:78) and the gathered gradients against
  ``jax.grad`` at atol 1e-5; three train steps' losses at rtol 1e-4 and
  parameters as ``close_params`` holds them; the ring
  config's forward logits against the reference's ring forward on its
  mesh at 2e-4; ``ring_attention`` causal and not against the
  reference's at 2e-4; the dry run's steps 1-3 at 8 ranks.
- dp2·ep2, 4 ranks: the dry run's step-2 MoE config, the loss against
  the reference at rtol 1e-4, aux at atol 1e-6, gradients at atol 1e-5;
  pp4: ``pipeline_forward`` against the stages run one after another at
  1e-5.
- pp2, 2 ranks: each stage's gradient against ``jax.grad`` of the
  reference's pipeline at atol 1e-6.
- a rank that dies: ``run_ranks`` raises within seconds, never hangs.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from torch_parallel_ranks import close_params
from client_tpu.models import transformer as jt
from client_tpu.ops.ring_attention import ring_attention as j_ring
from client_tpu.parallel.mesh import factor_devices as j_factor
from client_tpu.parallel.mesh import make_mesh as j_make_mesh
from client_tpu.parallel.pipeline import pipeline_forward as j_pipeline
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.parallel import collectives
from client_tpu_torch.parallel import mesh as tmesh

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8,
            d_ff=64, max_seq=32)
# the dry run's step 2 at ep = 2
MOE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=8,
           d_ff=32, max_seq=17, n_experts=4)
LAUNCH_S = 240.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jcfg(kw, **extra):
    return jt.TransformerConfig(dtype=jnp.float32, **{**kw, **extra})


def _max_err(a, b):
    return max(jax.tree.leaves(jax.tree.map(
        lambda x, y: float(np.abs(np.asarray(x) - np.asarray(y)).max()),
        a, b)))


# ---------------------------------------------------------------- dp·sp·tp

@pytest.fixture(scope="module")
def dp_sp_tp():
    jcfg = _jcfg(TINY, attn_impl="ref")
    params = jt.init_params(jax.random.key(4), jcfg)
    tokens = np.asarray(jax.random.randint(jax.random.key(5), (4, 17), 0,
                                           64), np.int32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, jnp.asarray(tokens))))(params)
    init_state, step = jt.make_train_step(jcfg, learning_rate=1e-2)
    state = init_state(jax.random.key(4))
    losses = []
    for _ in range(3):
        state, metrics = step(state, jnp.asarray(tokens))
        losses.append(float(metrics["loss"]))

    mesh = j_make_mesh({"dp": 2, "sp": 2, "tp": 2}, n_devices=8)
    ring_cfg = _jcfg(TINY, attn_impl="ring")
    ring_params = jt.init_params(jax.random.key(8), jcfg)
    ring_tokens = np.asarray(jax.random.randint(jax.random.key(9), (2, 16),
                                                0, 64), np.int32)
    ring_logits = jax.jit(lambda p, t: jt.forward(ring_cfg, p, t,
                                                  mesh=mesh)[0])(
        ring_params, jnp.asarray(ring_tokens))
    k1, k2, k3 = jax.random.split(jax.random.key(1), 3)
    qkv = [jax.random.normal(k, (2, 64, 4, 16), jnp.float32)
           for k in (k1, k2, k3)]
    ring_ref = {c: np.asarray(jax.jit(
        lambda q, k, v, c=c: j_ring(q, k, v, mesh, causal=c))(*qkv))
                for c in (False, True)}

    case = {"ref_cfg": {**TINY, "attn_impl": "ref"}, "params": _np(params),
            "tokens": tokens, "ring_cfg": {**TINY, "attn_impl": "ring"},
            "ring_params": _np(ring_params), "ring_tokens": ring_tokens,
            "qkv": [np.asarray(a) for a in qkv]}
    got = collectives.run_ranks(ranks.dp_sp_tp, 8, "gloo", LAUNCH_S,
                                args=(case,))
    ref = {"loss": float(loss), "grads": _np(grads), "losses": losses,
           "params": _np(state["params"]), "ring_logits":
           np.asarray(ring_logits), "ring_attention": ring_ref}
    return got, ref


def test_sharded_loss_matches_the_reference_single_device(dp_sp_tp):
    got, ref = dp_sp_tp
    for r in got:  # every rank reports the global loss
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-4)


def test_sharded_gradients_match_jax_grad(dp_sp_tp):
    got, ref = dp_sp_tp
    for r in got:
        assert _max_err(ref["grads"], r["grads"]) < 1e-5


def test_sharded_train_steps_match_the_reference(dp_sp_tp):
    got, ref = dp_sp_tp
    for r in got:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-4)
        close_params(ref["params"], r["params"], ref["grads"], 1e-2, 3)


def test_ring_forward_matches_the_reference_ring_forward(dp_sp_tp):
    got, ref = dp_sp_tp
    for r in got:
        np.testing.assert_allclose(r["ring_logits"], ref["ring_logits"],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_the_reference(dp_sp_tp, causal):
    got, ref = dp_sp_tp
    for r in got:
        np.testing.assert_allclose(r[f"ring_attention_{causal}"],
                                   ref["ring_attention"][causal],
                                   rtol=2e-4, atol=2e-4)


def test_the_dry_run_steps_at_eight_ranks(dp_sp_tp):
    got, _ = dp_sp_tp
    for r in got:
        assert set(r["dryrun"]) == {"dp_sp_tp", "dp_ep", "pp"}
        assert all(np.isfinite(v) for v in r["dryrun"].values())
    assert len({r["dryrun"]["dp_sp_tp"] for r in got}) == 1


# ---------------------------------------------------------------- dp·ep, pp4

@pytest.fixture(scope="module")
def dp_ep_pp4():
    jcfg = _jcfg(MOE)
    params = jt.init_params(jax.random.key(2), jcfg)
    tokens = np.asarray(jax.random.randint(jax.random.key(3), (4, 17), 0,
                                           64), np.int32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, jnp.asarray(tokens))))(params)
    _, aux = jax.jit(lambda p: jt.forward(jcfg, p, jnp.asarray(
        tokens[:, :-1])))(params)
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    expect = x
    for s in range(4):
        expect = np.tanh(expect @ w[s])
    case = {"moe_cfg": {**MOE, "attn_impl": "ref"}, "params": _np(params),
            "tokens": tokens, "pp_w": w, "pp_x": x}
    got = collectives.run_ranks(ranks.dp_ep_and_pp4, 4, "gloo", LAUNCH_S,
                                args=(case,))
    return got, {"loss": float(loss), "aux": float(aux),
                 "grads": _np(grads), "pp4": expect}


def test_moe_under_dp_ep_matches_the_reference(dp_ep_pp4):
    got, ref = dp_ep_pp4
    assert ref["aux"] > 0
    for r in got:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-4)
        np.testing.assert_allclose(r["aux"], ref["aux"], atol=1e-6)
        assert _max_err(ref["grads"], r["grads"]) < 1e-5


def test_pipeline_forward_matches_sequential_stages(dp_ep_pp4):
    got, ref = dp_ep_pp4
    for r in got:  # every stage holds the outputs
        np.testing.assert_allclose(r["pp4"], ref["pp4"], rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------- pp2 grads

def test_pipeline_gradients_match_jax_grad():
    mesh = j_make_mesh({"pp": 2}, n_devices=2, axes=("pp",))
    w = jnp.ones((2, 4, 4), jnp.float32) * 0.2
    x = jnp.ones((4, 4), jnp.float32)

    def loss(params):
        y = j_pipeline(lambda p, a: jnp.tanh(a @ p), params, x, mesh,
                       n_microbatches=2)
        return jnp.sum(y ** 2)

    g = np.asarray(jax.jit(jax.grad(loss))(w))
    assert np.abs(g).sum() > 0
    got = collectives.run_ranks(ranks.pp2_grads, 2, "gloo", LAUNCH_S,
                                args=({"w": np.asarray(w),
                                       "x": np.asarray(x)},))
    for stage, r in enumerate(got):
        np.testing.assert_allclose(r["grad"], g[stage], atol=1e-6)


# ---------------------------------------------------------------- run_ranks

def test_run_ranks_raises_and_never_hangs_when_a_rank_dies():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        collectives.run_ranks(ranks.dies, 2, "gloo", timeout_s=120.0)
    assert time.monotonic() - t0 < 60


# ---------------------------------------------------------------- mesh rules

def test_factor_devices_is_the_references():
    for n in (1, 2, 4, 6, 7, 8, 12, 16):
        for axes in (tmesh.MESH_AXES, ("dp", "sp", "tp"), ("dp", "ep"),
                     ("dp", "tp")):
            assert tmesh.factor_devices(n, axes) == j_factor(n, axes)
    assert tmesh.factor_devices(8, tmesh.MESH_AXES, {"sp": 2, "tp": 2}) \
        == j_factor(8, tmesh.MESH_AXES, {"sp": 2, "tp": 2})
    for bad in ({"tp": 3}, {"dp": 3, "tp": 3}):
        with pytest.raises(ValueError):
            tmesh.factor_devices(8, ("dp", "tp"), bad)
        with pytest.raises(ValueError):
            j_factor(8, ("dp", "tp"), bad)


def test_logical_rules_and_param_specs_are_the_references():
    from client_tpu.parallel import mesh as jmesh

    assert tmesh.LOGICAL_RULES == jmesh.LOGICAL_RULES
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    for kw in (TINY, MOE, dict(TINY, n_kv_heads=2, rope=True,
                               ffn="swiglu")):
        jspecs = jax.tree.map(
            tuple, jt.param_specs(_jcfg(kw)),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        assert jspecs == tt.param_specs(tt.TransformerConfig(**kw))
        assert jt.param_logical_axes(_jcfg(kw)) == \
            tt.param_logical_axes(tt.TransformerConfig(**kw))


def test_make_mesh_needs_a_process_group_and_the_right_backend():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(device="cpu")
    assert tmesh.axis_size(None, "tp") == 1
    assert tmesh.axis_index(None, "sp") == 0
    assert tmesh.axis_group(None, "dp") is None
