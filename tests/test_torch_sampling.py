"""Parity of the port's token selection (client_tpu_torch.models.sampling)
with the JAX package's, on the CPU.

``jax.random.categorical`` is ``argmax(logits + gumbel(key))``, so feeding
the port's ``sample_next`` the very Gumbel draws the reference makes from
``step_key(seed, pos)`` (a vocab-wide one for the full-vocab branch and a
``max_top_k``-wide one for the truncated branches) holds the selection
rule to exact token agreement in every branch. The port's own noise is
drawn from (seed, pos) by a counter-based hash and is checked for
determinism and for its distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import sampling as js
from client_tpu.models import transformer as jt
from client_tpu_torch.models import sampling as ts
from client_tpu_torch.models import transformer as tt

# (temperature, top_k, top_p): greedy, full vocab, top-k, nucleus, both,
# a nucleus below f32 epsilon, and the full-mass nucleus the tail-sum fix
# exists for
BRANCHES = {
    "greedy": (0.0, 0, 0.0),
    "full_vocab": (0.8, 0, 0.0),
    "top_k": (1.3, 5, 0.0),
    "top_k_one": (0.7, 1, 0.0),
    "nucleus": (1.0, 0, 0.9),
    "top_k_and_nucleus": (0.6, 20, 0.5),
    "tiny_nucleus": (1.0, 0, 1e-9),
    "full_nucleus": (2.0, 0, 1.0),
}


def _jax_noise(seed, pos, vocab, max_top_k=js.MAX_TOP_K):
    key = js.step_key(seed, pos)
    k = min(max_top_k, vocab)
    return (np.array(jax.random.gumbel(key, (vocab,), jnp.float32)),
            np.array(jax.random.gumbel(key, (k,), jnp.float32)))


def test_categorical_is_argmax_of_logits_plus_gumbel():
    """The identity the noise hand-over rests on, for this JAX."""
    logits = jnp.asarray(np.random.default_rng(0).normal(size=(97,)),
                         jnp.float32)
    for pos in range(20):
        key = js.step_key(3, pos)
        want = int(jax.random.categorical(key, logits))
        g = jax.random.gumbel(key, logits.shape, jnp.float32)
        assert int(jnp.argmax(logits + g)) == want


@pytest.mark.parametrize("vocab", [97, 40])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_sample_next_matches_jax_on_its_own_draws(branch, vocab):
    temp, top_k, top_p = BRANCHES[branch]
    rng = np.random.default_rng(vocab)
    for trial in range(12):
        logits = (rng.normal(size=(vocab,)) * 3).astype(np.float32)
        seed, pos = trial, 5 * trial
        want = int(js.sample_next(jnp.asarray(logits),
                                  js.step_key(seed, pos), temp, top_k,
                                  top_p))
        g, gk = _jax_noise(seed, pos, vocab)
        got = ts.sample_next(torch.from_numpy(logits), torch.from_numpy(g),
                             torch.from_numpy(gk), temp, top_k, top_p)
        assert got.dtype == torch.int32
        assert int(got) == want, (branch, trial)


def test_sample_next_is_batched_per_row():
    """One call over [S, V] rows with per-row parameters equals S calls."""
    rng = np.random.default_rng(1)
    names = sorted(BRANCHES)
    logits = (rng.normal(size=(len(names), 97)) * 2).astype(np.float32)
    params = [BRANCHES[n] for n in names]
    noise = [_jax_noise(i, i, 97) for i in range(len(names))]
    got = ts.sample_next(
        torch.from_numpy(logits),
        torch.from_numpy(np.stack([g for g, _ in noise])),
        torch.from_numpy(np.stack([k for _, k in noise])),
        torch.tensor([p[0] for p in params]),
        torch.tensor([p[1] for p in params], dtype=torch.int32),
        torch.tensor([p[2] for p in params]))
    for i, (temp, top_k, top_p) in enumerate(params):
        one = ts.sample_next(torch.from_numpy(logits[i]),
                             torch.from_numpy(noise[i][0]),
                             torch.from_numpy(noise[i][1]), temp, top_k,
                             top_p)
        assert int(got[i]) == int(one)


def test_step_noise_is_a_pure_function_of_seed_and_position():
    g1, k1 = ts.step_noise(torch.tensor([7, 7, 8]), torch.tensor([3, 4, 3]),
                           50)
    g2, k2 = ts.step_noise(torch.tensor([7]), torch.tensor([3]), 50)
    assert g1.shape == (3, 50) and k1.shape == (3, 50)   # min(64, 50)
    assert torch.equal(g1[0], g2[0]) and torch.equal(k1[0], k2[0])
    assert not torch.equal(g1[0], g1[1])    # another position
    assert not torch.equal(g1[0], g1[2])    # another seed
    assert torch.isfinite(g1).all() and torch.isfinite(k1).all()


def test_step_noise_is_standard_gumbel():
    """Mean ~ Euler's gamma (0.5772), variance ~ pi^2 / 6 (1.645), over
    2048 positions x 1000 draws."""
    g, _ = ts.step_noise(torch.zeros(2048, dtype=torch.int64),
                         torch.arange(2048), 1000)
    assert abs(float(g.mean()) - 0.5772) < 0.01
    assert abs(float(g.var()) - 1.6449) < 0.03


def test_select_token_samples_the_softmax_distribution():
    """Full-vocab draws at temperature 1 over many positions follow
    softmax(logits)."""
    logits = torch.tensor([0.0, 1.0, 2.0, -1.0])
    n = 20000
    toks = ts.select_token(logits.expand(n, 4),
                           torch.zeros(n, dtype=torch.int32),
                           torch.arange(n), 1.0, 0)
    freq = torch.bincount(toks.long(), minlength=4).float() / n
    torch.testing.assert_close(freq, torch.softmax(logits, 0), rtol=0,
                               atol=0.015)


def test_greedy_select_token_is_argmax():
    logits = torch.randn(5, 33, generator=torch.Generator().manual_seed(0))
    got = ts.select_token(logits, torch.arange(5), torch.arange(5), 0.0, 0)
    assert torch.equal(got, logits.argmax(-1).int())


def test_offline_sample_greedy_matches_jax():
    """The port's S=1 paged decode loop against the reference's
    ``offline_sample`` (slot-layout decode) with the same f32 weights."""
    kw = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=16,
              d_ff=64, max_seq=32, causal=True)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **kw)
    jparams = jt.init_params(jax.random.key(2), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    prompt = [5, 9, 1, 33, 2, 7]
    with jax.default_matmul_precision("float32"):
        want = js.offline_sample(jcfg, jparams, prompt, 12)
    for impl in ("flash", "ref"):
        tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl=impl,
                                    **kw)
        assert ts.offline_sample(tcfg, tparams, prompt, 12,
                                 block_len=4) == want
