"""Speculative decoding in the port (client_tpu_torch.server.speculation,
the verify passes of client_tpu_torch.models.transformer, the rounds of
client_tpu_torch.server.generation), held against the JAX package on the
CPU with the reference test's tiny f32 model and the same weights.

Each module is held to its reference on the same numpy inputs:
``filtered_probs`` at 1e-6; ``spec_select`` to the exact accepted count
and token when it is handed the reference's uniforms and the Gumbel
draws of its residual key (``jax.random.categorical`` is ``argmax(logits
+ gumbel(key))``); the rung and acceptance bookkeeping to equal outputs;
``verify_steps`` and ``paged_verify_steps`` at 1e-5 (logits, written K/V
rows, positions), with every slot outside the round bit-unchanged. The
engines are held to the JAX speculative engine: token-identical greedy
streams and equal speculation counters on both KV layouts and every
prompt path, the ladder, the acceptance floor, the max_seq latch, EOS,
gamma 0 and prefix-restored slots. Streams are submitted one after
another where counters are compared: a round's count depends on when the
host learns acceptances, which concurrency makes timing-dependent in
both engines alike.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import sampling as js
from client_tpu.models import transformer as jt
from client_tpu.models.decoder_lm import (
    make_continuous_generator as jax_generator,
)
from client_tpu.server import speculation as jspec
from client_tpu.server.config import SpeculativeConfig as JaxSpecConfig
from client_tpu.server.generation import (
    ContinuousBatchingEngine as JaxEngine,
)
from client_tpu_torch.models import sampling as ts
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.models.decoder_lm import make_continuous_generator
from client_tpu_torch.server import generation as tgen
from client_tpu_torch.server import speculation as tspec
from client_tpu_torch.server.config import SpeculativeConfig
from client_tpu_torch.server.generation import ContinuousBatchingEngine
from client_tpu_torch.server.kv_cache import init_paged_pool
from client_tpu_torch.server.types import ServerError

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=48, causal=True)
TOL = 1e-5
PROB_TOL = 1e-6


@pytest.fixture(scope="module")
def tiny():
    """The reference test's model (tests/test_speculation.py) and its
    adversarial draft (same shape, key 99), in both packages."""
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    jdraft = jt.init_params(jax.random.key(99), jcfg)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="ref", **KW)

    def port(p):
        return tt.params_from_jax(jax.tree.map(np.asarray, p), "cpu",
                                  torch.float32)

    return jcfg, jparams, jdraft, tcfg, port(jparams), port(jdraft)


# ---------------------------------------------------------------- sampling

BRANCHES = {
    "greedy": (0.0, 0, 0.0),
    "full": (0.8, 0, 0.0),
    "top_k": (1.3, 5, 0.0),
    "top_p": (1.0, 0, 0.9),
    "both": (0.6, 20, 0.5),
    "tiny_top_p": (1.0, 0, 1e-9),
}


@pytest.mark.parametrize("vocab", [97, 40])   # 40 < MAX_TOP_K
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_filtered_probs_matches_jax(branch, vocab):
    temp, top_k, top_p = BRANCHES[branch]
    logits = np.random.default_rng(vocab).normal(
        scale=3.0, size=(4, vocab)).astype(np.float32)
    got = ts.filtered_probs(torch.from_numpy(logits), temp, top_k,
                            top_p).numpy()
    for i in range(len(logits)):
        want = np.asarray(js.filtered_probs(jnp.asarray(logits[i]), temp,
                                            top_k, top_p))
        np.testing.assert_allclose(got[i], want, atol=PROB_TOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_filtered_probs_is_batched_per_row():
    """Per-row temperature, top-k and top-p over leading dims [2, 3]."""
    rng = np.random.default_rng(1)
    logits = rng.normal(scale=2.0, size=(2, 3, 80)).astype(np.float32)
    temps = np.asarray([[0.0, 0.7, 1.1], [0.9, 0.5, 2.0]], np.float32)
    topks = np.asarray([[0, 0, 7], [0, 3, 30]], np.int32)
    topps = np.asarray([[0.0, 0.95, 0.0], [0.3, 0.0, 0.8]], np.float32)
    got = ts.filtered_probs(torch.from_numpy(logits), torch.from_numpy(temps),
                            torch.from_numpy(topks),
                            torch.from_numpy(topps)).numpy()
    for idx in np.ndindex(2, 3):
        want = np.asarray(js.filtered_probs(
            jnp.asarray(logits[idx]), float(temps[idx]), int(topks[idx]),
            float(topps[idx])))
        np.testing.assert_allclose(got[idx], want, atol=PROB_TOL, rtol=0)


def test_salted_noise_is_pure_and_salt_zero_is_the_selection_stream():
    seed, pos = torch.tensor([7, 7, 8]), torch.tensor([3, 4, 3])
    g0, k0 = ts.step_noise(seed, pos, 50)
    # salt 0 is the unsalted stream select_token has always drawn
    g0b, k0b = ts.step_noise(seed, pos, 50, salt=0)
    assert torch.equal(g0, g0b) and torch.equal(k0, k0b)
    assert torch.equal(ts.step_gumbel(seed, pos, 50), g0)
    streams = [g0] + [ts.step_noise(seed, pos, 50, salt=s)[0]
                      for s in (tspec.DRAFT_SALT, tspec.ACCEPT_SALT,
                                tspec.RESIDUAL_SALT)]
    for a in range(len(streams)):
        for b in range(a + 1, len(streams)):
            assert not torch.equal(streams[a], streams[b])
    again = ts.step_noise(seed, pos, 50, salt=tspec.DRAFT_SALT)[0]
    assert torch.equal(again, streams[1])
    u = ts.step_uniform(torch.zeros(4096, dtype=torch.int64),
                        torch.arange(4096), tspec.ACCEPT_SALT)
    assert u.shape == (4096,) and float(u.min()) > 0 and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 0.02


# ---------------------------------------------------------------- spec_select

def _one_hot(idx, vocab=8):
    return np.eye(vocab, dtype=np.float32)[np.asarray(idx)]


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# tests/test_speculation.py:203-275, and drawn distributions
SELECT_CASES = {
    "greedy_prefix": (_one_hot([1, 2, 3, 4]), _one_hot([1, 2, 7]),
                      [1, 2, 7], [0.99, 0.99, 0.0], 0),
    "greedy_bonus": (_one_hot([1, 2, 3, 4]), _one_hot([1, 2, 3]),
                     [1, 2, 3], [0.5, 0.5, 0.5], 0),
    "identical": (None, None, [5, 0, 2], [0.999, 0.999, 0.999], 1),
    "zero_q_mass": (_one_hot([1, 2, 3, 4]), _one_hot([5, 2, 3]),
                    [5, 2, 3], [0.0, 0.0, 0.0], 0),
}


def _jax_select(p, q, props, u, key):
    n_acc, nxt = jspec.spec_select(jnp.asarray(p), jnp.asarray(q),
                                   jnp.asarray(props, jnp.int32),
                                   jnp.asarray(u, jnp.float32), key)
    return int(n_acc), int(nxt)


def _port_select(ps, qs, props, us, keys):
    vocab = ps[0].shape[-1]
    res = np.stack([np.asarray(jax.random.gumbel(k, (vocab,), jnp.float32))
                    for k in keys])
    n_acc, nxt = tspec.spec_select(
        torch.from_numpy(np.stack(ps)), torch.from_numpy(np.stack(qs)),
        torch.from_numpy(np.asarray(props, np.int32)),
        torch.from_numpy(np.asarray(us, np.float32)), torch.from_numpy(res))
    return list(zip(n_acc.tolist(), nxt.tolist()))


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_spec_select_matches_the_reference_cases(case):
    p, q, props, u, key_i = SELECT_CASES[case]
    if p is None:
        p = np.asarray(jax.nn.softmax(jax.random.normal(
            jax.random.key(3), (4, 8))))
        q = p[:3]
    key = jax.random.key(key_i)
    want = _jax_select(p, q, props, u, key)
    assert _port_select([p], [q], [props], [u], [key]) == [want]
    if case == "identical":
        assert want[0] == 3


@pytest.mark.parametrize("seed", range(4))
def test_spec_select_matches_jax_on_drawn_distributions(seed):
    """Eight slots at once, each with its own p, q, proposals, uniforms and
    residual key: exact accepted counts and tokens."""
    rng = np.random.default_rng(seed)
    g, vocab = 4, 12
    ps, qs, props, us, keys, want = [], [], [], [], [], []
    for slot in range(8):
        p = _softmax(rng.normal(scale=2.0, size=(g + 1, vocab)))
        # half the slots draft close to the target, so prefixes get long
        q = p[:g] if slot % 2 else _softmax(rng.normal(size=(g, vocab)))
        prop = [int(rng.choice(vocab, p=q[i] / q[i].sum()))
                for i in range(g)]
        u = rng.uniform(size=g).astype(np.float32)
        key = jax.random.key(100 * seed + slot)
        ps.append(p)
        qs.append(q)
        props.append(prop)
        us.append(u)
        keys.append(key)
        want.append(_jax_select(p, q, prop, u, key))
    assert _port_select(ps, qs, props, us, keys) == want
    assert {n for n, _ in want} != {0}


def test_spec_select_on_port_noise_keeps_the_target_distribution():
    """Modified rejection sampling on the port's own salted noise: the
    first token of a round (the accepted proposal, or the residual draw
    at its rejection) follows p, by a chi-square test over 20,000 rounds
    at vocab 8 (fixed seeds, so the statistic is deterministic)."""
    from scipy.stats import chisquare

    n, vocab = 20000, 8
    p = np.asarray([0.30, 0.20, 0.15, 0.10, 0.10, 0.08, 0.05, 0.02],
                   np.float32)
    q = np.asarray([0.05, 0.10, 0.30, 0.05, 0.20, 0.10, 0.15, 0.05],
                   np.float32)
    seeds = torch.arange(n)
    pos = torch.full((n,), 5)
    qt = torch.from_numpy(q).expand(n, vocab)
    noise = ts.step_gumbel(seeds, pos, vocab, tspec.DRAFT_SALT)
    props = (qt.log() + noise).argmax(-1).to(torch.int32)[:, None]
    u = ts.step_uniform(seeds, pos + 1, tspec.ACCEPT_SALT)[:, None]
    res = ts.step_gumbel(seeds, pos, vocab, tspec.RESIDUAL_SALT)
    pdist = torch.from_numpy(p).expand(n, 2, vocab)
    n_acc, nxt = tspec.spec_select(pdist, qt[:, None], props, u, res)
    first = torch.where(n_acc > 0, props[:, 0], nxt).numpy()
    counts = np.bincount(first, minlength=vocab)
    # the draft's own draws follow q: the test would pass for nothing if
    # every proposal were accepted
    assert 0.2 < float((n_acc == 0).float().mean()) < 0.8
    expected = p.astype(np.float64) / p.astype(np.float64).sum() * n
    assert chisquare(counts, expected).pvalue > 1e-3


# ---------------------------------------------------------------- bookkeeping

@pytest.mark.parametrize("alpha", [0.0, 0.05, 0.3, 0.5, 0.7, 0.95, 1.0])
def test_rung_selection_matches_the_reference(alpha):
    for gamma in range(0, 9):
        assert tspec.expected_accepted(alpha, gamma) == \
            jspec.expected_accepted(alpha, gamma)
    for ladder in ((1,), (1, 2), (1, 2, 4), (1, 2, 4, 8), (2, 4, 6)):
        assert tspec.select_gamma(alpha, ladder) == \
            jspec.select_gamma(alpha, ladder)
    for g, ladder in ((0, False), (5, False), (5, True), (8, True),
                      (12, True)):
        assert ContinuousBatchingEngine.resolve_gamma_ladder(g, ladder) \
            == JaxEngine.resolve_gamma_ladder(g, ladder)


@pytest.mark.parametrize("floor", [0.0, 0.3, 0.6])
def test_request_speculation_matches_the_reference(floor):
    rng = np.random.default_rng(int(floor * 10))
    mine, ref = tspec.RequestSpeculation(), jspec.RequestSpeculation()
    for _ in range(12):
        proposed = int(rng.integers(0, 5))
        accepted = int(rng.integers(0, proposed + 1))
        mine.record(proposed, accepted, floor)
        ref.record(proposed, accepted, floor)
        assert (mine.rounds, mine.ewma, mine.fallback) == \
            (ref.rounds, ref.ewma, ref.fallback)
        for ceiling in (0, 1, 3, 8):
            assert mine.select_rung((1, 2, 4, 8), ceiling) == \
                ref.select_rung((1, 2, 4, 8), ceiling)


def test_speculation_controller_matches_the_reference():
    mine = tspec.SpeculationController(4, 0.25)
    ref = jspec.SpeculationController(4, 0.25)
    assert mine.snapshot() == ref.snapshot()
    for proposed, accepted in ((4, 4), (4, 0), (2, 1), (0, 0), (4, 3)):
        mine.record_round(proposed, accepted)
        ref.record_round(proposed, accepted)
        assert mine.snapshot() == ref.snapshot()
        assert mine.acceptance_rate() == ref.acceptance_rate()
    for gamma, floor in ((-1, 0.0), (2, 1.5), (2, -0.1)):
        with pytest.raises(ValueError):
            tspec.SpeculationController(gamma, floor)
        with pytest.raises(ValueError):
            jspec.SpeculationController(gamma, floor)


def test_build_draft_model_derives_the_reference_shape(tiny):
    jcfg, _, _, tcfg, _, _ = tiny
    for draft in ({}, {"n_layers": 1, "d_model": 32, "n_heads": 2},
                  {"max_seq": 16, "vocab_size": 9}):
        spec = SpeculativeConfig(enabled=True, gamma=3, draft=draft,
                                 draft_seed=5)
        mine = tspec.build_draft_model(tcfg, spec, "cpu")
        ref = jspec.build_draft_model(jcfg, JaxSpecConfig(
            enabled=True, gamma=3, draft=draft, draft_seed=5))
        for name in ("vocab_size", "max_seq", "d_model", "d_ff",
                     "n_layers", "n_heads", "head_dim", "rope", "ffn",
                     "causal"):
            assert getattr(mine.cfg, name) == getattr(ref.cfg, name), name
        assert mine.cfg.dtype == torch.float32
        assert mine.params["embed"].shape == ref.params["embed"].shape
    again = tspec.build_draft_model(tcfg, spec, "cpu")
    assert torch.equal(again.params["embed"], mine.params["embed"])
    with pytest.raises(ValueError, match="unknown draft"):
        tspec.build_draft_model(tcfg, SpeculativeConfig(draft={"bogus": 1}),
                                "cpu")
    # n_experts is a TransformerConfig field in both packages, so it is a
    # known knob; a Switch-MoE draft has no KV-cache decode path, and both
    # packages refuse it when the draft is checked against the target
    moe = {"n_experts": 4}
    with pytest.raises(ValueError, match="a MoE draft has no KV-cache "
                                         "decode path"):
        jspec.build_draft_model(jcfg, JaxSpecConfig(draft=moe))
    with pytest.raises(ValueError, match="a MoE draft has no KV-cache "
                                         "decode path"):
        tspec.build_draft_model(tcfg, SpeculativeConfig(draft=moe), "cpu")
    small = tt.TransformerConfig(**{**KW, "max_seq": 16,
                                    "dtype": torch.float32})
    with pytest.raises(ValueError, match="max_seq"):
        tspec.DraftModel(small, None).assert_compatible(tcfg)


# ---------------------------------------------------------------- verify

def _prefix_state(cfg, params, toks):
    """A slot-layout state of len(toks) slots after feeding each its own
    row of ``toks`` [S, P] through decode_step."""
    st = tt.init_decode_state(cfg, toks.shape[0], "cpu")
    for c in range(toks.shape[1]):
        _, st = tt.decode_step(cfg, params, torch.from_numpy(toks[:, c]), st)
    return st


def _jax_prefix_state(cfg, params, toks):
    st = jax.vmap(lambda _: jt.init_decode_state(cfg))(
        jnp.arange(toks.shape[0]))
    step = jax.vmap(lambda tk, s: jt.decode_step(cfg, params, tk, s))
    for c in range(toks.shape[1]):
        _, st = step(jnp.asarray(toks[:, c]), st)
    return st


def test_verify_steps_matches_jax(tiny):
    """Logits, the K/V rows written and the positions of the reference's
    vmapped verify_steps, from mid-sequence, at 1e-5."""
    jcfg, jparams, _, tcfg, tparams, _ = tiny
    rng = np.random.default_rng(3)
    pre = rng.integers(0, 64, (3, 9)).astype(np.int32)
    toks = rng.integers(0, 64, (3, 5)).astype(np.int32)
    with jax.default_matmul_precision("float32"):
        jst = _jax_prefix_state(jcfg, jparams, pre)
        jl, jst = jax.vmap(lambda tk, s: jt.verify_steps(
            jcfg, jparams, tk, s))(jnp.asarray(toks), jst)
    st = _prefix_state(tcfg, tparams, pre)
    tl, st = tt.verify_steps(tcfg, tparams, torch.from_numpy(toks), st)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    assert st["pos"].tolist() == np.asarray(jst["pos"]).tolist() == [14] * 3
    for name in ("k", "v"):
        np.testing.assert_allclose(st[name][:, :, :14].numpy(),
                                   np.asarray(jst[name])[:, :, :14],
                                   atol=TOL, rtol=TOL)


def test_verify_steps_matches_serial_decode_steps(tiny):
    _, _, _, tcfg, tparams, _ = tiny
    toks = np.asarray([[3, 17, 42, 5, 11], [9, 8, 7, 6, 5]], np.int32)
    st = tt.init_decode_state(tcfg, 2, "cpu")
    serial = []
    for c in range(5):
        lg, st = tt.decode_step(tcfg, tparams, torch.from_numpy(toks[:, c]),
                                st)
        serial.append(lg)
    st2 = tt.init_decode_state(tcfg, 2, "cpu")
    lgs, st2 = tt.verify_steps(tcfg, tparams, torch.from_numpy(toks), st2)
    assert st2["pos"].tolist() == st["pos"].tolist() == [5, 5]
    for c in range(5):
        np.testing.assert_allclose(lgs[:, c].numpy(), serial[c].numpy(),
                                   atol=TOL, rtol=TOL)
        assert torch.equal(lgs[:, c].argmax(-1), serial[c].argmax(-1))


def test_verify_steps_resumes_mid_sequence_and_rolls_back(tiny):
    """tests/test_speculation.py's rollback case: verify 4 tokens after 3,
    keep 1 (rewind pos to 4), decode on; the logits are the serial
    pass's over the kept sequence."""
    _, _, _, tcfg, tparams, _ = tiny
    st = _prefix_state(tcfg, tparams, np.asarray([[9, 8, 7]], np.int32))
    _, st = tt.verify_steps(tcfg, tparams,
                            torch.tensor([[6, 50, 51, 52]], dtype=torch.int32),
                            st)
    st = {**st, "pos": torch.tensor([4], dtype=torch.int32)}
    after, _ = tt.decode_step(tcfg, tparams,
                              torch.tensor([30], dtype=torch.int32), st)
    ref = _prefix_state(tcfg, tparams,
                        np.asarray([[9, 8, 7, 6]], np.int32))
    want, _ = tt.decode_step(tcfg, tparams,
                             torch.tensor([30], dtype=torch.int32), ref)
    np.testing.assert_allclose(after.numpy(), want.numpy(), atol=TOL,
                               rtol=TOL)


def test_verify_steps_on_some_slots_leaves_the_others_bit_unchanged(tiny):
    _, _, _, tcfg, tparams, _ = tiny
    rng = np.random.default_rng(4)
    pre = rng.integers(0, 64, (4, 6)).astype(np.int32)
    toks = rng.integers(0, 64, (4, 3)).astype(np.int32)
    full = _prefix_state(tcfg, tparams, pre)
    want, _ = tt.verify_steps(tcfg, tparams, torch.from_numpy(toks), full)
    st = _prefix_state(tcfg, tparams, pre)
    before = {k: v.clone() for k, v in st.items()}
    rows = torch.tensor([3, 1])
    got, st = tt.verify_steps(tcfg, tparams, torch.from_numpy(toks[[3, 1]]),
                              st, rows=rows)
    np.testing.assert_allclose(got.numpy(), want[[3, 1]].numpy(), atol=TOL,
                               rtol=TOL)
    assert st["pos"].tolist() == [6, 9, 6, 9]
    for name in ("k", "v"):
        for other in (0, 2):
            assert torch.equal(st[name][other], before[name][other])
    # the draft's one-step form, decode_step on some slots, keeps the same
    # rule
    before = {k: v.clone() for k, v in st.items()}
    _, st = tt.decode_step(tcfg, tparams, torch.tensor([1], dtype=torch.int32),
                           st, rows=torch.tensor([2]))
    assert st["pos"].tolist() == [6, 9, 7, 9]
    for name in ("k", "v"):
        for other in (0, 1, 3):
            assert torch.equal(st[name][other], before[name][other])


def _paged_setup(cfg, params, pre, bl=4):
    """A pool holding each slot's prefix ``pre`` [S, P] through its own
    full-width table (slot s owns blocks s*nb+1 ...), written by
    paged_decode_steps."""
    s = pre.shape[0]
    nb = cfg.max_seq // bl
    pool = init_paged_pool(cfg, s * nb + 1, bl, "cpu")
    tables = (1 + torch.arange(s * nb)).reshape(s, nb).to(torch.int32)
    for c in range(pre.shape[1]):
        tt.paged_decode_steps(cfg, params, torch.from_numpy(pre[:, c]),
                              torch.full((s,), c, dtype=torch.int32), tables,
                              pool)
    return pool, tables


def test_paged_verify_steps_matches_jax_and_spares_other_slots(tiny):
    """The reference's paged_verify_steps with a mixed write mask: logits
    and written rows at 1e-5; a slot outside the mask writes only scratch
    block 0, so its own blocks are bit-unchanged."""
    jcfg, jparams, _, tcfg, tparams, _ = tiny
    rng = np.random.default_rng(5)
    pre = rng.integers(0, 64, (3, 7)).astype(np.int32)
    toks = rng.integers(0, 64, (3, 4)).astype(np.int32)
    pos0 = np.asarray([7, 7, 7], np.int32)
    write = np.asarray([True, False, True])
    pool, tables = _paged_setup(tcfg, tparams, pre)
    jpool = {k: jnp.asarray(v.numpy()) for k, v in pool.items()}
    before = {k: v.clone() for k, v in pool.items()}
    with jax.default_matmul_precision("float32"):
        jl, jpool = jt.paged_verify_steps(
            jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos0),
            jnp.asarray(tables.numpy()), jpool, jnp.asarray(write))
    tl, pool = tt.paged_verify_steps(
        tcfg, tparams, torch.from_numpy(toks), torch.from_numpy(pos0),
        tables, pool, torch.from_numpy(write))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    for name in ("k", "v"):
        # block 0 is scratch: duplicate writes land there in any order
        np.testing.assert_allclose(pool[name][:, 1:].numpy(),
                                   np.asarray(jpool[name])[:, 1:],
                                   atol=TOL, rtol=TOL)
        mine = tables[1].long()
        assert torch.equal(pool[name][:, mine], before[name][:, mine])


def test_paged_verify_steps_matches_serial_paged_decode(tiny):
    _, _, _, tcfg, tparams, _ = tiny
    rng = np.random.default_rng(6)
    pre = rng.integers(0, 64, (2, 5)).astype(np.int32)
    toks = rng.integers(0, 64, (2, 4)).astype(np.int32)
    pool, tables = _paged_setup(tcfg, tparams, pre)
    serial_pool = {k: v.clone() for k, v in pool.items()}
    got, pool = tt.paged_verify_steps(
        tcfg, tparams, torch.from_numpy(toks),
        torch.full((2,), 5, dtype=torch.int32), tables, pool)
    for c in range(4):
        want, serial_pool = tt.paged_decode_steps(
            tcfg, tparams, torch.from_numpy(toks[:, c]),
            torch.full((2,), 5 + c, dtype=torch.int32), tables, serial_pool)
        np.testing.assert_allclose(got[:, c].numpy(), want.numpy(),
                                   atol=TOL, rtol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(pool[name].numpy(),
                                   serial_pool[name].numpy(), atol=TOL,
                                   rtol=TOL)


# ---------------------------------------------------------------- engines

# jobs submitted one after another: a short prompt, a two-token one, a
# prompt of several chunks (the batched and chunked paths take it in)
JOBS = [([3, 17, 42], 10), ([5, 11], 6),
        ([9, 8, 7, 6, 5, 4, 3, 2, 1, 2, 3, 40, 41, 20], 12)]
CASES = {
    "slot_token": dict(prefill_mode="token"),
    "slot_batched": dict(prefill_mode="batched"),
    "slot_chunked": dict(prefill_mode="chunked", prefill_chunk=8),
    # blocks of 8: streams cross 2-4 block boundaries, with fewer table
    # widths for the reference engine to compile than blocks of 4
    "paged_token": dict(kv_layout="paged", kv_block_len=8),
    "paged_chunked": dict(kv_layout="paged", kv_block_len=8,
                          prefill_mode="chunked", prefill_chunk=8),
}
# the reference test's engines: a self-draft at gamma 4 (every proposal
# accepted) and the adversarial draft at gamma 3
DRAFTS = {"self": 4, "adversarial": 3}


def _drafts(tiny, which):
    jcfg, jparams, jdraft, tcfg, tparams, tdraft = tiny
    if which == "self":
        return (jspec.DraftModel(jcfg, jparams),
                tspec.DraftModel(tcfg, tparams))
    return jspec.DraftModel(jcfg, jdraft), tspec.DraftModel(tcfg, tdraft)


def _counters(engine) -> dict:
    snap = engine.gen_stats.snapshot()
    return {k: snap[k] for k in ("spec_proposed", "spec_accepted",
                                 "spec_rejected", "spec_rounds",
                                 "spec_rung_rounds", "prefix_hits",
                                 "tokens")}


def _serve(engine, jobs, **kw) -> list:
    return [list(engine.submit(np.asarray(p, np.int32), b, **kw))
            for p, b in jobs]


def _both(tiny, jobs, draft="self", engine_kw=None, submit_kw=None,
          gamma=None):
    """The JAX speculative engine and the port's, same weights and knobs,
    each serving ``jobs`` one after another: (streams, counters,
    speculation snapshot) of each."""
    jcfg, jparams, _, tcfg, tparams, _ = tiny
    jd, td = _drafts(tiny, draft)
    kw = dict(n_slots=3, chunk=4, speculative_gamma=gamma or DRAFTS[draft],
              **(engine_kw or {}))
    out = []
    for eng in (JaxEngine(jcfg, dict(jparams), speculative_draft=jd, **kw),
                ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                         speculative_draft=td, **kw)):
        eng.start()
        try:
            streams = _serve(eng, jobs, **(submit_kw or {}))
            out.append((streams, _counters(eng), eng.stats()["speculation"],
                        eng))
        finally:
            eng.stop()
    return out


@pytest.mark.parametrize("draft", sorted(DRAFTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_streams_and_counters_match_the_jax_engine(tiny, case, draft):
    ref, port = _both(tiny, JOBS, draft, CASES[case])
    assert port[0] == ref[0]
    assert [len(s) for s in port[0]] == [b for _, b in JOBS]
    assert port[1] == ref[1]
    assert port[1]["spec_rounds"] > 0
    if draft == "self":
        assert port[1]["spec_accepted"] == port[1]["spec_proposed"]
    else:
        assert port[1]["spec_accepted"] < port[1]["spec_proposed"]
    eng = port[3]
    assert not any(s.req is not None for s in eng._slots)
    if eng._paged:
        occ = eng._kv_index.occupancy()
        assert occ["free"] == occ["usable"] and occ["reserved"] == 0


def test_concurrent_streams_stay_token_identical(tiny):
    """Ragged concurrent streams (the reference's oversubscribed job set)
    on an adversarial draft: every stream is the JAX engine's."""
    jobs = [([3, 17, 42], 7), ([5, 11], 3), ([1], 9),
            ([9, 8, 7, 6, 5], 5), ([2, 4], 1), ([40, 30, 20, 10], 11),
            ([6], 2), ([12, 13, 14], 8)]
    jcfg, jparams, _, tcfg, tparams, _ = tiny
    jd, td = _drafts(tiny, "adversarial")
    results = []
    for eng in (JaxEngine(jcfg, dict(jparams), n_slots=3, chunk=4,
                          speculative_draft=jd, speculative_gamma=3),
                ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                         n_slots=3, chunk=4,
                                         speculative_draft=td,
                                         speculative_gamma=3)):
        eng.start()
        got = [None] * len(jobs)

        def run(i, eng=eng, got=got):
            got[i] = list(eng.submit(np.asarray(jobs[i][0], np.int32),
                                     jobs[i][1]))

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(jobs))]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(120)
            assert not any(th.is_alive() for th in threads)
        finally:
            eng.stop()
        results.append(got)
    assert results[1] == results[0]


def test_gamma_ladder_matches_the_jax_engine(tiny):
    """Ladder on at gamma 6: rungs {1, 2, 4, 6}, each stream's rung picked
    from its acceptance (one fetch per dispatch, so the picks follow the
    acceptances early); with the adversarial draft the streams move down
    the ladder, and the rounds per rung are the reference's."""
    ref, port = _both(tiny, [([3, 17, 42], 24), ([5, 11], 20)],
                      "adversarial", dict(speculative_gamma_ladder=True,
                                          fetch_stride=1), gamma=6)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2]["ladder"] == ref[2]["ladder"] == [1, 2, 4, 6]
    assert len(port[1]["spec_rung_rounds"]) > 1


def test_max_seq_edge_latches_to_plain_decode(tiny):
    """A prompt that leaves fewer than gamma + 1 positions never verifies
    (tests/test_speculation.py's case), and a long stream finishes its
    tail on the chunk path once its rounds would clamp."""
    jobs = [(list(range(1, KW["max_seq"] - 3)), 3),
            ([3, 17, 42], KW["max_seq"] - 3)]
    ref, port = _both(tiny, jobs, "self")
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert [len(s) for s in port[0]] == [3, KW["max_seq"] - 3]


def test_eos_inside_an_accepted_prefix_ends_the_stream(tiny):
    _, _, _, tcfg, tparams, _ = tiny
    plain = ContinuousBatchingEngine(tcfg, tparams, device="cpu", n_slots=3,
                                     chunk=4).start()
    try:
        stream = _serve(plain, [([3, 17, 42], 10)])[0]
    finally:
        plain.stop()
    eos = stream[4]
    stop = stream.index(eos)
    ref, port = _both(tiny, [([3, 17, 42], 10)], "self",
                      submit_kw=dict(eos_id=eos))
    assert port[0] == ref[0] == [stream[:stop + 1]]
    assert port[1] == ref[1]


def test_gamma_zero_is_plain_decode(tiny):
    jcfg, jparams, _, tcfg, tparams, _ = tiny
    jd, td = _drafts(tiny, "adversarial")
    ref = JaxEngine(jcfg, dict(jparams), n_slots=2, chunk=4,
                    speculative_draft=jd, speculative_gamma=0).start()
    port = ContinuousBatchingEngine(tcfg, tparams, device="cpu", n_slots=2,
                                    chunk=4, speculative_draft=td,
                                    speculative_gamma=0).start()
    try:
        want = _serve(ref, JOBS)
        assert _serve(port, JOBS) == want
        stats = port.stats()
    finally:
        ref.stop()
        port.stop()
    assert stats["speculation"] is None and stats["spec_rounds"] is None
    assert stats["dispatch_by_kind"]["spec"]["dispatches"] == 0
    assert port._ring_width == 4 and "dcache" not in port._dev


def test_acceptance_floor_latches_each_stream(tiny):
    """The adversarial draft under a floor of 0.5, one fetch per dispatch
    (tests/test_speculation.py's case): each stream latches after the
    warmup rounds and finishes on the chunk path, like the reference's."""
    ref, port = _both(tiny, [([3, 17, 42], 24), ([5, 11], 20)],
                      "adversarial",
                      dict(speculative_min_acceptance=0.5, fetch_stride=1))
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[1]["spec_rounds"] <= 2 * (tspec.FALLBACK_WARMUP_ROUNDS + 4)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_prefix_restored_slots_speculate(tiny, layout):
    """tests/test_speculation.py:620-652 on both layouts: the second prompt
    resumes from the first one's committed blocks, then speculates (the
    draft catches up on its whole prompt)."""
    kw = dict(prefix_cache=True, prefix_blocks=16, prefix_block_len=4)
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block_len=4)
    shared = list(range(1, 13))
    jobs = [(shared + [20, 21], 6), (shared + [30, 31], 6)]
    ref, port = _both(tiny, jobs, "self", kw, gamma=3)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[1]["prefix_hits"] >= 1 and port[1]["spec_rounds"] > 0
    assert port[3]._prefix_index.pinned_nodes() == 0


class _Gate:
    """Holds the engine at its dispatch boundary (before the sweep) once
    the target stream has had tokens delivered from a verify round."""

    def __init__(self, engine):
        self.held = threading.Event()
        self.go = threading.Event()
        sweep = engine._reap_slots

        def reap():
            if not self.go.is_set() and engine.gen_stats.spec_rounds and any(
                    s.req is not None and s.req.tenant == "target"
                    and s.req.emitted >= 1 for s in engine._slots):
                self.held.set()
                self.go.wait(60)
            sweep()

        engine._reap_slots = reap


@pytest.mark.parametrize("ending", ["cancel", "deadline"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_cancel_and_deadline_mid_speculation_free_the_slot(tiny, layout,
                                                           ending,
                                                           monkeypatch):
    """A speculating stream cancelled (499) or past its wire deadline (504)
    at a dispatch boundary: its slot, pool blocks and prefix pins are
    freed, with rounds still in flight, and the engine serves on."""
    _, _, _, tcfg, tparams, tdraft = tiny
    shift = [0]
    monkeypatch.setattr(tgen, "now_ns",
                        lambda: time.monotonic_ns() + shift[0])
    kw = dict(n_slots=2, chunk=4, fetch_stride=1, prefix_cache=True,
              prefix_blocks=16, prefix_block_len=4,
              speculative_draft=tspec.DraftModel(tcfg, tdraft),
              speculative_gamma=3)
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block_len=4)
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **kw).start()
    gate = _Gate(eng)
    prompt = np.asarray(list(range(1, 13)) + [7], np.int32)
    try:
        list(eng.submit(prompt, 2))          # commits the prompt's blocks
        cancel = threading.Event() if ending == "cancel" else None
        deadline = time.monotonic_ns() + int(300e9) \
            if ending == "deadline" else 0
        it = eng.submit(prompt, 30, tenant_id="target", cancel_event=cancel,
                        deadline_ns=deadline)
        got = [next(it)]
        assert gate.held.wait(60)
        assert eng._prefix_index.pinned_nodes() > 0
        if cancel is not None:
            cancel.set()
        else:
            shift[0] = int(301e9)
        gate.go.set()
        with pytest.raises(ServerError) as ei:
            got.extend(it)
        assert ei.value.status == (499 if ending == "cancel" else 504)
        assert len(got) < 30
        deadline_s = time.monotonic() + 60
        while any(s.req is not None for s in eng._slots):
            assert time.monotonic() < deadline_s
            time.sleep(0.005)
        assert eng._prefix_index.pinned_nodes() == 0
        if eng._paged:
            occ = eng._kv_index.occupancy()
            assert occ["stream"] == 0 and occ["reserved"] == 0
        snap = eng.gen_stats.snapshot()
        assert snap["cancelled" if ending == "cancel"
                    else "deadline_expired"] == 1
        shift[0] = 0
        assert len(list(eng.submit(np.asarray([5, 11], np.int32), 5))) == 5
    finally:
        gate.go.set()
        eng.stop()


def test_sampled_streams_keep_their_seed_and_accept_a_self_draft(tiny):
    """Sampled speculation: streams stay in the vocab and reach their
    budget, repeat with their seed, and a self-draft (q == p) accepts
    every proposal, as the reference's rejection rule says."""
    _, _, _, tcfg, tparams, tdraft = tiny
    for draft, accept_all in ((tparams, True), (tdraft, False)):
        eng = ContinuousBatchingEngine(
            tcfg, tparams, device="cpu", n_slots=3, chunk=4,
            speculative_draft=tspec.DraftModel(tcfg, draft),
            speculative_gamma=4).start()
        try:
            kw = dict(temperature=0.8, top_k=8, top_p=0.9, seed=5)
            first = _serve(eng, JOBS, **kw)
            again = _serve(eng, JOBS, **kw)
            other = _serve(eng, JOBS, **{**kw, "seed": 6})
            snap = eng.stats()["speculation"]
        finally:
            eng.stop()
        assert first == again and first != other
        assert [len(s) for s in first] == [b for _, b in JOBS]
        assert all(0 <= tok < KW["vocab_size"] for s in first for tok in s)
        assert snap["rounds"] > 0
        assert (snap["accepted"] == snap["proposed"]) == accept_all


def test_the_gamma_ceiling_steers_rounds_without_changing_tokens(tiny):
    """set_speculation_gamma snaps to a ladder rung and 0 turns rounds
    off; greedy streams are the same at every ceiling (the reference's
    knob surface)."""
    _, _, _, tcfg, tparams, tdraft = tiny
    eng = ContinuousBatchingEngine(
        tcfg, tparams, device="cpu", n_slots=3, chunk=4,
        speculative_draft=tspec.DraftModel(tcfg, tdraft),
        speculative_gamma=6, speculative_gamma_ladder=True).start()
    try:
        want = _serve(eng, JOBS)
        eng.set_speculation_gamma(3)
        assert eng.speculation_gamma == 2 and eng.speculation_enabled
        assert _serve(eng, JOBS) == want
        eng.set_speculation_enabled(False)
        assert eng.speculation_gamma == 0 and not eng.speculation_enabled
        rounds = eng.stats()["spec_rounds"]
        assert _serve(eng, JOBS) == want
        assert eng.stats()["spec_rounds"] == rounds
        eng.set_speculation_enabled(True)
        assert eng.speculation_gamma == 2
        with pytest.raises(ValueError):
            eng.set_speculation_gamma(-1)
    finally:
        eng.stop()


# ---------------------------------------------------------------- generator

@pytest.mark.parametrize("form", ["config", "dict", "draft", "off"])
def test_generator_config_json_matches_the_reference(tiny, form):
    jcfg, jparams, _, tcfg, tparams, _ = tiny
    block = dict(enabled=True, gamma=3, min_acceptance=0.2,
                 draft={"n_layers": 1, "d_model": 32, "n_heads": 2,
                        "head_dim": 16, "d_ff": 64},
                 draft_seed=4, gamma_ladder=True)
    if form == "config":
        kw_ref = dict(speculative_draft=JaxSpecConfig(**block))
        kw_port = dict(speculative_draft=SpeculativeConfig(**block))
    elif form == "dict":
        kw_ref = kw_port = dict(speculative_draft=dict(block))
    elif form == "draft":
        kw_ref = dict(speculative_draft=(jcfg, jparams), speculative_gamma=2)
        kw_port = dict(speculative_draft=(tcfg, tparams),
                       speculative_gamma=2)
    else:
        kw_ref = kw_port = dict(speculative_draft=dict(block, gamma=0))
    ref = jax_generator("spec_lm", cfg=jcfg, params=jparams, n_slots=2,
                        chunk_size=4, **kw_ref)
    port = make_continuous_generator("spec_lm", cfg=tcfg, params=tparams,
                                     device="cpu", n_slots=2, chunk_size=4,
                                     **kw_port)
    try:
        rj, pj = ref.config.to_json(), port.config.to_json()
        assert pj.get("speculative") == rj.get("speculative")
        for key in ("ring_entries", "fetch_stride"):
            assert pj["generation_engine"][key] == \
                rj["generation_engine"][key]
        if form == "off":
            assert "speculative" not in pj
            assert port.engine.stats()["speculation"] is None
        else:
            # the block is what the engine runs
            assert port.engine._gamma == ref.engine._gamma
            assert port.engine._spec.min_acceptance == \
                ref.engine._spec.min_acceptance
            assert port.engine._spec_ladder == ref.engine._spec_ladder
            assert port.engine._ring_entries == ref.engine._ring_entries
    finally:
        ref.engine.stop()
        port.engine.stop()


def test_generator_block_is_authoritative_and_streams_match(tiny):
    """A block's gamma and floor override the keyword defaults, and the
    served greedy stream of a self-draft generator is the reference
    generator's."""
    jcfg, jparams, _, tcfg, tparams, _ = tiny
    port = make_continuous_generator(
        "spec_auth_lm", cfg=tcfg, params=tparams, device="cpu", n_slots=2,
        chunk_size=4, speculative_gamma=7,
        speculative_draft=SpeculativeConfig(enabled=True, gamma=2,
                                            min_acceptance=0.25,
                                            draft={"n_layers": 1}))
    try:
        assert port.engine._gamma == 2
        assert port.engine._spec.min_acceptance == 0.25
        assert port.config.to_json()["speculative"]["gamma"] == 2
        assert port.engine._draft.cfg.n_layers == 1
    finally:
        port.engine.stop()
    ref = JaxEngine(jcfg, dict(jparams), n_slots=2, chunk=4)
    gen = make_continuous_generator(
        "spec_self_lm", cfg=tcfg, params=tparams, device="cpu", n_slots=2,
        chunk_size=4, speculative_draft=(tcfg, tparams),
        speculative_gamma=3)
    try:
        want = _serve(ref.start(), JOBS)
        outs = []
        for p, b in JOBS:
            outs.append([int(r["TOKEN"][0]) for r in gen._stream_fn(
                {"PROMPT": np.asarray(p, np.int32),
                 "MAX_TOKENS": np.asarray([b], np.int32)})])
        assert outs == want
        assert gen.engine.stats()["speculation"]["rounds"] > 0
    finally:
        ref.stop()
        gen.engine.stop()
