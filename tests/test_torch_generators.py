"""The single-stream and static-batch generators of the port, on the CPU,
held against the JAX package's.

The same f32 weights (``params_from_jax``) at the reference tests' tiny
decode config serve ``make_generator`` and ``make_batch_generator`` in
both packages, each through its own server's ``infer`` with a response
callback (the call gRPC's ``ModelStreamInfer`` makes):

- greedy streams token for token equal to the JAX generators', for
  prompts of 1 to 9 tokens (every prefill bucket) with budgets that end
  inside a chunk, on a chunk boundary and across two chunks and a tail;
- the batch generator's greedy rows equal to the JAX batch generator's;
- ``transformer.decode_loop`` equal to the JAX ``decode_loop``, and
  ``sampling.sample_loop`` equal to a step-by-step ``decode_step`` plus
  ``select_token`` loop (the selection drawn at the position before each
  step); the port's noise is not the reference's, so sampled tokens are
  held to the port's own step loop, not to JAX;
- the reference's 400s and empty stream, status and the words that
  matter of each message equal to the JAX server's answer;
- per-row SEEDS and the scalar SEED fallback against the step loop;
- two streams whose steps interleave equal to their solo runs (every
  request builds its own state: ``decode_step`` writes K/V in place);
- the chunk driver's dispatches: one loop per full chunk, single steps
  for the tail, none after the final token; ``PREFILL_END`` stamped on
  a trace.

Tolerance: tokens, statuses and words exact; no float compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import decoder_lm as jlm
from client_tpu.models import transformer as jt
from client_tpu.server import TpuInferenceServer
from client_tpu.server.types import InferRequest as JReq
from client_tpu.server.types import InferTensor as JTensor
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import sampling as ts
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server import trace as ttrace
from client_tpu_torch.server.types import InferRequest as TReq
from client_tpu_torch.server.types import InferTensor as TTensor

CHUNK = 4


@pytest.fixture(scope="module")
def tiny():
    """The reference tests' tiny decode config (max_seq 16) in f32, its
    weights in both packages."""
    jcfg = jt.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
        d_ff=64, max_seq=16, causal=True, dtype=jnp.float32,
        attn_impl="ref")
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tcfg = tt.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
        d_ff=64, max_seq=16, causal=True, dtype=torch.float32,
        attn_impl="ref")
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def servers(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    ref, port = TpuInferenceServer(), TorchInferenceServer()
    ref.register_model(jlm.make_generator(
        "gen", cfg=jcfg, params=jparams, chunk_size=CHUNK))
    ref.register_model(jlm.make_batch_generator(
        "bgen", cfg=jcfg, params=jparams, max_batch=4, chunk_size=CHUNK))
    port.register_model(tlm.make_generator(
        "gen", cfg=tcfg, params=tparams, chunk_size=CHUNK, device="cpu"))
    port.register_model(tlm.make_batch_generator(
        "bgen", cfg=tcfg, params=tparams, max_batch=4, chunk_size=CHUNK,
        device="cpu"))
    yield {"ref": (ref, JReq, JTensor), "port": (port, TReq, TTensor)}
    ref.stop()
    port.stop()


def _run(side, model: str, inputs: dict) -> tuple:
    """Serve one request through ``side``'s server with a response
    callback: (the output rows in order, (status, error) or None)."""
    core, req_cls, tensor_cls = side
    tensors = [tensor_cls(k, "INT32" if v.dtype.kind == "i" else "FP32",
                          tuple(v.shape), data=v)
               for k, v in inputs.items()]
    rows, err = [], []

    def cb(resp, final):
        if resp.error is not None:
            err.append((resp.error_status, resp.error))
        elif resp.outputs:
            rows.append(np.asarray(resp.outputs[0].data).reshape(-1))

    try:
        core.infer(req_cls(model_name=model, inputs=tensors),
                   response_callback=cb)
    except Exception as e:  # noqa: BLE001 — the server's own refusal
        err.append((e.status, str(e)))
    return rows, (err[0] if err else None)


def _tokens(rows) -> list:
    return [int(r[0]) for r in rows]


def _i32(*xs) -> np.ndarray:
    return np.array(xs, np.int32)


# prompt length -> budget: buckets 8 and 16 (a 1-token prompt takes the
# step path), budgets inside a chunk, on its edge, over two chunks and a
# tail, and clamped at max_seq
GREEDY_CASES = [(1, 10), (2, 3), (5, 4), (8, 8), (9, 7), (3, 20)]


@pytest.mark.parametrize("plen,budget", GREEDY_CASES)
def test_generator_greedy_stream_equals_the_jax_generator(servers, plen,
                                                          budget):
    prompt = np.random.default_rng(plen).integers(0, 64, plen).astype(
        np.int32)
    inputs = {"PROMPT": prompt, "MAX_TOKENS": _i32(budget)}
    got = {s: _run(servers[s], "gen", inputs) for s in servers}
    assert got["port"][1] is None and got["ref"][1] is None
    want = _tokens(got["ref"][0])
    assert len(want) == min(budget, 16 - plen)
    assert _tokens(got["port"][0]) == want


def test_batch_generator_greedy_rows_equal_the_jax_batch_generator(
        servers):
    prompts = np.random.default_rng(3).integers(0, 64, (3, 4)).astype(
        np.int32)
    inputs = {"PROMPTS": prompts, "MAX_TOKENS": np.full((3, 1), 9,
                                                        np.int32)}
    got = {s: _run(servers[s], "bgen", inputs) for s in servers}
    ref = np.stack(got["ref"][0], axis=1)
    port = np.stack(got["port"][0], axis=1)
    assert ref.shape == (3, 9)
    np.testing.assert_array_equal(port, ref)


REFUSALS = [
    ("gen", {"PROMPT": np.zeros(16, np.int32)}, ["max context length"]),
    ("gen", {"PROMPT": _i32(1, 2), "TOP_K": _i32(65)},
     ["TOP_K=65", "64"]),
    ("bgen", {"PROMPTS": np.zeros((0, 3), np.int32)},
     ["PROMPTS", "[batch, len]"]),
    # a 1-D PROMPTS never reaches the model: the server's rank check
    ("bgen", {"PROMPTS": np.zeros(3, np.int32)}, ["PROMPTS", "rank 1"]),
    ("bgen", {"PROMPTS": np.zeros((5, 2), np.int32)},
     ["batch 5", "max_batch 4"]),
    ("bgen", {"PROMPTS": np.zeros((2, 16), np.int32)},
     ["max context length"]),
    ("bgen", {"PROMPTS": np.zeros((2, 2), np.int32),
              "SEEDS": _i32(1, 2, 3)[:, None]}, ["SEEDS", "3 != 2"]),
    ("bgen", {"PROMPTS": np.zeros((2, 2), np.int32),
              "TOP_K": np.full((2, 1), 99, np.int32)}, ["TOP_K=99"]),
]


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_refusals_match_the_jax_generators(servers, case):
    model, inputs, words = REFUSALS[case]
    got = {s: _run(servers[s], model, inputs) for s in servers}
    assert got["ref"][0] == [] and got["port"][0] == []
    (rstatus, rmsg), (pstatus, pmsg) = got["ref"][1], got["port"][1]
    assert pstatus == rstatus == 400
    for w in words:
        assert w in rmsg and w in pmsg, (w, rmsg, pmsg)


def test_empty_prompt_streams_nothing_as_the_reference(servers):
    got = {s: _run(servers[s], "gen", {"PROMPT": np.zeros(0, np.int32)})
           for s in servers}
    assert got["ref"] == ([], None) and got["port"] == ([], None)


def test_decode_loop_equals_the_jax_decode_loop(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    prompt = [5, 11, 2]
    jstate = jt.init_decode_state(jcfg)
    tstate = tt.init_decode_state(tcfg, 1, "cpu")
    for tok in prompt[:-1]:
        _, jstate = jt.decode_step(jcfg, jparams, jnp.int32(tok), jstate)
        _, tstate = tt.decode_step(tcfg, tparams, torch.tensor(
            [tok], dtype=torch.int32), tstate)
    jtoks, jnext, jstate = jt.decode_loop(jcfg, jparams,
                                          jnp.int32(prompt[-1]), jstate, 6)
    ttoks, tnext, tstate = tt.decode_loop(tcfg, tparams, torch.tensor(
        [prompt[-1]], dtype=torch.int32), tstate, 6)
    assert ttoks.shape == (1, 6) and ttoks.dtype == torch.int32
    assert ttoks[0].tolist() == np.asarray(jtoks).tolist()
    assert int(tnext[0]) == int(jnext)
    assert int(tstate["pos"][0]) == int(jstate["pos"]) == 8


def _step_loop(cfg, params, tokens, state, k, seed, temp, top_k, top_p):
    """sample_loop written out: decode_step, then select_token at the
    position before the step."""
    toks = []
    for _ in range(k):
        toks.append(tokens)
        pos = state["pos"]
        logits, state = tt.decode_step(cfg, params, tokens, state)
        tokens = ts.select_token(logits, seed, pos, temp, top_k, top_p)
    return torch.stack(toks, 1), tokens, state


@pytest.mark.parametrize("knobs", [(0.0, 0, 0.0), (0.9, 0, 0.0),
                                   (0.8, 5, 0.0), (1.1, 0, 0.7)],
                         ids=["greedy", "full", "top_k", "top_p"])
def test_sample_loop_equals_a_step_by_step_select_token_loop(tiny, knobs):
    _, _, tcfg, tparams = tiny
    temp, top_k, top_p = knobs
    seed = torch.tensor([3, 4, 5])
    toks0 = torch.tensor([1, 2, 3], dtype=torch.int32)
    got = ts.sample_loop(tcfg, tparams, toks0,
                         tt.init_decode_state(tcfg, 3, "cpu"), 7, seed,
                         temp, top_k, top_p)
    want = _step_loop(tcfg, tparams, toks0,
                      tt.init_decode_state(tcfg, 3, "cpu"), 7, seed, temp,
                      top_k, top_p)
    assert got[0].shape == (3, 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2]["pos"].tolist() == want[2]["pos"].tolist() == [7] * 3
    assert torch.equal(got[2]["k"], want[2]["k"])


def _batch_tokens(port, prompts, budget, **extra) -> np.ndarray:
    """Every [B, 1] input of the batch model, as the wire carries it."""
    b = len(prompts)
    inputs = {"PROMPTS": prompts,
              "MAX_TOKENS": np.full((b, 1), budget, np.int32),
              "TEMPERATURE": np.full((b, 1), 0.9, np.float32),
              "TOP_K": np.full((b, 1), 8, np.int32),
              **{k: np.broadcast_to(v[:, None] if len(v) == b else v,
                                    (b, 1)).copy()
                 for k, v in extra.items()}}
    rows, err = _run(port, "bgen", inputs)
    assert err is None
    return np.stack(rows, axis=1)


def _batch_step_loop(tcfg, tparams, prompts, budget, seeds) -> np.ndarray:
    state = tt.init_decode_state(tcfg, len(prompts), "cpu")
    seed = torch.tensor(seeds)
    cols = torch.from_numpy(prompts.T.copy())
    nxt = None
    for col in cols:
        pos = state["pos"]
        logits, state = tt.decode_step(tcfg, tparams, col, state)
        nxt = ts.select_token(logits, seed, pos, 0.9, 8)
    toks, _, _ = _step_loop(tcfg, tparams, nxt, state, budget, seed, 0.9,
                            8, 0.0)
    return toks.numpy()


def test_batch_generator_seeds_per_row_and_the_scalar_fallback(servers,
                                                               tiny):
    _, _, tcfg, tparams = tiny
    port = servers["port"]
    prompts = np.tile(_i32(7, 1, 9), (3, 1))
    per_row = _batch_tokens(port, prompts, 9, SEEDS=_i32(11, 12, 13))
    np.testing.assert_array_equal(
        per_row, _batch_step_loop(tcfg, tparams, prompts, 9, [11, 12, 13]))
    # the same prompt in every row: distinct seeds draw distinct streams
    assert len({tuple(r) for r in per_row}) > 1
    scalar = _batch_tokens(port, prompts, 9, SEED=_i32(12))
    np.testing.assert_array_equal(
        scalar, _batch_step_loop(tcfg, tparams, prompts, 9, [12] * 3))
    assert (scalar == scalar[0]).all()
    np.testing.assert_array_equal(scalar[0], per_row[1])


def test_interleaved_streams_equal_their_solo_runs(tiny):
    """Two requests' steps interleaved on one thread: every request owns
    its state, so neither sees the other's in-place K/V writes."""
    _, _, tcfg, tparams = tiny
    model = tlm.make_generator("gen", cfg=tcfg, params=tparams,
                               chunk_size=CHUNK, device="cpu")
    a = {"PROMPT": _i32(5, 11, 2, 9), "MAX_TOKENS": _i32(10),
         "TEMPERATURE": np.array([0.8], np.float32), "SEED": _i32(4)}
    b = {"PROMPT": _i32(3), "MAX_TOKENS": _i32(11)}
    solo = [[int(r["TOKEN"][0]) for r in model.stream(x)] for x in (a, b)]
    its = [model.stream(a), model.stream(b)]
    both = [[], []]
    live = [True, True]
    while any(live):
        for i, it in enumerate(its):
            if live[i]:
                try:
                    both[i].append(int(next(it)["TOKEN"][0]))
                except StopIteration:
                    live[i] = False
    assert both == solo
    assert [len(s) for s in solo] == [10, 11]


def test_chunk_driver_dispatches_one_loop_per_chunk_and_a_tail():
    calls = []

    def loop(tok, st):
        calls.append("loop")
        return torch.arange(int(tok), int(tok) + CHUNK)[None], tok + CHUNK, st

    def step(tok, st):
        calls.append("step")
        return tok + 1, st

    start = torch.tensor([0])
    blocks = list(tlm._chunk_driver({"loop": loop, "step": step}, start,
                                    None, 2 * CHUNK + 3, CHUNK))
    assert [b.reshape(-1).tolist() for b in blocks] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10]]
    # the tail's 3 tokens take 2 steps: none after the final token
    assert calls == ["loop", "loop", "step", "step"]
    assert list(tlm._chunk_driver({"loop": loop, "step": step}, start,
                                  None, 0, CHUNK)) == []


def test_prefill_end_is_stamped_on_the_trace(tiny):
    _, _, tcfg, tparams = tiny
    model = tlm.make_generator("gen", cfg=tcfg, params=tparams,
                               device="cpu")

    class Ctx:
        trace = ttrace.Trace("t1", "gen", "1")

    toks = list(model.stream({"PROMPT": _i32(1, 2, 3),
                              "MAX_TOKENS": _i32(2)}, Ctx()))
    assert len(toks) == 2
    assert [e[0] for e in Ctx.trace.timestamps] == [ttrace.PREFILL_END]


def test_prefill_select_makes_a_one_slot_view_of_the_prefill_state(tiny):
    _, _, tcfg, tparams = tiny
    toks = torch.tensor([4, 8, 15, 16, 23, 0, 0, 0], dtype=torch.int32)
    seed = torch.tensor([0])
    nxt, state = tlm._prefill_select(tcfg, tparams, toks, 5, seed, 0.0, 0,
                                     0.0)
    full, logits = tt.prefill(tcfg, tparams, toks, 5)
    assert state["k"].shape == (1, *full["k"].shape)
    assert state["k"]._base is not None   # a view, no copy
    assert state["pos"].tolist() == [5]
    assert nxt.tolist() == [int(logits.argmax())]
    assert tlm._prefill_bucket(1, 16) == 8
    assert [tlm._prefill_bucket(n, 16) for n in (8, 9, 16)] == [8, 16, 16]
    step_tok, _ = tlm._greedy_step(tcfg, tparams, nxt, state)
    assert step_tok.shape == (1,) and step_tok.dtype == torch.int32
