"""The port's engine under the slot KV layout and the batched and chunked
prefill modes (client_tpu_torch.server.generation), end to end on the CPU,
held against the JAX package's engine with the same f32 weights.

Greedy streams must be token-identical to the reference engine's in the
same configuration: the slot layout under each prefill mode, the paged
layout under the chunked lane, and a lane budget below the chunk length.
Sampled streams must reproduce on resubmission with the same seed. The
knob validation follows the reference's (tests/test_chunked_prefill.py),
and the engine and the generator built with no ``kv_layout`` take the
reference's default, the slot layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import transformer as jt
from client_tpu.perf import bench_harness as jbh
from client_tpu.server.generation import (
    ContinuousBatchingEngine as JaxEngine,
)
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.models.decoder_lm import make_continuous_generator
from client_tpu_torch.perf import bench_harness as tbh
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server.generation import ContinuousBatchingEngine
from client_tpu_torch.server.types import InferRequest, InferTensor

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=64, causal=True)
ENGINE = dict(n_slots=4, chunk=4)
# prompts up to 39 tokens: several lane chunks of 16 and batched buckets
# past the chunk of 4
CASES = {
    "slot_token": dict(prefill_mode="token"),
    "slot_batched": dict(prefill_mode="batched"),
    "slot_chunked": dict(prefill_mode="chunked", prefill_chunk=16),
    "paged_chunked": dict(kv_layout="paged", kv_block_len=4,
                          prefill_mode="chunked", prefill_chunk=16),
    "slot_chunked_budget3": dict(prefill_mode="chunked", prefill_chunk=16,
                                 prefill_token_budget=3),
}


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def jobs():
    got = tbh.ragged_generation_jobs(11, 64, 6, (1, 40), (3, 20), 64)
    want = jbh.ragged_generation_jobs(11, 64, 6, (1, 40), (3, 20), 64)
    assert all(np.array_equal(a[0], b[0]) and a[1] == b[1]
               for a, b in zip(got, want))
    return got


@pytest.fixture(scope="module")
def jax_streams(model, jobs):
    """The reference engine's greedy streams per case, each engine built
    once per module, on first use."""
    jcfg, jparams, _, _ = model
    cache: dict = {}

    def streams(case: str) -> list:
        if case not in cache:
            eng = JaxEngine(jcfg, dict(jparams), **ENGINE,
                            **CASES[case]).start()
            try:
                cache[case] = jbh.run_engine_jobs(
                    eng, jobs, collect=True, join_timeout_s=300)[2]
            finally:
                eng.stop()
        return cache[case]

    return streams


def _port_engine(model, **kw):
    _, _, tcfg, tparams = model
    return ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                    **{**ENGINE, **kw}).start()


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_streams_match_the_jax_engine(model, jobs, jax_streams,
                                             case):
    eng = _port_engine(model, **CASES[case])
    try:
        _, _, toks = tbh.run_engine_jobs(eng, jobs, collect=True,
                                         join_timeout_s=300)
        stats = eng.stats()
    finally:
        eng.stop()
    assert [len(x) for x in toks] == [b for _, b in jobs]
    assert toks == jax_streams(case)
    assert stats["tokens_emitted"] == sum(b for _, b in jobs)
    lane = stats["prefill_lane"]
    if "chunked" in case:
        # every prompt token past each prompt's last chunk-kernel tail went
        # through the lane, in chunks no larger than the budget
        budget = CASES[case].get("prefill_token_budget") or 16
        assert lane["chunks"] > 0 and lane["backlog_tokens"] == 0
        assert lane["tokens"] <= lane["chunks"] * budget
        assert eng.gen_stats.snapshot()["prefill_tokens"] == lane["tokens"]
        assert stats["phase_seconds"]["prefill"] > 0
    else:
        assert lane is None
    if CASES[case].get("kv_layout") == "paged":
        occ = eng._kv_index.occupancy()
        assert occ["free"] == occ["usable"] and occ["reserved"] == 0
    else:
        assert stats["kv_paged"] is None and eng._kv_index is None


@pytest.mark.parametrize("case", ["slot_batched", "slot_chunked",
                                  "paged_chunked"])
def test_sampled_streams_reproduce_with_their_seed(model, jobs, case):
    eng = _port_engine(model, **CASES[case])
    try:
        kw = dict(temperature=0.8, top_k=8, top_p=0.95, seed=11)
        first = tbh.run_engine_jobs(eng, jobs, collect=True, **kw)[2]
        again = tbh.run_engine_jobs(eng, jobs, collect=True, **kw)[2]
        other = tbh.run_engine_jobs(eng, jobs, collect=True,
                                    **{**kw, "seed": 12})[2]
    finally:
        eng.stop()
    assert first == again
    assert first != other
    assert all(0 <= tok < 64 for s in first for tok in s)


def test_knob_validation_follows_the_reference(model):
    """tests/test_chunked_prefill.py's mode validation, plus batched under
    the paged layout; each raises the reference's error type."""
    jcfg, jparams, tcfg, tparams = model
    bad = [dict(prefill_mode="interleaved"),
           dict(prefill_mode="chunked", prefill_chunk=0),
           dict(prefill_mode="chunked", prefill_chunk=128),
           dict(prefill_mode="chunked", prefill_token_budget=-1),
           dict(kv_layout="paged", prefill_mode="batched"),
           dict(kv_layout="paged", prefill=True)]
    words = ["prefill_mode", "prefill_chunk", "max_seq",
             "prefill_token_budget", "batched", "batched"]
    for kw, word in zip(bad, words):
        with pytest.raises(ValueError, match=word):
            ContinuousBatchingEngine(tcfg, tparams, device="cpu", **kw)
        with pytest.raises(ValueError, match=word):
            JaxEngine(jcfg, dict(jparams), **kw)
    for prefill, mode, want in ((True, "chunked", "chunked"),
                                (True, None, "batched"),
                                (False, None, "token")):
        assert ContinuousBatchingEngine.resolve_prefill_mode(
            prefill, mode) == want
        assert JaxEngine.resolve_prefill_mode(prefill, mode) == want
    for mode, chunk, budget, want in (("chunked", 16, 0, 16),
                                      ("chunked", 16, 3, 3),
                                      ("token", 16, 0, 0)):
        assert ContinuousBatchingEngine.resolve_prefill_budget(
            mode, chunk, budget) == want
        assert JaxEngine.resolve_prefill_budget(mode, chunk, budget) == want


def test_defaults_build_the_slot_layout_like_the_reference(model):
    jcfg, jparams, tcfg, tparams = model
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu")
    gen = make_continuous_generator(cfg=tcfg, params=tparams, device="cpu")
    ref = JaxEngine(jcfg, dict(jparams))
    assert ref._kv_layout == "slot" and ref._prefill_mode == "token"
    for e in (eng, gen.engine):
        stats = e.stats()
        assert stats["kv_layout"] == "slot"
        assert stats["prefill_mode"] == "token"
        assert stats["kv_paged"] is None and stats["prefill_lane"] is None
    assert eng._prefill_chunk_len == ref._prefill_chunk_len == 64
    assert eng._prefill_budget == ref._prefill_budget == 0


def test_int8_kv_raises_naming_its_roadmap_item():
    """Named when int8 KV still raised; int8 KV (ROADMAP A10i) is ported
    now, so ``kv_quant`` builds the int8 state: int8 K/V with f32 scale
    tables of the reference's shapes, and an engine on it."""
    cfg = tt.TransformerConfig(kv_quant=True, dtype=torch.float32, **KW)
    st = tt.init_decode_state(cfg, 2, "cpu")
    want = jax.vmap(lambda _: jt.init_decode_state(jt.TransformerConfig(
        kv_quant=True, dtype=jnp.float32, **KW)))(jnp.arange(2))
    assert set(st) == set(want)
    for name, arr in st.items():
        assert tuple(arr.shape) == want[name].shape
        assert str(arr.dtype) == f"torch.{want[name].dtype}"
    eng = ContinuousBatchingEngine(cfg, tt.init_params(
        torch.Generator().manual_seed(0), cfg), device="cpu", **ENGINE)
    try:
        assert len(list(eng.submit(np.asarray([3, 17], np.int32), 3))) == 3
        assert eng._dev["cache"]["k"].dtype == torch.int8
        assert eng._dev["cache"]["k_scale"].dtype == torch.float32
    finally:
        eng.stop()


def test_served_decoupled_path_on_the_slot_default(model, jobs,
                                                   jax_streams):
    """make_continuous_generator with no kv_layout, through
    TorchInferenceServer.infer with a callback: the greedy stream is the
    reference slot engine's, then the final flag."""
    import threading

    _, _, tcfg, tparams = model
    core = TorchInferenceServer()
    gen = make_continuous_generator(
        "gen", cfg=tcfg, params=tparams, device="cpu", n_slots=4,
        chunk_size=4, prefill_mode="chunked", prefill_chunk=16)
    core.register_model(gen, warmup=True)
    try:
        prompt, budget = jobs[2]
        got, done = [], threading.Event()

        def cb(resp, final):
            got.append((resp, final))
            if final:
                done.set()

        core.infer(InferRequest(model_name="gen", inputs=[
            InferTensor("PROMPT", "INT32", (len(prompt),),
                        data=np.asarray(prompt, np.int32)),
            InferTensor("MAX_TOKENS", "INT32", (1,),
                        data=np.asarray([budget], np.int32))]),
            response_callback=cb)
        assert done.wait(120)
        stats = gen.engine.stats()
    finally:
        core.stop()
    assert len(got) == budget + 1 and got[-1][1]
    toks = [int(resp.output("TOKEN").data[0]) for resp, _ in got[:-1]]
    assert toks == jax_streams("slot_chunked")[2]
    assert stats["kv_layout"] == "slot"
    assert stats["prefill_lane"]["chunks"] > 0
