"""The port's goodput plane (client_tpu_torch.server.goodput, the FLOP
model of client_tpu_torch.models.transformer, the engine's dispatch sites,
the ``client_tpu_goodput_*`` families and the profiler's goodput gate)
held against the JAX package's on the CPU.

- The FLOP and byte model: every closed form equals the reference's as an
  integer on the same configurations (MHA, GQA, swiglu, int8 KV; the port
  has no MoE FFN yet), and the reference test's hand-computed values.
- The tracker: the same calls under the same fake clock give equal
  snapshots in both packages (cadence split, idle reset, the histogram's
  grid, the k-of-g retire arithmetic, the sampling share, the merge).
- The engines: the same weights and jobs, served one after another, give
  equal per-kind dispatch counts, useful FLOPs and per-reason wasted FLOPs
  (padding, frozen, table_slack, spec_reject) as exact integers on both KV
  layouts, every prefill mode, the prefix cache, both dedicated lanes and
  speculation with rejects; the reference test's exact-row cases hold,
  and so does a paged verify round that trails its stream's end into the
  scratch block (ROADMAP C8, fixed).
- ``/metrics``: the goodput family set equals the reference's, the
  reference's lint finds nothing, and the MFU pair is absent on the CPU.
- The profiler's window gates read the same numbers and say the same.
"""

import dataclasses
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import transformer as jt
from client_tpu.perf import inference_profiler as jprof
from client_tpu.server import goodput as jgp
from client_tpu.server import speculation as jspec
from client_tpu.server.generation import (
    ContinuousBatchingEngine as JaxEngine,
)
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.perf import inference_profiler as tprof
from client_tpu_torch.server import goodput as tgp
from client_tpu_torch.server import speculation as tspec
from client_tpu_torch.server.generation import ContinuousBatchingEngine

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import check_metrics_names  # noqa: E402  (the reference's lint)

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=48, causal=True)


@pytest.fixture(scope="module")
def tiny():
    """The reference test's model shape (max_seq 48 for the lanes), its
    weights in both packages, and an adversarial draft (key 99)."""
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    jdraft = jt.init_params(jax.random.key(99), jcfg)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="ref", **KW)

    def port(p):
        return tt.params_from_jax(jax.tree.map(np.asarray, p), "cpu",
                                  torch.float32)

    return jcfg, jparams, jdraft, tcfg, port(jparams), port(jdraft)


# ---------------------------------------------------------------- FLOP model

VARIANTS = {
    "mha": {},
    "gqa": dict(n_kv_heads=1),
    "swiglu": dict(ffn="swiglu"),
    "int8": dict(kv_quant=True),
    "wide": dict(vocab_size=30528, d_model=768, n_layers=12, n_heads=12,
                 head_dim=64, d_ff=3072, max_seq=192),
}


def _cfgs(variant):
    kw = {**KW, **VARIANTS[variant]}
    return (jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **kw),
            tt.TransformerConfig(dtype=torch.float32, attn_impl="ref", **kw))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_closed_forms_equal_the_reference(variant):
    jcfg, tcfg = _cfgs(variant)
    for fn in ("layer_flops_per_token", "attn_flops_per_pos", "logit_flops",
               "kv_bytes_per_token"):
        got, want = getattr(tt, fn)(tcfg), getattr(jt, fn)(jcfg)
        assert type(got) is int and got == want, fn
    for ctx in (0, 1, 5, 31, 191):
        for logits in (True, False):
            assert tt.token_flops(tcfg, ctx, logits) == \
                jt.token_flops(jcfg, ctx, logits)
        assert tt.token_bytes(tcfg, ctx) == jt.token_bytes(jcfg, ctx)
    for pos0, n in ((0, 1), (0, 7), (3, 4), (10, 1), (5, 6), (4, 0),
                    (-2, 3), (100, 92)):
        for logits in (True, False):
            assert tt.span_flops(tcfg, pos0, n, logits) == \
                jt.span_flops(jcfg, pos0, n, logits)
    fj, ft = jgp.FlopModel(jcfg), tgp.FlopModel(tcfg)
    assert (ft.fixed, ft.attn, ft.logits) == (fj.fixed, fj.attn, fj.logits)
    for pos0, n in ((0, 4), (7, 3), (2, 9)):
        assert ft.span(pos0, n) == tt.span_flops(tcfg, pos0, n)
        assert ft.token(pos0) == tt.token_flops(tcfg, pos0)


def test_hand_computed_tiny_shapes():
    _, cfg = _cfgs("mha")
    # d=32, h=2, dh=16, MHA, gelu d_ff=64: qkv 6144, out 2048, ffn 8192
    assert tt.layer_flops_per_token(cfg) == 6144 + 2048 + 8192
    assert tt.attn_flops_per_pos(cfg) == 4 * 2 * 16
    assert tt.logit_flops(cfg) == 2 * 32 * 64
    assert tt.token_flops(cfg, 5) == 2 * (16384 + 128 * 5) + 4096
    assert tt.token_flops(cfg, 0) == tt.token_flops(cfg, 1)
    assert tt.kv_bytes_per_token(cfg) == 256
    assert tt.kv_bytes_per_token(dataclasses.replace(cfg, kv_quant=True)) \
        == 128 + 2 * 2 * 2 * 4
    assert tt.token_bytes(cfg, 8) == tt.token_bytes(cfg, 1) + 7 * 256
    for pos0, n in ((0, 7), (3, 4), (5, 6)):
        assert tt.span_flops(cfg, pos0, n) == sum(
            tt.token_flops(cfg, p + 1) for p in range(pos0, pos0 + n))


def test_the_wide_model_costs_what_the_card_check_expects():
    """bench.py's generation model: 169.9 M fixed matmul FLOPs, 46.9 M of
    logits and 36,864 per attended position per token (12 layers)."""
    _, cfg = _cfgs("wide")
    fm = tgp.FlopModel(cfg)
    assert fm.fixed == 169_869_312
    assert fm.logits == 46_891_008
    assert fm.attn == 36_864


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H200", 989e12),
    ("weird-gpu", None)])
def test_device_peak_flops_reads_the_cards_name(monkeypatch, name, peak):
    """None on the CPU (the MFU pair stays unregistered); on CUDA the card's
    name is looked up in the port's peak table, an unknown card None."""
    assert tgp.device_peak_flops(None) is None
    assert tgp.device_peak_flops("cpu") is None
    assert tgp.device_peak_flops(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: name)
    assert tgp.device_peak_flops("cuda:0") == peak


# ------------------------------------------------------------------ tracker

def _both_clocked(**kw):
    clk = {"t": 0}
    return clk, [mod.GoodputTracker(clock=lambda: clk["t"], **kw)
                 for mod in (jgp, tgp)]


def _cadence(trs, clk, fm):
    for tr in trs:
        tr.note_dispatch("chunk")
        tr.note_dispatch("spec_g2")
    clk["t"] = 10_000_000
    for tr in trs:
        tr.drain_mark()


def _idle(trs, clk, fm):
    for tr in trs:
        tr.note_dispatch("chunk")
    clk["t"] = 10_000_000
    for tr in trs:
        tr.drain_mark()
        tr.reset_cadence()
    clk["t"] = 40_000_000
    for tr in trs:
        tr.note_dispatch("chunk")
    clk["t"] = 50_000_000
    for tr in trs:
        tr.drain_mark(45_000_000)


def _retire(trs, clk, fm):
    g, pos0, k, s = 3, 10, 2, 2
    for tr in trs:
        tr.note_dispatch(f"spec_g{g}",
                         wasted={"padding": (s - 1) * fm.span(0, g + 1)})
        tr.note_flops(f"spec_g{g}", fm.span(pos0, k),
                      {"spec_reject": fm.span(pos0 + k, g + 1 - k)})
        tr.note_flops("chunk")   # nothing to attribute: a no-op


def _window(trs, clk, fm):
    # drains spread past the MFU window: the rate is the window's
    for i in range(30):
        for tr in trs:
            tr.note_dispatch("paged_decode", useful_flops=1000 + i,
                             wasted={"padding": 7, "frozen": 0})
        clk["t"] += 1_000_000_000
        for tr in trs:
            tr.drain_mark()


SCENARIOS = {"cadence": _cadence, "idle": _idle, "retire": _retire,
             "window": _window}


@pytest.mark.parametrize("peak", [None, 1e9])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_tracker_arithmetic_equals_the_reference(tiny, scenario, peak):
    clk, trs = _both_clocked(peak_flops=peak)
    SCENARIOS[scenario](trs, clk, tgp.FlopModel(tiny[3]))
    clk["t"] += 5_000_000
    ref, port = (tr.snapshot() for tr in trs)
    assert port == ref
    assert [tr.shares() for tr in trs][0] == trs[1].shares()
    if scenario == "idle":
        # 20 ms attributed over 50 ms of wall; the idle gap never booked
        assert port["device_ns"]["chunk"] == 15e6
    if scenario == "cadence":
        assert port["device_ns"] == {"chunk": 5e6, "spec_g2": 5e6}
        counts = port["device_time_hist"]["chunk"][0]
        from client_tpu_torch.server.runtime_stats import COMPILE_BUCKETS_S
        assert len(counts) == len(COMPILE_BUCKETS_S) + 1 == 13
        assert sum(counts) == 1


def test_compile_grid_is_the_reference_grid():
    from client_tpu.server.runtime_stats import COMPILE_BUCKETS_S as ref
    from client_tpu_torch.server.runtime_stats import COMPILE_BUCKETS_S

    assert COMPILE_BUCKETS_S == ref


def test_sampling_share_is_bounded_and_a_cpu_block_waits_on_nothing():
    clk, (jtr, ttr) = _both_clocked(sample_every=2)
    for _ in range(8):
        jtr.note_dispatch("chunk", outputs=jnp.zeros((2,)))
        ttr.note_dispatch("chunk", outputs={"x": [torch.zeros(2)]})
    ref, port = jtr.snapshot(), ttr.snapshot()
    assert port["sampled_total"] == ref["sampled_total"] == 4
    assert port["sampling_share"] == ref["sampling_share"] == 0.5
    assert port["sampled_ewma_ns"] == ref["sampled_ewma_ns"] == {"chunk": 0}
    assert ttr.event_blocks == 0
    # sampling off, or no outputs offered: nothing sampled
    _, (j0, t0) = _both_clocked()
    t0.note_dispatch("chunk", outputs=torch.zeros(2))
    j0.note_dispatch("chunk", outputs=jnp.zeros(2))
    assert t0.snapshot()["sampled_total"] == j0.snapshot()[
        "sampled_total"] == 0


def test_the_wall_clock_starts_at_readiness_not_at_construction():
    """The port's one divergence from the reference's tracker: the engine
    starts the wall at its readiness (``start_clock``), where the
    reference starts it when the tracker is made. A port tracker made at
    0 whose clock starts at 7 s, with a warmup drain before it, gives the
    snapshot of a reference tracker made at 7 s; without the call it
    gives the snapshot of a reference tracker made at 0."""
    warm, ready = 3_000_000_000, 7_000_000_000
    clk = {"t": 0}
    port = tgp.GoodputTracker(clock=lambda: clk["t"], peak_flops=1e9)
    late = tgp.GoodputTracker(clock=lambda: clk["t"], peak_flops=1e9)
    from_start = jgp.GoodputTracker(clock=lambda: clk["t"], peak_flops=1e9)
    clk["t"] = warm
    for tr in (port, late, from_start):
        tr.note_dispatch("chunk")          # a warmup dispatch: no FLOPs
        tr.drain_mark()
    clk["t"] = ready
    port.start_clock()
    at_ready = jgp.GoodputTracker(clock=lambda: clk["t"], peak_flops=1e9)
    for step in range(1, 4):
        clk["t"] = ready + step * 1_000_000_000
        for tr in (port, late, at_ready, from_start):
            tr.note_dispatch("chunk", useful_flops=5_000_000)
            tr.drain_mark()
    clk["t"] = ready + 4_000_000_000
    got, ref = port.snapshot(), at_ready.snapshot()
    for key in ("wall_seconds", "useful_flops_per_s", "mfu",
                "useful_flops_total"):
        assert got[key] == ref[key], key
    assert got["wall_seconds"] == 4.0
    assert late.snapshot()["wall_seconds"] == from_start.snapshot()[
        "wall_seconds"] == 11.0
    assert late.snapshot()["mfu"] == from_start.snapshot()["mfu"]
    assert late.snapshot()["mfu"] < got["mfu"]


def test_merge_equals_the_reference():
    snaps = {}
    for name, mod in (("ref", jgp), ("port", tgp)):
        clk1 = {"t": 0}
        t1 = mod.GoodputTracker(clock=lambda: clk1["t"], peak_flops=100.0)
        t1.note_dispatch("chunk", useful_flops=300, wasted={"padding": 100})
        clk1["t"] = 10_000_000
        t1.drain_mark()
        clk2 = {"t": 0}
        t2 = mod.GoodputTracker(clock=lambda: clk2["t"], peak_flops=50.0)
        t2.note_dispatch("spec_g2", useful_flops=200,
                         wasted={"spec_reject": 400})
        clk2["t"] = 40_000_000
        t2.drain_mark()
        t3 = mod.GoodputTracker(clock=lambda: 0)
        snaps[name] = (mod.merge_goodput([t1.snapshot(), None,
                                          t2.snapshot()]),
                       mod.merge_goodput([t1.snapshot(), t3.snapshot()]),
                       mod.merge_goodput([None, None]))
    assert snaps["port"] == snaps["ref"]
    merged, no_peak, empty = snaps["port"]
    assert merged["peak_flops"] == 150.0
    assert merged["useful_flop_share"] == 0.5
    assert no_peak["mfu"] is None and empty is None


# ------------------------------------------------------------------ engines

# jobs submitted one after another: a short prompt, a two-token one, a
# prompt of several chunks, and a repeat of it (a prefix hit with the cache)
LONG = [9, 8, 7, 6, 5, 4, 3, 2, 1, 2, 3, 40, 41, 20, 33, 12, 7, 19, 2, 5]
JOBS = [([3, 17, 42], 10), ([5, 11], 6), (LONG, 12), (LONG, 7),
        (LONG[:13], 5)]
PAGED = dict(kv_layout="paged", kv_block_len=8)
CHUNKED = dict(prefill_mode="chunked", prefill_chunk=8)
LANE = dict(prefill_slots=2, prefill_lane_width=8, prefix_cache=True,
            prefix_block_len=8, **CHUNKED)
CASES = {
    "slot_token": {},
    "slot_batched": dict(prefill_mode="batched"),
    "slot_chunked": CHUNKED,
    "paged_token": PAGED,
    "paged_chunked": dict(PAGED, **CHUNKED),
    "prefix_slot": dict(prefix_cache=True, prefix_block_len=8,
                        prefill_mode="chunked", prefill_chunk=8),
    "prefix_paged": dict(prefix_cache=True, prefix_block_len=8, **PAGED),
    "lane_slot": LANE,
    "lane_paged_batch": dict(LANE, prefill_lane_batch=2, **PAGED),
    "spec_slot": dict(draft="adversarial", speculative_gamma=3),
    # the host learns each round's acceptance before the next dispatch:
    # no round runs after its stream's end (see the test below)
    "spec_paged_chunked": dict(PAGED, draft="adversarial",
                               speculative_gamma=3, fetch_stride=1,
                               overlap=False, **CHUNKED),
    "spec_self_ladder": dict(draft="self", speculative_gamma=4,
                             speculative_gamma_ladder=True),
}
# the kinds and waste reasons each case must book (not vacuous)
MUST = {
    "slot_token": ("chunk", "padding"),
    "slot_batched": ("prefill", "padding"),
    "slot_chunked": ("prefill_chunk", "padding"),
    "paged_token": ("paged_decode", "table_slack"),
    "paged_chunked": ("prefill_chunk", "table_slack"),
    "prefix_slot": ("gather", None),
    "prefix_paged": ("paged_decode", "table_slack"),
    "lane_slot": ("lane_chunk", None),
    "lane_paged_batch": ("lane_batch1", "padding"),
    "spec_slot": ("spec_g3", "spec_reject"),
    "spec_paged_chunked": ("draft_prefill", "padding"),
    "spec_self_ladder": ("spec_g4", "padding"),
}


def _flops(engine) -> dict:
    gp = engine.goodput.snapshot()
    gs = engine.gen_stats.snapshot()
    return {"dispatches": gp["dispatches"],
            "useful": gp["useful_flops"],
            "wasted": {k: {r: f for r, f in v.items() if f}
                       for k, v in gp["wasted_flops"].items()},
            "totals": (gp["useful_flops_total"], gp["wasted_flops_total"]),
            "gen_stats": (gs["useful_flops"], gs["wasted_flops"])}


def _serve_settled(engine, jobs) -> list:
    """Each job's stream, one after another, each submitted once the
    engine has retired every ring entry of the one before. A verify
    round's ledger records its slot's position bound at dispatch, and the
    bound depends on which earlier rounds have retired by then; a job
    submitted while the last one's rounds are still in flight makes that
    depend on the submitting thread's timing, in both engines alike."""
    streams = []
    for p, b in jobs:
        streams.append(list(engine.submit(np.asarray(p, np.int32), b)))
        deadline = time.monotonic() + 30
        while (engine._retired_seq != engine._ring_seq
               and time.monotonic() < deadline):
            time.sleep(0.002)
        time.sleep(0.02)
    return streams


def _both_engines(tiny, case: dict, jobs=JOBS) -> list:
    jcfg, jparams, jdraft, tcfg, tparams, tdraft = tiny
    kw = dict(n_slots=3, chunk=4, **case)
    draft = kw.pop("draft", None)
    out = []
    for side in ("ref", "port"):
        ekw = dict(kw)
        if draft is not None:
            ekw["speculative_draft"] = (
                (jspec.DraftModel(jcfg, jparams if draft == "self"
                                  else jdraft)) if side == "ref"
                else tspec.DraftModel(tcfg, tparams if draft == "self"
                                      else tdraft))
        eng = (JaxEngine(jcfg, dict(jparams), **ekw) if side == "ref"
               else ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                             **ekw))
        eng.start()
        try:
            out.append((_serve_settled(eng, jobs), _flops(eng), eng))
        finally:
            eng.stop()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatch_counts_and_flops_equal_the_reference(tiny, case):
    ref, port = _both_engines(tiny, CASES[case])
    assert port[0] == ref[0]
    assert [len(s) for s in port[0]] == [b for _, b in JOBS]
    assert port[1] == ref[1]
    flops = port[1]
    kind, reason = MUST[case]
    assert flops["dispatches"].get(kind, 0) > 0, flops["dispatches"]
    if reason is not None:
        assert any(reason in r for r in flops["wasted"].values()), \
            flops["wasted"]
    assert flops["totals"] == flops["gen_stats"]
    assert flops["totals"][0] > 0


def test_trailing_paged_rounds_match_the_reference(tiny):
    """Paged speculation with the default fetch cadence: the host keeps
    dispatching verify rounds until it learns a stream has ended, and
    such a trailing round can run past the stream's reservation, where
    its table resolves to the scratch block. Both packages' rounds
    compute all S rows and send the other slots' writes to scratch, so
    the trailing round reads the same scratch rows and accepts the same
    count: every per-kind dispatch count and every per-kind, per-reason
    FLOP count equals the reference's, the verify kinds' useful and
    spec_reject split included (ROADMAP C8)."""
    case = dict(PAGED, draft="adversarial", speculative_gamma=3, **CHUNKED)
    ref, port = _both_engines(tiny, case)
    assert port[0] == ref[0]
    assert port[1]["dispatches"] == ref[1]["dispatches"]
    assert any(k.startswith("spec_g") for k in port[1]["dispatches"])
    for kind in set(port[1]["dispatches"]) | set(ref[1]["dispatches"]):
        assert port[1]["useful"].get(kind) == ref[1]["useful"].get(kind), \
            kind
        assert port[1]["wasted"].get(kind) == ref[1]["wasted"].get(kind), \
            kind
    assert port[1] == ref[1]


def test_padding_waste_is_exact_rows(tiny):
    """Four slots with ONE live stream: every chunk dispatch carries
    exactly 3 free rows, so the padding is dispatches x 3 x span(0, C),
    and the live row's useful work the exact span of its fed columns."""
    _, _, _, tcfg, tparams, _ = tiny
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", n_slots=4,
                                   chunk=4).start()
    try:
        assert len(list(eng.submit(np.array([3, 17, 42], np.int32), 7))) \
            == 7
        snap = eng.goodput.snapshot()
    finally:
        eng.stop()
    fm = tgp.FlopModel(tcfg)
    n = snap["dispatches"]["chunk"]
    assert n > 0
    assert snap["wasted_flops"]["chunk"]["padding"] == n * 3 * fm.span(0, 4)
    assert "frozen" not in snap["wasted_flops"]["chunk"]
    assert snap["useful_flops"]["chunk"] == fm.span(0, 4 * n)
    assert 0.0 < snap["useful_flop_share"] < 1.0
    tail = eng.flight.tail(16)
    assert tail and all(isinstance(it["device_time_share"], float)
                        and isinstance(it["wasted_flop_share"], float)
                        for it in tail)
    sig = eng._watchdog_signals()
    assert isinstance(sig["device_time_share"], float)
    assert isinstance(sig["wasted_flop_share"], float)


def test_batched_prefill_padding_is_bucket_slack(tiny):
    _, _, _, tcfg, tparams, _ = tiny
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", n_slots=2,
                                   chunk=4, prefill_mode="batched").start()
    prompt = [3, 17, 42, 9, 26, 51]
    try:
        assert len(list(eng.submit(np.array(prompt, np.int32), 5))) == 5
        snap = eng.goodput.snapshot()
        bucket = next(b for b in eng._dev["prefill_buckets"]
                      if b >= len(prompt))
    finally:
        eng.stop()
    fm = tgp.FlopModel(tcfg)
    assert snap["dispatches"]["prefill"] == 1
    assert snap["useful_flops"]["prefill"] == \
        fm.span(0, len(prompt), logits=False) + fm.logits
    assert snap["wasted_flops"]["prefill"]["padding"] == \
        fm.span(len(prompt), bucket - len(prompt), logits=False)


def test_sampling_mode_is_token_identical(tiny):
    """The synchronous sample changes when the host waits, never what the
    engine computes: concurrent greedy streams with every 2nd dispatch
    sampled equal those of an engine that samples nothing."""
    _, _, _, tcfg, tparams, _ = tiny
    jobs = [([3, 17, 42], 7), ([5, 11], 5), (LONG, 9)]
    out = []
    for every in (0, 1, 2):
        eng = ContinuousBatchingEngine(
            tcfg, tparams, device="cpu", n_slots=2, chunk=4,
            device_time_sample_every=every).start()
        results = [None] * len(jobs)
        try:
            threads = [threading.Thread(
                target=lambda i, p, b: results.__setitem__(
                    i, list(eng.submit(np.asarray(p, np.int32), b))),
                args=(i, p, b)) for i, (p, b) in enumerate(jobs)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            snap = eng.goodput.snapshot()
        finally:
            eng.stop()
        out.append(results)
        assert snap["sample_every"] == every
        if every:
            assert snap["sampled_total"] > 0
            assert snap["sampling_share"] <= 1.0 / every + 1e-9
        else:
            assert snap["sampled_total"] == 0
    assert out[0] == out[1] == out[2]


def test_perfect_draft_books_zero_spec_reject(tiny):
    ref, port = _both_engines(tiny, dict(draft="self",
                                         speculative_gamma=2),
                              jobs=[([3, 17, 42], 8)])
    assert port[1] == ref[1]
    spec = [k for k in port[1]["dispatches"] if k.startswith("spec_g")]
    assert spec
    assert sum(port[1]["useful"].get(k, 0) for k in spec) > 0
    for k in spec:
        assert "spec_reject" not in port[1]["wasted"].get(k, {})


def test_snapshot_blocks_carry_the_tracker(tiny):
    """The goodput block of the engine's snapshots is the tracker's, where
    the reference puts it; a death logs the goodput tail."""
    _, _, _, tcfg, tparams, _ = tiny
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", n_slots=2,
                                   chunk=4).start()
    try:
        list(eng.submit(np.array([3, 17, 42], np.int32), 4))
        blocks = [eng.generation_snapshot()["goodput"],
                  eng.runtime_snapshot()["goodput"],
                  eng.stats()["goodput"],
                  eng._incident_evidence("x", {})["goodput"]]
    finally:
        eng.stop()
    for b in blocks:
        assert b["dispatches"] == blocks[0]["dispatches"]
        assert set(b) == set(jgp.GoodputTracker().snapshot())


# ------------------------------------------------------------------ metrics

def _served(side: str, tiny, **kw):
    from client_tpu.models import decoder_lm as jlm
    from client_tpu.server import TpuInferenceServer
    from client_tpu.server import types as jtypes
    from client_tpu_torch.models import decoder_lm as tlm
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server import types as ttypes

    jcfg, jparams, _, tcfg, tparams, _ = tiny
    if side == "ref":
        core, types = TpuInferenceServer(), jtypes
        model = jlm.make_continuous_generator(
            "goodput_lm", cfg=jcfg, params=dict(jparams), n_slots=2,
            chunk_size=4, max_new_tokens=6, **kw)
    else:
        core, types = TorchInferenceServer(), ttypes
        model = tlm.make_continuous_generator(
            "goodput_lm", cfg=tcfg, params=tparams, n_slots=2,
            chunk_size=4, max_new_tokens=6, device="cpu", **kw)
    core.register_model(model)
    try:
        for prompt in ([1, 2, 3], LONG):
            done = threading.Event()
            core.infer(types.InferRequest(model_name="goodput_lm", inputs=[
                types.InferTensor("PROMPT", "INT32", (len(prompt),),
                                  data=np.asarray(prompt, np.int32))]),
                response_callback=lambda r, final: final and done.set())
            assert done.wait(60)
        return core.metrics_text()
    finally:
        core.stop()


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_goodput_families_lint_and_cpu_mfu_absence(tiny, layout):
    from client_tpu_torch.server.metrics import (
        parse_prometheus_text,
        sample_value,
    )

    kw = PAGED if layout == "paged" else {}
    texts = {side: _served(side, tiny, **kw) for side in ("ref", "port")}
    text = texts["port"]
    assert check_metrics_names.check(text) == []
    parsed = {s: parse_prometheus_text(t) for s, t in texts.items()}
    fams = {s: {f for f in p["families"] if f.startswith(
        "client_tpu_goodput_")} for s, p in parsed.items()}
    assert fams["port"] == fams["ref"] and len(fams["port"]) == 9
    # the FLOP and dispatch counters render equal
    rows = {s: sorted((n, sorted(lab.items()), v)
                      for n, lab, v in p["samples"]
                      if n.startswith(("client_tpu_goodput_dispatches",
                                       "client_tpu_goodput_useful_flops_",
                                       "client_tpu_goodput_wasted_flops")))
            for s, p in parsed.items()}
    assert rows["port"] == rows["ref"] and rows["port"]
    labels = {"model": "goodput_lm", "version": "1"}
    kernel = "paged_decode" if layout == "paged" else "chunk"
    assert sample_value(parsed["port"], "client_tpu_goodput_dispatches_"
                        "total", dict(labels, kernel=kernel)) > 0
    assert 0.0 < sample_value(parsed["port"], "client_tpu_goodput_useful_"
                              "flop_share", labels) < 1.0
    assert sample_value(parsed["port"], "client_tpu_goodput_sampled_"
                        "dispatches_total", labels) == 0
    assert "client_tpu_goodput_mfu" not in text
    assert "client_tpu_goodput_device_peak_flops" not in text


def test_a_known_peak_registers_the_mfu_pair_whole():
    """An engine whose card has a known peak (faked here: the CPU has
    none) gets both members of the MFU pair, the reference's values from
    the same snapshot, and the lint stays clean; the pair split in two is
    a lint error."""
    from client_tpu.server import metrics as jm
    from client_tpu_torch.server import metrics as tm

    clk = {"t": 0}
    snaps = []
    for mod in (jgp, tgp):
        tr = mod.GoodputTracker(clock=lambda: clk["t"], peak_flops=989e12,
                                sample_every=2)
        for i in range(4):
            tr.note_dispatch("paged_decode", useful_flops=10**12 + i,
                             wasted={"padding": 3, "table_slack": 5})
            clk["t"] += 50_000_000
            tr.drain_mark()
        snaps.append(tr.snapshot())
    parsed = {}
    for name, mod, snap in (("ref", jm, snaps[0]), ("port", tm, snaps[1])):
        reg = mod.MetricsRegistry()
        mod._collect_goodput(reg, [("m", "1", snap)])
        text = reg.render()
        if name == "port":
            assert check_metrics_names.check(text) == []
            split = "\n".join(line for line in text.splitlines()
                              if "device_peak_flops" not in line) + "\n"
            assert any("MFU pair is split" in e
                       for e in check_metrics_names.check(split))
        parsed[name] = tm.parse_prometheus_text(text)
    rows = {s: sorted((n, sorted(lab.items()), v)
                      for n, lab, v in parsed[s]["samples"])
            for s in parsed}
    assert rows["port"] == rows["ref"]
    mfu = tm.sample_value(parsed["port"], "client_tpu_goodput_mfu",
                          {"model": "m"})
    assert mfu == pytest.approx(snaps[1]["mfu"])
    assert tm.sample_value(parsed["port"], "client_tpu_goodput_device_peak_"
                           "flops", {"model": "m"}) == 989e12


# ----------------------------------------------------------------- profiler

def _profilers(**kw):
    out = []
    for mod in (jprof, tprof):
        parser = mod.ModelParser.__new__(mod.ModelParser)
        parser.model_name = "m"
        out.append(mod.InferenceProfiler(None, parser, None, **kw))
    return out


def _statuses(**metrics_kw):
    out = []
    for mod in (jprof, tprof):
        status = mod.PerfStatus()
        status.metrics = mod.ServerMetricsStats(scraped=True, **metrics_kw)
        out.append(status)
    return out


WASTEFUL = dict(generation_scraped=True, generation_slot_occupancy=0.9,
                goodput_scraped=True, goodput_useful_flops=2e9,
                goodput_wasted_flops=8e9)
GATES = {
    "fires": (dict(min_goodput=0.5), WASTEFUL, "goodput floor"),
    "idle_exempt": (dict(min_goodput=0.5),
                    dict(WASTEFUL, generation_slot_occupancy=0.2), None),
    "off_by_default": ({}, WASTEFUL, None),
    "floor_below_share": (dict(min_goodput=0.1), WASTEFUL, None),
    "retire": ({}, dict(generation_scraped=True, generation_slot_occupancy=1,
                        engine_phase_s={"retire_fetch": 3.0, "dispatch": 1},
                        generation_chunks=10, ring_fetches=10,
                        ring_fetch_stride=4), "retire-phase share"),
    "prefill": (dict(prefill_share_ceiling=0.3),
                dict(generation_scraped=True, generation_queue_depth=2,
                     engine_phase_s={"prefill": 3.0, "dispatch": 1.0}),
                "prefill-lane share"),
    "incident_off": ({}, dict(watchdog_scraped=True,
                              watchdog_incidents={"engine_stall": 1}),
                     None),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_window_gates_say_what_the_reference_says(gate):
    kw, metrics, want = GATES[gate]
    got = [prof._window_violation(st)
           for prof, st in zip(_profilers(**kw), _statuses(**metrics))]
    assert got[1] == got[0]
    if want is None:
        assert got[1] is None
    else:
        assert want in got[1]


def test_the_incident_gate_names_the_newest_bundle():
    class Backend:
        def server_incidents(self):
            return {"models": [{"model": "m", "incidents": {"incidents": [
                {"id": "inc-1", "detector": "engine_stall", "ns": 5},
                {"id": "inc-2", "detector": "pool_leak", "ns": 9}]}},
                {"model": "other", "incidents": {"incidents": [
                    {"id": "inc-9", "detector": "x", "ns": 99}]}}]}

    got = []
    for prof, st in zip(_profilers(fail_on_incident=True),
                        _statuses(watchdog_scraped=True,
                                  watchdog_incidents={"engine_stall": 1,
                                                      "pool_leak": 2})):
        prof.backend = Backend()
        got.append(prof._window_violation(st))
    assert got[1] == got[0]
    assert "3 watchdog incident(s)" in got[1] and "inc-2" in got[1]


def test_window_share_property_from_deltas():
    sm = tprof.ServerMetricsStats(goodput_useful_flops=3.0,
                                  goodput_wasted_flops=1.0)
    assert sm.goodput_useful_flop_share == 0.75
    assert tprof.ServerMetricsStats().goodput_useful_flop_share == 1.0
    assert [f.name for f in dataclasses.fields(tprof.ServerMetricsStats)] \
        == [f.name for f in dataclasses.fields(jprof.ServerMetricsStats)]
