"""The port's SLO scheduler (client_tpu_torch.server.scheduling and its
engine integration) on the CPU, held against the JAX package's.

- ``FairQueue``: the reference's queue cases run on both queues and give
  the same pop orders, sizes, parked counts and heads; ``shed_lowest``
  picks the same victim.
- ``resolve_scheduler`` refuses the same configurations with the same
  messages.
- ``EngineController``: a scripted burn series gives the same knob trace
  on a recording engine.
- Engines: the JAX engine and the port's run the same preemption scenario
  on the same f32 weights (the reference's tiny config): a best-effort
  stream holds the only slot, a gold request arrives, the best-effort one
  is preempted, committed and re-queued, and resumes after the gold one.
  On the slot layout, on the paged layout with the chunked lane, with a
  self-draft speculating, and through a dedicated prefill lane on both
  layouts (the victim and its resume come through the lane), both
  engines give identical tokens (equal to an uninterrupted run),
  preemption and resume counts, the order in which the engine closed
  the two streams (its ``_close_request``, not the consumers'), statuses,
  and end
  leak-free (no slot held, no pin, the paged pool
  whole). A cancel and a deadline that land on the preempted request
  while it is queued settle it as the reference does (499, 504).
  Deterministic: each engine is held at a dispatch boundary (its deadline
  and cancel sweep) while the next arrival is queued or an Event is set.
- The shed door: a full scheduled queue sheds the same queued victim.
- A live engine's controller enters latency mode on a burning class (the
  knobs read stride 1, duty 1.0, one-chunk lane budget, speculation off)
  and leaves it, with its tokens unchanged; duty < 1 adds "pace".

Tolerance: tokens, counts and statuses exact; no float is compared.
"""

import queue as queue_mod
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import transformer as jt
from client_tpu.server import generation as jgen
from client_tpu.server import scheduling as jsched
from client_tpu.server.speculation import DraftModel as JaxDraft
from client_tpu.server.types import ServerError as JaxServerError
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import generation as tgen
from client_tpu_torch.server import scheduling as tsched
from client_tpu_torch.server.speculation import DraftModel as TorchDraft
from client_tpu_torch.server.types import ServerError

# the reference's tiny config (tests/test_disagg_lanes.py)
KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=64, causal=True)
WAIT_S = 120.0
BE_PROMPT = np.arange(1, 9, dtype=np.int32)
GOLD_PROMPT = np.asarray([40, 41, 42, 43], np.int32)
BE_BUDGET, GOLD_BUDGET = 40, 8
SCHED = {"class_weights": {"interactive": 8.0, "best_effort": 1.0},
         "preemption": True, "preempt_burn_threshold": 0.0,
         "max_preemptions": 3}
# one slot, one fetch per dispatch
BASE = dict(n_slots=1, chunk=4, fetch_stride=1)
COMBOS = {
    "slot_token": dict(prefix_cache=True, prefix_block_len=4),
    "paged_chunked": dict(kv_layout="paged", kv_block_len=4,
                          prefix_cache=True, prefix_block_len=4,
                          prefill_mode="chunked", prefill_chunk=8),
    "slot_speculating": dict(prefix_cache=True, prefix_block_len=4,
                             speculative_gamma=3),
    # the victim came through a dedicated prefill lane (its 8-token prompt
    # is longer than the chunk), and so does its resume
    "paged_lane": dict(kv_layout="paged", kv_block_len=4, prefix_cache=True,
                       prefix_block_len=4, prefill_mode="chunked",
                       prefill_chunk=8, prefill_slots=1),
    "slot_lane": dict(prefix_cache=True, prefix_block_len=4,
                      prefill_mode="chunked", prefill_chunk=8,
                      prefill_slots=1),
}


def _wait(cond, timeout: float = WAIT_S) -> bool:
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            return False
        time.sleep(0.002)
    return True


# ------------------------------------------------------------- FairQueue

def _weights(k):
    return {"gold": 4.0, "interactive": 8.0, "batch": 1.0}.get(k[1], 1.0)


def _q_default_fifo(mod):
    q = mod.FairQueue(maxsize=0, fair=False)
    order = [("a", "x"), ("b", "y"), ("a", "x"), ("c", "z")]
    for i, key in enumerate(order):
        q.put(i, key)
    return [q.get_nowait() for _ in order]


def _q_weighted(mod):
    q = mod.FairQueue(fair=True, weight_fn=_weights)
    for i in range(3):
        q.put(f"b{i}", ("t", "batch"))
    for i in range(3):
        q.put(f"g{i}", ("t", "gold"))
    return [q.get_nowait() for _ in range(6)]


def _q_intra_flow(mod):
    q = mod.FairQueue(fair=True)
    for i in range(4):
        q.put(("a", i), ("a", "c"))
        q.put(("b", i), ("b", "c"))
    return [q.get_nowait() for _ in range(8)]


def _q_maxsize(mod):
    q = mod.FairQueue(maxsize=2, fair=True)
    q.put("a", ("t", "c"))
    q.put("b", ("t", "c"))
    try:
        q.put_nowait("c", ("t", "c"))
        full = False
    except queue_mod.Full:
        full = True
    return [full, q.qsize(), q.get_nowait(), q.qsize()]


def _q_push_front(mod):
    q = mod.FairQueue(fair=True)
    q.put("big", ("flood", "batch"))
    q.put("late", ("flood", "batch"))
    big = q.get_nowait()
    q.push_front(big, ("flood", "batch"), parked=True)
    trace = [q.parked, q.get_nowait()]
    q.unpark()
    return trace + [q.parked, q.get_nowait()]


def _q_requeue(mod):
    q = mod.FairQueue(fair=True, weight_fn=_weights)
    q.put("victim", ("flood", "batch"))
    victim = q.get_nowait()
    q.put("sibling", ("flood", "batch"))
    q.put("gold", ("gold", "interactive"))
    q.requeue(victim, ("flood", "batch"))
    return [q.get_nowait() for _ in range(3)]


def _q_requeued_exempt(mod):
    q = mod.FairQueue(maxsize=1, fair=True)
    q.put("a", ("t", "c"))
    q.push_front("parked", ("t", "c"), parked=True)
    q.requeue("preempted", ("t", "c"))
    return [q.qsize(), q.parked, [q.get_nowait() for _ in range(3)]]


def _q_close(mod):
    q = mod.FairQueue(fair=True)
    q.put("a", ("t", "c"))
    q.close()
    trace = [q.get(), q.get_nowait()]
    try:
        q.get_nowait()
    except queue_mod.Empty:
        trace.append("empty")
    return trace


def _q_peek(mod):
    q = mod.FairQueue(fair=True, weight_fn=_weights)
    trace = [q.peek_key()]
    q.put("b", ("flood", "batch"))
    q.put("g", ("gold", "interactive"))
    return trace + [q.peek_key(), q.depths()]


def _q_shed_lowest(mod):
    q = mod.FairQueue(maxsize=8, fair=True, weight_fn=_weights)
    q.put("b1", ("t", "batch"))
    q.put("b2", ("t", "batch"))
    q.put("g1", ("t", "gold"))
    trace = [q.shed_lowest(("t", "gold")), q.qsize(),
             q.shed_lowest(("t", "batch"))]
    q2 = mod.FairQueue(maxsize=8, fair=True, weight_fn=_weights)
    q2.push_front("parked", ("t", "batch"), parked=True)
    q3 = mod.FairQueue(maxsize=8, fair=False)
    q3.put("x", ("t", "batch"))
    return trace + [q2.shed_lowest(("t", "gold")),
                    q3.shed_lowest(("t", "gold"))]


QUEUE_CASES = {f.__name__[3:]: f for f in (
    _q_default_fifo, _q_weighted, _q_intra_flow, _q_maxsize, _q_push_front,
    _q_requeue, _q_requeued_exempt, _q_close, _q_peek, _q_shed_lowest)}


@pytest.mark.parametrize("case", sorted(QUEUE_CASES))
def test_fair_queue_matches_the_reference(case):
    got, want = QUEUE_CASES[case](tsched), QUEUE_CASES[case](jsched)
    assert got == want


# ------------------------------------------------------- resolve_scheduler

BAD = {
    "zero_weight": ({"class_weights": {"gold": 0.0}}, True, "all"),
    "negative_weight": ({"class_weights": {"gold": -1}}, True, "all"),
    "zero_default": ({"default_weight": 0.0}, True, "all"),
    "no_preemptions": ({"preemption": True, "max_preemptions": 0}, True,
                       "all"),
    "negative_threshold": ({"preemption": True,
                            "preempt_burn_threshold": -1.0}, True, "all"),
    "flat_band": ({"controller": True, "burn_high": 0.5, "burn_low": 0.5},
                  True, "all"),
    "negative_low": ({"controller": True, "burn_low": -0.1}, True, "all"),
    "no_hold": ({"controller": True, "controller_hold_rounds": 0}, True,
                "all"),
    "negative_floor": ({"controller": True,
                        "min_prefill_token_budget": -1}, True, "all"),
    "no_bypass": ({"park_bypass_limit": 0}, True, "all"),
    "unknown_key": ({"weights": {}}, False, "all"),
    "preempt_without_cache": ({"preemption": True}, False, "all"),
    "preempt_read_only": ({"preemption": True}, True, "none"),
    "not_a_config": (3, False, "all"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_resolve_scheduler_refuses_like_the_reference(case):
    sched, cache, policy = BAD[case]
    with pytest.raises(ValueError) as want:
        jsched.resolve_scheduler(sched, cache, policy)
    with pytest.raises(ValueError) as got:
        tsched.resolve_scheduler(sched, cache, policy)
    assert str(got.value) == str(want.value)


def test_resolve_scheduler_accepts_like_the_reference():
    for sched, cache in ((None, False), (False, False), (True, False),
                         ({"preemption": True}, True),
                         ({"enabled": False}, False),
                         ({"controller": True, "class_weights": {"g": 2}},
                          False)):
        want = jsched.resolve_scheduler(sched, cache, "all")
        got = tsched.resolve_scheduler(sched, cache, "all")
        assert (got is None) == (want is None)
        if got is not None:
            assert got.to_json() == want.to_json()


# ------------------------------------------------------- EngineController

class _Recorder:
    """The controller's actuation surface, recording every setter."""

    def __init__(self, speculating: bool):
        self.prefill_token_budget = 64
        self.fetch_stride = 4
        self.dispatch_duty = 0.8
        self.speculation_gamma = 4 if speculating else 0
        self.speculation_enabled = True
        self.calls = []
        if speculating:
            self.set_speculation_gamma = self._set_gamma

    def set_prefill_token_budget(self, b):
        self.calls.append(("budget", b))
        self.prefill_token_budget = max(1, b) if b else 8

    def set_fetch_stride(self, s):
        self.calls.append(("stride", s))
        self.fetch_stride = s

    def set_dispatch_duty(self, d):
        self.calls.append(("duty", d))
        self.dispatch_duty = d

    def set_speculation_enabled(self, on):
        self.calls.append(("spec", on))
        self.speculation_enabled = on

    def _set_gamma(self, g):
        self.calls.append(("gamma", g))
        self.speculation_gamma = g
        self.speculation_enabled = g > 0


BURNS = [0.5, 1.5, 0.5, 0.1, 0.1, 0.6, 0.1, 0.1, 0.1, 3.0, 2.0, 0.0, 0.0,
         0.0, 0.2, 1.0, 0.24, 0.24, 0.24]


@pytest.mark.parametrize("speculating", [False, True])
@pytest.mark.parametrize("floor", [0, 16])
def test_controller_knob_trace_matches_the_reference(speculating, floor):
    traces = []
    for mod in (jsched, tsched):
        ctl = mod.EngineController(1.0, 0.25, hold_rounds=3,
                                   min_prefill_budget=floor)
        eng = _Recorder(speculating)
        trace = []
        for burn in BURNS:
            ctl.step(eng, burn)
            trace.append((ctl.latency_mode, eng.prefill_token_budget,
                          eng.fetch_stride, eng.dispatch_duty,
                          eng.speculation_enabled, eng.speculation_gamma))
        traces.append((trace, eng.calls, ctl.snapshot()))
    assert traces[0] == traces[1]
    assert traces[1][2]["flips"] == 6


# ------------------------------------------------------------ the engines

@pytest.fixture(scope="module")
def weights():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    return jcfg, jparams, tcfg, tparams


class Clock:
    """``now_ns`` for both engines: monotonic time, ``engine_s`` ahead on
    the engine thread only."""

    def __init__(self):
        self.engine_s = 0.0

    def __call__(self) -> int:
        on_engine = threading.current_thread().name == "cbatch-engine"
        return time.monotonic_ns() + int(
            (self.engine_s if on_engine else 0.0) * 1e9)


class Gate:
    """Holds an engine at its dispatch-boundary sweep once the armed
    predicate holds, until released or re-armed (``held`` and ``go`` are
    the current arm's events)."""

    def __init__(self, engine):
        self._arm = None          # (pred, held, go), read once per sweep
        self.held = threading.Event()
        sweep = engine._reap_slots

        def reap():
            arm = self._arm
            if arm is not None and not arm[2].is_set() and arm[0]():
                arm[1].set()
                arm[2].wait(WAIT_S)
            sweep()

        engine._reap_slots = reap

    def hold(self, pred) -> None:
        """Arm a new hold on ``pred``, releasing a held engine."""
        old = self._arm
        self.held = threading.Event()
        self._arm = (pred, self.held, threading.Event())
        if old is not None:
            old[2].set()

    def release(self) -> None:
        old, self._arm = self._arm, None
        if old is not None:
            old[2].set()


class CloseOrder:
    """Records the tenant of every stream an engine closes, in the order
    the engine closes them (its ``_close_request``, the one place both
    engines deliver a stream's terminal item), whatever order the
    consumers then read them in."""

    def __init__(self, engine):
        self.tenants = []
        close = engine._close_request

        def record(req, terminal, outcome=None):
            first = not req.finished
            close(req, terminal, outcome)
            if first:
                self.tenants.append(req.tenant)

        engine._close_request = record


def _build(side: str, weights, combo: str, **extra):
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(BASE, **COMBOS[combo], **extra, scheduler=dict(SCHED),
              slo_classes=[{"name": "interactive", "ttft_ms": 1000.0}])
    spec = "speculative_gamma" in kw
    if side == "ref":
        if spec:
            kw["speculative_draft"] = JaxDraft(jcfg, dict(jparams))
        return jgen.ContinuousBatchingEngine(jcfg, dict(jparams), **kw)
    if spec:
        kw["speculative_draft"] = TorchDraft(tcfg, tparams)
    return tgen.ContinuousBatchingEngine(tcfg, tparams, device="cpu", **kw)


@pytest.fixture(scope="module")
def engines(weights):
    """Per combo and side, a started engine with its gate, the
    uninterrupted streams of the scenario's two requests and its close
    order, and the shared clock patched into both generation modules."""
    clock = Clock()
    built = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgen, "now_ns", clock)
        mp.setattr(tgen, "now_ns", clock)
        try:
            for combo in COMBOS:
                for side in ("ref", "port"):
                    eng = _build(side, weights, combo).start()
                    gate = Gate(eng)
                    closes = CloseOrder(eng)
                    plain = {
                        "be": list(eng.submit(BE_PROMPT, BE_BUDGET)),
                        "gold": list(eng.submit(GOLD_PROMPT, GOLD_BUDGET))}
                    built[(combo, side)] = (eng, gate, plain, closes)
            yield built, clock
        finally:
            for eng, *_ in built.values():
                eng.stop()


def _be_holds_slot(eng, n: int = 4):
    return lambda: any(s.req is not None and s.req.tenant == "flood"
                       and s.req.emitted >= n for s in eng._slots)


def _gold_holds_slot(eng):
    return lambda: any(s.req is not None and s.req.tenant == "gold"
                       for s in eng._slots)


def _consume(it, name, out):
    try:
        out[name] = list(it)
    except (ServerError, JaxServerError) as e:
        out[name] = ("error", e.status, str(e))


def _pins(eng) -> int:
    stack, pinned = list(eng._prefix_index._root.children.values()), 0
    while stack:
        node = stack.pop()
        pinned += node.refs > 0
        stack.extend(node.children.values())
    return pinned


def _settled(eng) -> dict:
    def idle():
        with eng._lock:
            closed = eng._requests_accepted == eng._requests_closed
        return closed and not any(s.req is not None for s in eng._slots)

    assert _wait(idle)
    occ = eng._kv_index.occupancy() if eng._paged else None
    return {"pins": _pins(eng),
            "stream_blocks": None if occ is None else occ["stream"],
            "reserved": None if occ is None else occ["reserved"]}


_STREAM_OF = {"flood": "be", "gold": "gold"}


def _scenario(eng, gate, clock, ending: str, closes: CloseOrder) -> dict:
    """The best-effort stream decodes in the only slot; the engine is held
    while a gold request queues; at the next boundary the gold head
    preempts it. ``ending`` "cancel" / "deadline" then holds the engine
    while the gold stream runs and sets the queued victim's cancel Event
    or moves the engine's clock past its deadline. ``order`` is the order
    in which the engine closed the two streams (not the order their
    consumer threads finished reading them)."""
    out = {}
    mark = len(closes.tenants)
    cancel = threading.Event() if ending == "cancel" else None
    deadline = (time.monotonic_ns() + int(300e9)
                if ending == "deadline" else 0)
    before = eng.scheduler_snapshot()
    gate.hold(_be_holds_slot(eng))
    be = threading.Thread(target=_consume, args=(
        eng.submit(BE_PROMPT, BE_BUDGET, tenant_id="flood",
                   slo_class="best_effort", cancel_event=cancel,
                   deadline_ns=deadline), "be", out))
    be.start()
    assert gate.held.wait(WAIT_S)
    gold_it = eng.submit(GOLD_PROMPT, GOLD_BUDGET, tenant_id="gold",
                         slo_class="interactive")
    assert eng._pending.qsize() == 1
    if ending:
        gate.hold(_gold_holds_slot(eng))
    else:
        gate.release()
    gold = threading.Thread(target=_consume,
                            args=(gold_it, "gold", out))
    gold.start()
    if ending:
        assert gate.held.wait(WAIT_S)
        # the victim waits in the queue behind the gold stream
        assert eng._pending.qsize() == 1
        if ending == "cancel":
            cancel.set()
        else:
            clock.engine_s = 600.0
        gate.release()
    for th in (be, gold):
        th.join(WAIT_S)
        assert not th.is_alive()
    clock.engine_s = 0.0
    after = eng.scheduler_snapshot()
    order = [_STREAM_OF[t] for t in closes.tenants[mark:]]
    return {"out": out, "order": order,
            "preemptions": after["preemptions_total"]
            - before["preemptions_total"],
            "resumes": after["resumes_total"] - before["resumes_total"],
            "by_label": after["preemptions"],
            "settled": _settled(eng)}


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_preemption_matches_the_jax_engine(engines, combo):
    built, clock = engines
    runs = {side: _scenario(*built[(combo, side)][:2], clock, "",
                            built[(combo, side)][3])
            for side in ("ref", "port")}
    port, ref = runs["port"], runs["ref"]
    plain = built[(combo, "port")][2]
    assert plain == built[(combo, "ref")][2]
    assert port == ref
    # token for token the uninterrupted streams; one preemption, resumed
    assert port["out"] == {"be": plain["be"], "gold": plain["gold"]}
    assert port["order"] == ["gold", "be"]
    assert port["preemptions"] == port["resumes"] == 1
    assert port["settled"]["pins"] == 0
    if combo.endswith("lane"):
        # the plain run's, the victim's and its resume's prompts
        eng = built[(combo, "port")][0]
        assert eng.gen_stats.snapshot()["lane_handoffs"] >= 3
    if combo.startswith("paged"):
        assert port["settled"]["stream_blocks"] == 0
        assert port["settled"]["reserved"] == 0


@pytest.mark.parametrize("ending,status", [("cancel", 499),
                                           ("deadline", 504)])
def test_cancel_and_deadline_on_a_preempted_queued_request(engines, ending,
                                                           status):
    built, clock = engines
    runs = {side: _scenario(*built[("slot_token", side)][:2], clock, ending,
                            built[("slot_token", side)][3])
            for side in ("ref", "port")}
    # the victim closes at its admission while the gold stream's last
    # tokens may still be in flight: the two consumers' finishing order
    # is the threads', not the engines'
    for run in runs.values():
        run.pop("order")
    port, ref = runs["port"], runs["ref"]
    assert port == ref
    assert port["out"]["be"][:2] == ("error", status)
    assert port["out"]["gold"] == built[("slot_token", "port")][2]["gold"]
    assert port["preemptions"] == 1 and port["resumes"] == 0
    assert port["settled"]["pins"] == 0


def test_preemption_records_slo_and_gen_stats_like_the_reference(engines):
    """After the scenarios, both engines' counters agree: preemptions and
    resumes, prefix hits and saved tokens, and the per-label outcome
    counts of the SLO statistics."""
    built, _ = engines
    for combo in COMBOS:
        stats = {}
        for side in ("ref", "port"):
            eng = built[(combo, side)][0]
            gs = eng.gen_stats.snapshot()
            rows = [{k: r[k] for k in ("tenant", "slo_class", "admitted",
                                       "completed", "failed", "shed",
                                       "cancelled", "deadline")}
                    for r in eng.slo_snapshot()["tenant_classes"]]
            stats[side] = ({k: gs[k] for k in (
                "preemptions", "resumes", "prefix_hits", "prefix_misses",
                "prefix_saved_tokens", "completed", "cancelled",
                "deadline_expired")}, rows)
        assert stats["port"] == stats["ref"], combo


def _render_engine(mod, eng) -> dict:
    """One engine's generation, SLO and scheduler families rendered by a
    package's collectors (as /metrics renders a served model's) and
    parsed back."""
    snap = eng.generation_snapshot()
    reg = mod.MetricsRegistry()
    mod._collect_generation(reg, [("lm", "1", snap)])
    mod._collect_slo(reg, [("lm", "1", snap["slo"])])
    mod._collect_sched(reg, [("lm", "1", snap)])
    return mod.parse_prometheus_text(reg.render())


def test_preemption_counters_render_like_the_reference(engines):
    """After the scenarios, both packages' renders of the engines agree on
    the preemption, resume, token and completion counters, per label."""
    from client_tpu.server import metrics as jm
    from client_tpu_torch.server import metrics as tm

    names = ("client_tpu_sched_preemptions_total",
             "client_tpu_sched_resumes_total",
             "client_tpu_generation_tokens_total",
             "client_tpu_generation_requests_total",
             "client_tpu_generation_prefix_cache_hits_total",
             "client_tpu_slo_requests_total")
    built, _ = engines
    for combo in COMBOS:
        got = {}
        for side, mod in (("ref", jm), ("port", tm)):
            parsed = _render_engine(mod, built[(combo, side)][0])
            got[side] = sorted((n, sorted(lab.items()), v)
                               for n, lab, v in parsed["samples"]
                               if n in names)
        assert got["port"] == got["ref"], combo
        preempted = [v for n, _lab, v in got["port"]
                     if n == "client_tpu_sched_preemptions_total"]
        assert sum(preempted) >= 1, combo


# ------------------------------------------------------------- shed door

def test_shed_door_sheds_the_same_victim(weights):
    """A full scheduled queue: a gold arrival sheds the newest batch entry
    (a 503) and takes its place; a batch arrival at a queue holding only
    gold is shed itself. Same statuses, tokens and shed counts."""
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(n_slots=1, chunk=4, queue_depth=2, shed_on_full=True,
              scheduler={"class_weights": {"gold": 10.0, "batch": 1.0}})
    prompts = [np.asarray([5 + i, 9, 14, 2], np.int32) for i in range(5)]
    results = {}
    for side in ("ref", "port"):
        eng = (jgen.ContinuousBatchingEngine(jcfg, dict(jparams), **kw)
               if side == "ref" else
               tgen.ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                             **kw)).start()
        gate = Gate(eng)
        out, threads = {}, []
        try:
            gate.hold(lambda e=eng: any(s.req is not None
                                        for s in e._slots))
            threads.append(threading.Thread(target=_consume, args=(
                eng.submit(prompts[0], 8, tenant_id="flood",
                           slo_class="batch"), "hold", out)))
            threads[-1].start()
            assert gate.held.wait(WAIT_S)
            for name, p in (("q1", prompts[1]), ("q2", prompts[2])):
                threads.append(threading.Thread(target=_consume, args=(
                    eng.submit(p, 2, tenant_id="flood", slo_class="batch"),
                    name, out)))
                threads[-1].start()
            threads.append(threading.Thread(target=_consume, args=(
                eng.submit(prompts[3], 2, tenant_id="vip",
                           slo_class="gold"), "gold", out)))
            threads[-1].start()
            try:
                eng.submit(prompts[4], 2, tenant_id="flood",
                           slo_class="batch")
                shed_arrival = None
            except (ServerError, JaxServerError) as e:
                shed_arrival = (e.status, str(e))
            gate.release()
            for th in threads:
                th.join(WAIT_S)
                assert not th.is_alive()
            sheds = {f"{r['tenant']}/{r['slo_class']}": r["shed"]
                     for r in eng.slo_snapshot()["tenant_classes"]}
            results[side] = (out, shed_arrival, sheds,
                             eng.gen_stats.snapshot()["failed"])
        finally:
            eng.stop()
    assert results["port"] == results["ref"]
    out, shed_arrival, sheds, _ = results["port"]
    assert out["q2"][:2] == ("error", 503)
    assert isinstance(out["q1"], list) and isinstance(out["gold"], list)
    assert shed_arrival[0] == 503
    assert sheds == {"flood/batch": 2, "vip/gold": 0}


# ------------------------------------------------- the live controller

def test_live_controller_flips_knobs_with_tokens_unchanged(weights):
    """Every completion misses a sub-microsecond TTFT objective, so the
    burn spikes: the controller enters latency mode (stride 1, duty 1.0,
    a one-chunk lane budget, speculation off), and once the violations
    age out of the window it restores the knobs. The tokens equal a
    controller-less engine's throughout."""
    _, _, tcfg, tparams = weights
    common = dict(n_slots=2, chunk=4, fetch_stride=4,
                  prefill_mode="chunked", prefill_chunk=8,
                  prefill_token_budget=64, prefix_cache=True,
                  prefix_block_len=4, device="cpu", dispatch_duty=0.8)
    eng = tgen.ContinuousBatchingEngine(
        tcfg, tparams, **common,
        slo_classes=[{"name": "interactive", "ttft_ms": 1e-6,
                      "target_percentile": 95.0}],
        slo_window_s=3.0,
        scheduler={"controller": True, "burn_high": 1.0, "burn_low": 0.25,
                   "controller_hold_rounds": 2})
    plain = tgen.ContinuousBatchingEngine(tcfg, tparams, **common)
    try:
        a = list(eng.submit(GOLD_PROMPT, 6, tenant_id="gold",
                            slo_class="interactive"))
        b = list(eng.submit(BE_PROMPT, 6))
        snap = eng.scheduler_snapshot()
        assert snap["controller"]["mode"] == "latency"
        assert snap["knobs"] == {"prefill_token_budget": 8,
                                 "fetch_stride": 1, "dispatch_duty": 1.0,
                                 "speculation_enabled": False,
                                 "speculation_gamma": 0}
        assert eng.fetch_stride == 1 and eng.dispatch_duty == 1.0
        time.sleep(3.2)            # the violations leave the window
        c = list(eng.submit(BE_PROMPT, 12))
        snap = eng.scheduler_snapshot()
        assert snap["controller"]["mode"] == "throughput"
        assert snap["controller"]["flips"] == 2
        assert snap["knobs"]["fetch_stride"] == 4
        assert snap["knobs"]["prefill_token_budget"] == 64
        assert snap["knobs"]["dispatch_duty"] == 0.8
        assert snap["knobs"]["speculation_enabled"] is True
        assert [a, b, c] == [list(plain.submit(GOLD_PROMPT, 6)),
                             list(plain.submit(BE_PROMPT, 6)),
                             list(plain.submit(BE_PROMPT, 12))]
    finally:
        eng.stop()
        plain.stop()


@pytest.mark.parametrize("duty", [1.0, 0.5])
def test_duty_below_one_paces_the_loop(weights, duty):
    """Duty 1 never sleeps ("pace" stays 0 but is always reported); duty
    0.5 sleeps after every dispatch round."""
    _, _, tcfg, tparams = weights
    eng = tgen.ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                        n_slots=2, chunk=4,
                                        dispatch_duty=duty)
    try:
        toks = list(eng.submit(BE_PROMPT, 12))
        phases = eng.stats()["phase_seconds"]
    finally:
        eng.stop()
    assert len(toks) == 12
    assert "pace" in phases and "tier" not in phases
    assert (phases["pace"] > 0) == (duty < 1.0)
    eng.set_dispatch_duty(0.25)
    assert eng.dispatch_duty == 0.25
    with pytest.raises(ValueError):
        eng.set_dispatch_duty(0.0)
    eng.set_fetch_stride(64)
    assert eng.fetch_stride == 4      # clamped to the configured stride


def test_core_debug_surface_matches_the_reference(weights):
    """``debug_slo`` and ``debug_scheduler`` of both serving cores with a
    scheduled generator and a plain one registered: the same model rows
    (a model without a scheduler is left out of ``debug_scheduler``), the
    same label rows and counts, the same scheduler counters."""
    from client_tpu.models import decoder_lm as jlm
    from client_tpu.server import TpuInferenceServer
    from client_tpu_torch.models import decoder_lm as tlm
    from client_tpu_torch.server import TorchInferenceServer

    jcfg, jparams, tcfg, tparams = weights
    sched = dict(n_slots=2, chunk_size=4, prefix_cache=True,
                 prefix_block_len=4, scheduler=dict(SCHED),
                 slo_classes=[{"name": "interactive", "ttft_ms": 500.0}])
    got = {}
    for side in ("ref", "port"):
        if side == "ref":
            core = TpuInferenceServer()
            models = [jlm.make_continuous_generator(
                "sched_lm", cfg=jcfg, params=dict(jparams), **sched),
                jlm.make_continuous_generator(
                    "plain_lm", cfg=jcfg, params=dict(jparams))]
        else:
            core = TorchInferenceServer()
            models = [tlm.make_continuous_generator(
                "sched_lm", cfg=tcfg, params=tparams, device="cpu", **sched),
                tlm.make_continuous_generator(
                    "plain_lm", cfg=tcfg, params=tparams, device="cpu")]
        try:
            for m in models:
                core.register_model(m)
            list(models[0].engine.submit(GOLD_PROMPT, 4, tenant_id="vip",
                                         slo_class="interactive"))
            slo, sch = core.debug_slo(), core.debug_scheduler()
        finally:
            core.stop()
            for m in models:
                m.engine.stop()
        got[side] = (
            [(r["model"], r["version"], r["state"],
              [(t["tenant"], t["slo_class"], t["admitted"], t["completed"])
               for t in r["slo"]["tenant_classes"]],
              r["slo"]["classes"]) for r in slo["models"]],
            [(r["model"], r["version"],
              {k: r["scheduler"][k] for k in (
                  "enabled", "class_weights", "preemption",
                  "preemptions_total", "resumes_total", "knobs",
                  "parked_requests")}) for r in sch["models"]])
    assert got["port"] == got["ref"]
    assert [r[0] for r in got["port"][1]] == ["sched_lm"]
