"""The streaming context's deadline and cancel semantics in the port's
engine, held against the JAX package's engine on the CPU.

Both engines run the same scenario on the same weights, on the slot and on
the paged layout with the prefix cache on: a target stream whose prompt
hits a committed prefix (so it holds pins) beside two plain streams. The
target:

- ``past_deadline``: is submitted with a deadline already passed, and ends
  with a 504 before any token;
- ``sweep_deadline``: its deadline passes while it decodes, and the
  engine's dispatch-boundary sweep ends it with a 504;
- ``consumer_deadline``: its deadline passes while the engine is held, and
  the consumer's bounded wait ends it with a 504;
- ``cancel``: its cancel Event is set after its first token, and the
  sweep ends it with a 499.

It is deterministic: the engines' clock is a controllable one patched into
both generation modules here (the engine thread and the consumer can be
shown different times), the consumer is driven one token at a time, and
the engine is held at its first dispatch boundary after the target's first
token reached the host, so the target still holds its slot. Nothing sleeps
to wait for a state: every wait is on a condition with a generous timeout.

Each case checks the target's status and tokens, the ``deadline_expired``
and ``cancelled`` counters, the other streams' tokens (equal to the JAX
engine's), and after the drain that every accepted request was closed, no
slot is held, no trie node is pinned and the paged pool is whole.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import transformer as jt
from client_tpu.server import generation as jgen
from client_tpu.server.types import ServerError as JaxServerError
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import generation as tgen
from client_tpu_torch.server.types import ServerError

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=64, causal=True)
BL = 4
# one fetch per dispatch: a token reaches the host while its stream still
# holds its slot (the default stride delivers a short stream's first token
# after its last one was dispatched)
ENGINE = dict(n_slots=3, chunk=4, fetch_stride=1, prefix_cache=True,
              prefix_blocks=32, prefix_block_len=BL)
LAYOUTS = {"slot": {}, "paged": dict(kv_layout="paged", kv_block_len=BL)}
SHARED = [3, 17, 42, 9, 8, 7, 6, 5, 30, 31, 32, 33]  # 3 blocks of 4
WARM = np.asarray(SHARED + [1], np.int32)
TARGET = (np.asarray(SHARED + [2, 11], np.int32), 40)
OTHERS = [(np.asarray([5, 9, 14, 2, 60, 33], np.int32), 20),
          (np.asarray([44, 1, 23, 7, 19, 52, 8, 8, 3], np.int32), 25)]
FAR_S = 300          # a deadline no step of a case reaches by itself
SCENARIOS = ("past_deadline", "sweep_deadline", "consumer_deadline",
             "cancel")
WAIT_S = 120.0


class Clock:
    """``now_ns`` for both engines: monotonic time, plus ``engine_s`` on
    the engine thread and ``consumer_s`` on every other thread."""

    def __init__(self):
        self.engine_s = 0.0
        self.consumer_s = 0.0

    def __call__(self) -> int:
        on_engine = threading.current_thread().name == "cbatch-engine"
        shift = self.engine_s if on_engine else self.consumer_s
        return time.monotonic_ns() + int(shift * 1e9)


class Gate:
    """Holds an engine at the dispatch boundary (before its sweep) once
    the target stream, in a slot, has had a token delivered."""

    def __init__(self, engine):
        self.armed = False
        self.held = threading.Event()
        self.go = threading.Event()
        sweep = engine._reap_slots

        def reap():
            if self.armed and not self.go.is_set() and any(
                    s.req is not None and s.req.tenant == "target"
                    and s.req.emitted >= 1 for s in engine._slots):
                self.held.set()
                self.go.wait(WAIT_S)
            sweep()

        engine._reap_slots = reap

    def reset(self, armed: bool) -> None:
        self.armed = armed
        self.held.clear()
        self.go.clear()


def _wait(cond, timeout: float = WAIT_S) -> bool:
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            return False
        time.sleep(0.002)
    return True


@pytest.fixture(scope="module")
def engines():
    """Per layout, the JAX engine and the port's on the same weights,
    each with a warm prefix committed, the controllable clock patched in
    and a gate installed."""
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    clock = Clock()
    built = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgen, "now_ns", clock)
        mp.setattr(tgen, "now_ns", clock)
        try:
            for layout, kw in LAYOUTS.items():
                ref = jgen.ContinuousBatchingEngine(
                    jcfg, dict(jparams), **ENGINE, **kw).start()
                built[(layout, "ref")] = ref
                port = tgen.ContinuousBatchingEngine(
                    tcfg, tparams, device="cpu", **ENGINE, **kw).start()
                built[(layout, "port")] = port
                for eng in (ref, port):
                    list(eng.submit(WARM, 2))
            gates = {key: Gate(eng) for key, eng in built.items()}
            yield built, gates, clock
        finally:
            for eng in built.values():
                eng.stop()


def _consume(it, into: list) -> None:
    try:
        for tok in it:
            into.append(tok)
    except (ServerError, JaxServerError) as e:
        into.append(("error", e.status))


def _run(engine, gate, clock, scenario: str) -> dict:
    """One scenario on one engine: the target's tokens and error, and
    the other streams' tokens."""
    clock.engine_s = clock.consumer_s = 0.0
    gate.reset(armed=scenario != "past_deadline")
    now = time.monotonic_ns()
    deadline = now - 1 if scenario == "past_deadline" \
        else (now + int(FAR_S * 1e9) if "deadline" in scenario else 0)
    cancel = threading.Event() if scenario == "cancel" else None
    it = engine.submit(TARGET[0], TARGET[1], tenant_id="target",
                       slo_class="gold", deadline_ns=deadline,
                       cancel_event=cancel)
    others = [[] for _ in OTHERS]
    threads = [threading.Thread(target=_consume,
                                args=(engine.submit(p, b), out))
               for (p, b), out in zip(OTHERS, others)]
    for th in threads:
        th.start()
    tokens, status, held_slot = [], None, None
    try:
        tokens.append(next(it))
        assert gate.held.wait(WAIT_S)
        # the engine is held at a dispatch boundary; the target is in a
        # slot with its first delivery in hand
        held_slot = any(s.req is not None and s.req.tenant == "target"
                        for s in engine._slots)
        if scenario == "sweep_deadline":
            clock.engine_s = FAR_S + 1
            gate.go.set()
        elif scenario == "cancel":
            cancel.set()
            gate.go.set()
        elif scenario == "consumer_deadline":
            clock.consumer_s = FAR_S + 1
        tokens.extend(it)
    except (ServerError, JaxServerError) as e:
        status = (e.status, str(e))
    finally:
        if scenario == "consumer_deadline":
            # the target closed while the engine was held: its slot goes
            # at the engine's next sweep
            assert any(s.req is not None and s.req.tenant == "target"
                       and s.req.finished for s in engine._slots)
        gate.go.set()
    for th in threads:
        th.join(WAIT_S)
        assert not th.is_alive()
    return {"tokens": tokens, "status": status, "held_slot": held_slot,
            "others": others}


def _settled(engine) -> dict:
    """Wait until the engine has closed every accepted request and freed
    every slot; its counters, pins and pool then."""
    def idle():
        with engine._lock:
            closed = engine._requests_accepted == engine._requests_closed
        return closed and not any(s.req is not None for s in engine._slots)

    assert _wait(idle)
    snap = engine.gen_stats.snapshot()
    occ = engine._kv_index.occupancy() if engine._paged else None
    pinned = engine._prefix_index.pinned_nodes() \
        if hasattr(engine._prefix_index, "pinned_nodes") else None
    if pinned is None:
        # the reference's index has no pinned_nodes(): count the refs
        pinned, stack = 0, list(engine._prefix_index._root.children.values())
        while stack:
            node = stack.pop()
            pinned += node.refs > 0
            stack.extend(node.children.values())
    return {"deadline_expired": snap["deadline_expired"],
            "cancelled": snap["cancelled"], "occupancy": occ,
            "pinned": pinned}


WANT_STATUS = {
    "past_deadline": (504, "generation request deadline exceeded"),
    "sweep_deadline": (504, "generation request deadline exceeded while "
                            "decoding"),
    "consumer_deadline": (504, "generation request deadline exceeded"),
    "cancel": (499, "generation request cancelled by the client"),
}


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_deadline_and_cancel_match_the_jax_engine(engines, layout,
                                                  scenario):
    built, gates, clock = engines
    got = {}
    for side in ("ref", "port"):
        eng = built[(layout, side)]
        before = _settled(eng)
        run = _run(eng, gates[(layout, side)], clock, scenario)
        after = _settled(eng)
        run["counted"] = {k: after[k] - before[k]
                          for k in ("deadline_expired", "cancelled")}
        run["after"] = after
        got[side] = run
    port, ref = got["port"], got["ref"]
    # the port streams what the JAX engine streams, the target included
    assert port["others"] == ref["others"]
    assert all(len(o) == b for o, (_, b) in zip(port["others"], OTHERS))
    assert port["tokens"] == ref["tokens"]
    assert port["status"] == ref["status"] == WANT_STATUS[scenario]
    if scenario == "past_deadline":
        assert port["tokens"] == []
    else:
        # the target was in its slot when the engine was held, and ended
        # before its budget
        assert port["held_slot"] and ref["held_slot"]
        assert 1 <= len(port["tokens"]) < TARGET[1]
    want = ({"deadline_expired": 0, "cancelled": 1} if scenario == "cancel"
            else {"deadline_expired": 1, "cancelled": 0})
    assert port["counted"] == ref["counted"] == want
    assert port["after"]["pinned"] == 0 and ref["after"]["pinned"] == 0
    if layout == "paged":
        occ = port["after"]["occupancy"]
        assert occ["stream"] == 0 and occ["reserved"] == 0
        assert occ["free"] + occ["prefix"] == occ["usable"]


def test_labels_reach_the_slot_table_and_are_validated(engines):
    built, gates, clock = engines
    eng = built[("slot", "port")]
    gates[("slot", "port")].reset(armed=True)
    clock.engine_s = clock.consumer_s = 0.0
    it = eng.submit(TARGET[0], TARGET[1], tenant_id="target",
                    slo_class="gold")
    try:
        next(it)
        assert gates[("slot", "port")].held.wait(WAIT_S)
        rows = [r for r in eng.stats()["slots"] if r["active"]]
        assert [(r["tenant"], r["slo_class"]) for r in rows] \
            == [("target", "gold")]
    finally:
        gates[("slot", "port")].go.set()
    assert len(list(it)) == TARGET[1] - 1
    for kw in (dict(tenant_id="bad tenant"), dict(slo_class=""),
               dict(deadline_ns=-1)):
        for e in (eng, built[("slot", "ref")]):
            with pytest.raises((ServerError, JaxServerError)) as ei:
                e.submit(TARGET[0], 4, **kw)
            assert ei.value.status == 400
