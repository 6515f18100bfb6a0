"""Goodput and device-time attribution plane: the port's counterpart of
``client_tpu/server/goodput.py``.

The latency plane (stats.py) answers "how long do requests wait"; this
module answers where device time goes and how much of the work is useful:
per-kernel-kind device-time accounting plus a wasted-work decomposition
driven by the analytical FLOP model in ``models/transformer.py``.

Two estimators, the reference's, neither of which synchronises the card
in steady state:

- **Cadence attribution** (always on): every dispatch notes its kind;
  when the ring fetch drains (the engine's existing device-to-host
  synchronisation point) the wall time since the last drain is split
  evenly across the dispatches issued in between. It conserves wall time
  by construction. On the reference one dispatch is one executable and
  the host runs ahead, so that wall is device time; the port's eager
  dispatches are host-bound, and there the split counts the host's pace
  as much as the card's (PERF.md compares it with CUDA events).
- **Synchronous sampling** (opt-in, ``sample_every=N``): every Nth
  dispatch of a kind also blocks until its work is done and times the
  dispatch-to-ready wall directly (an upper bound: queued predecessors
  are included). The block is a CUDA event recorded on the dispatch's
  stream behind its kernels and waited on, the counterpart of
  ``jax.block_until_ready``; it waits for nothing else on the card (not
  the host tier's copies on their own stream). A CPU tensor's work is
  done when the call returns, so there it is a no-op. The sampled share
  (at most 1/N) is exported.

FLOP attribution is exact where timing is statistical: every row of a
dispatch runs the same kernel shape, so useful against wasted FLOPs are
row and column counts times the closed-form per-row cost: padding rows
of lane-batch and chunk buckets, verify rows beyond the accepted count
(attributed at retire, when the count is known), block-table width slack
in paged dispatches, frozen chunk riders.

One definition differs from the reference's: where the wall clock
starts. The reference's tracker starts it when it is made, so an
engine's warmup compiles count as idle wall in its lifetime rate, its
device-time share and its idle seconds (and, through a rate window that
still holds a warmup drain, in its live MFU). The port's engine calls
:meth:`GoodputTracker.start_clock` when its readiness ends, once every
CUDA graph is captured, so those seconds do not count. Everything else
is the reference's: a port tracker whose clock starts at ``t`` gives the
snapshot of a reference tracker made at ``t`` (tests/
test_torch_goodput.py holds that). The reason is the autoscaler's canary
gate, which judges a replica's MFU shortly after its attach: a fresh
canary's seconds of captures would read as idle serving and roll a clean
canary back.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from collections import deque
from typing import Callable, Optional

import torch

from client_tpu_torch.server.runtime_stats import COMPILE_BUCKETS_S

# Sliding window for the live MFU/goodput rate: long enough to smooth
# drain cadence, short enough that a stall shows within one scrape.
MFU_WINDOW_S = 10.0

# EWMA weight matching the ring-fetch cadence estimator in generation.py
# (0.7 old / 0.3 new) so both planes converge at the same rate.
_EWMA_KEEP = 0.7


def device_peak_flops(device=None, n_devices: int = 1) -> Optional[float]:
    """Dense bf16 peak FLOP/s of the engine's card, looked up by the card's
    name in the port's peak table (``perf/bench_harness.py:CARD_PEAKS``),
    times ``n_devices``: an engine over a mesh counts every card of it,
    as the reference sums its mesh's devices. None on the CPU and for a
    card the table does not know, and then the MFU pair stays
    unregistered (advertise only what can move)."""
    if device is None:
        return None
    from client_tpu_torch.perf.bench_harness import device_bf16_peak

    peak = device_bf16_peak(device)
    return None if peak is None else peak * n_devices


def _first_tensor(outputs):
    """The first tensor of a dispatch's outputs (a tensor, or a dict, list
    or tuple holding tensors), or None."""
    if isinstance(outputs, torch.Tensor):
        return outputs
    if isinstance(outputs, dict):
        outputs = list(outputs.values())
    if isinstance(outputs, (list, tuple)):
        for item in outputs:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


class FlopModel:
    """The analytical FLOP model of ``models/transformer.py`` folded to
    three integer coefficients, so a dispatch site's accounting costs a
    couple of multiplies. ``token(ctx)`` and ``span(pos0, n)`` agree
    exactly with ``transformer.token_flops`` and ``span_flops``."""

    __slots__ = ("fixed", "attn", "logits")

    def __init__(self, cfg):
        from client_tpu_torch.models.transformer import (
            attn_flops_per_pos,
            layer_flops_per_token,
            logit_flops,
        )
        self.fixed = cfg.n_layers * layer_flops_per_token(cfg)
        self.attn = cfg.n_layers * attn_flops_per_pos(cfg)
        self.logits = logit_flops(cfg)

    def token(self, ctx: int, logits: bool = True) -> int:
        """FLOPs for one token attending ``ctx`` positions."""
        total = self.fixed + self.attn * max(1, int(ctx))
        return total + self.logits if logits else total

    def span(self, pos0: int, n: int, logits: bool = True) -> int:
        """FLOPs for ``n`` consecutive positions starting at pos0."""
        n = int(n)
        if n <= 0:
            return 0
        pos0 = max(0, int(pos0))
        ctx_sum = n * pos0 + n * (n + 1) // 2
        total = n * self.fixed + self.attn * ctx_sum
        return total + n * self.logits if logits else total


def _new_hist() -> list:
    return [[0] * (len(COMPILE_BUCKETS_S) + 1), 0.0, 0]


class GoodputTracker:
    """Per-kernel-kind device-time and FLOP accounting for one engine.

    The engine loop mutates (``note_dispatch``, ``note_flops``,
    ``drain_mark``, ``reset_cadence``), scrapers call ``snapshot()``; one
    lock guards both sides and every critical section is tiny. The
    optional synchronous sample blocks OUTSIDE the lock. ``event_blocks``
    counts the samples that waited on a CUDA event (a CPU sample waits on
    nothing), or on ``block(outputs)`` when the engine gives one (a
    sharded engine's driver that holds no shard waits by asking the
    card's rank)."""

    def __init__(self, sample_every: int = 0,
                 peak_flops: Optional[float] = None,
                 clock=time.monotonic_ns,
                 block: Optional[Callable] = None):
        self._lock = threading.Lock()
        self._clock = clock
        self._wait = block
        self.sample_every = max(0, int(sample_every))
        self.peak_flops = peak_flops
        self.event_blocks = 0
        self._start_ns = clock()
        self._dispatches: dict = {}        # kind -> issued count
        self._device_ns: dict = {}         # kind -> attributed ns
        self._ewma_ns: dict = {}           # kind -> ns/dispatch estimate
        self._hist: dict = {}              # kind -> [counts, sum_s, n]
        self._sampled: dict = {}           # kind -> sync-sampled count
        self._sampled_ewma_ns: dict = {}   # kind -> blocked ns estimate
        self._useful: dict = {}            # kind -> useful FLOPs
        self._wasted: dict = {}            # kind -> {reason: FLOPs}
        self._useful_total = 0
        self._wasted_total = 0
        self._pending: list = []           # kinds since the last mark
        self._last_mark: Optional[int] = None
        self._rate_window: deque = deque()  # (ns, cumulative useful)

    # ------------------------------------------------------ engine side

    def start_clock(self) -> None:
        """Start the wall clock now and forget the rate window: the engine
        calls it once its readiness (the state, every warm-up capture) is
        done, so a fresh engine's lifetime rate and shares count serving
        wall only. The reference has no such call: its wall starts when
        the tracker is made (the module docstring says why the port's
        differs)."""
        with self._lock:
            self._start_ns = self._clock()
            self._rate_window.clear()

    def note_dispatch(self, kind: str, useful_flops: int = 0,
                      wasted: Optional[dict] = None,
                      outputs=None) -> None:
        """Record one dispatch of ``kind``. Call right after its kernels
        are enqueued; ``outputs`` (a tensor the dispatch wrote, or a
        container of them) enables the opt-in synchronous sample."""
        with self._lock:
            n = self._dispatches.get(kind, 0) + 1
            self._dispatches[kind] = n
            if useful_flops:
                self._useful[kind] = (self._useful.get(kind, 0)
                                      + useful_flops)
                self._useful_total += useful_flops
            if wasted:
                dst = self._wasted.setdefault(kind, {})
                for reason, flops in wasted.items():
                    if flops:
                        dst[reason] = dst.get(reason, 0) + flops
                        self._wasted_total += flops
            self._pending.append(kind)
            if self._last_mark is None:
                # baseline the cadence at the first dispatch after idle,
                # so the first drain's delta covers exactly the busy span
                self._last_mark = self._clock()
            do_sample = (self.sample_every > 0 and outputs is not None
                         and n % self.sample_every == 0)
        if do_sample:
            t0 = self._clock()
            self._block(outputs)
            dt = self._clock() - t0
            with self._lock:
                self._sampled[kind] = self._sampled.get(kind, 0) + 1
                prev = self._sampled_ewma_ns.get(kind)
                self._sampled_ewma_ns[kind] = (
                    dt if prev is None
                    else _EWMA_KEEP * prev + (1.0 - _EWMA_KEEP) * dt)

    def _block(self, outputs) -> None:
        """Wait until the work that wrote ``outputs`` is done: a CUDA event
        recorded now on the tensor's current stream (the dispatching
        thread's, behind the dispatch's kernels) and waited on. Nothing
        else on the card is waited for; the engine's ``block`` instead
        when it gave one."""
        if self._wait is not None:
            self._wait(outputs)
            with self._lock:
                self.event_blocks += 1
            return
        tensor = _first_tensor(outputs)
        if tensor is None or not tensor.is_cuda:
            return
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(tensor.device))
        done.synchronize()
        with self._lock:
            self.event_blocks += 1

    def note_flops(self, kind: str, useful_flops: int = 0,
                   wasted: Optional[dict] = None) -> None:
        """Deferred FLOP attribution with no dispatch attached: the
        speculative retire, where useful against rejected verify rows are
        known only once the acceptance count arrives."""
        if not useful_flops and not wasted:
            return
        with self._lock:
            if useful_flops:
                self._useful[kind] = (self._useful.get(kind, 0)
                                      + useful_flops)
                self._useful_total += useful_flops
            if wasted:
                dst = self._wasted.setdefault(kind, {})
                for reason, flops in wasted.items():
                    if flops:
                        dst[reason] = dst.get(reason, 0) + flops
                        self._wasted_total += flops

    def drain_mark(self, arrival_ns: Optional[int] = None) -> None:
        """The ring fetch drained: split the wall time since the last mark
        evenly over the dispatches issued in between. Burst drains (the
        2nd+ drain of one fetch batch) carry a near-zero delta and are
        harmless. Conserves wall by construction."""
        with self._lock:
            now = self._clock() if arrival_ns is None else arrival_ns
            self._attribute_locked(now)

    def reset_cadence(self) -> None:
        """The engine went idle: attribute any tail still pending, then
        drop the mark so idle wall is never booked as device time."""
        with self._lock:
            self._attribute_locked(self._clock())
            self._last_mark = None

    def _attribute_locked(self, now: int) -> None:
        last = self._last_mark
        self._last_mark = now
        pending, self._pending = self._pending, []
        if last is None or not pending:
            return
        delta = max(0, now - last)
        share = delta / len(pending)
        share_s = share / 1e9
        idx = bisect_right(COMPILE_BUCKETS_S, share_s)
        for kind in pending:
            self._device_ns[kind] = self._device_ns.get(kind, 0) + share
            prev = self._ewma_ns.get(kind)
            if prev is None:
                self._ewma_ns[kind] = share
            elif 0 < share < 5e9:   # the ring cadence's guard
                self._ewma_ns[kind] = (_EWMA_KEEP * prev
                                       + (1.0 - _EWMA_KEEP) * share)
            hist = self._hist.setdefault(kind, _new_hist())
            hist[0][idx] += 1
            hist[1] += share_s
            hist[2] += 1
        self._rate_window.append((now, self._useful_total))
        horizon = now - int(MFU_WINDOW_S * 1e9)
        while (len(self._rate_window) > 2
               and self._rate_window[0][0] < horizon):
            self._rate_window.popleft()

    # ----------------------------------------------------- scrape side

    def shares(self) -> tuple:
        """(device_time_share, wasted_flop_share): the two numbers cheap
        enough for the flight recorder to take every iteration."""
        with self._lock:
            wall = max(1, self._clock() - self._start_ns)
            device = sum(self._device_ns.values())
            attributed = self._useful_total + self._wasted_total
            return (min(1.0, device / wall),
                    (self._wasted_total / attributed) if attributed
                    else 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            now = self._clock()
            wall_ns = max(1, now - self._start_ns)
            device_ns = sum(self._device_ns.values())
            dispatch_total = sum(self._dispatches.values())
            sampled_total = sum(self._sampled.values())
            attributed = self._useful_total + self._wasted_total
            # live useful-FLOP rate over the sliding window; the lifetime
            # rate until the window has two points
            rate = None
            if len(self._rate_window) >= 2:
                (t0, f0), (t1, f1) = (self._rate_window[0],
                                      self._rate_window[-1])
                if t1 > t0:
                    rate = (f1 - f0) / ((t1 - t0) / 1e9)
            if rate is None:
                rate = self._useful_total / (wall_ns / 1e9)
            return {
                "sample_every": self.sample_every,
                "peak_flops": self.peak_flops,
                "dispatches": dict(self._dispatches),
                "device_ns": dict(self._device_ns),
                "ewma_ns": dict(self._ewma_ns),
                "device_time_hist": {
                    kind: (list(h[0]), h[1], h[2])
                    for kind, h in self._hist.items()},
                "sampled": dict(self._sampled),
                "sampled_ewma_ns": dict(self._sampled_ewma_ns),
                "sampled_total": sampled_total,
                "sampling_share": (sampled_total / dispatch_total
                                   if dispatch_total else 0.0),
                "useful_flops": dict(self._useful),
                "wasted_flops": {k: dict(v)
                                 for k, v in self._wasted.items()},
                "useful_flops_total": self._useful_total,
                "wasted_flops_total": self._wasted_total,
                "useful_flop_share": (self._useful_total / attributed
                                      if attributed else 1.0),
                "device_seconds_total": device_ns / 1e9,
                "wall_seconds": wall_ns / 1e9,
                "device_time_share": min(1.0, device_ns / wall_ns),
                "idle_seconds": max(0, wall_ns - device_ns) / 1e9,
                "useful_flops_per_s": rate,
                "mfu": (rate / self.peak_flops
                        if self.peak_flops else None),
            }


def merge_goodput(snaps: list) -> Optional[dict]:
    """Merge per-replica goodput snapshots: counters and histograms sum,
    shares and rates recompute from the sums. MFU merges as the FLOP-rate
    sum over the summed peak (fleet MFU, not a mean of replica MFUs).
    The replica fleet (``server/fleet.py``) calls it; the canary judge
    (``server/autoscale.py``) reads each replica's own MFU."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return None

    def _sum_maps(key):
        out: dict = {}
        for s in snaps:
            for k, v in (s.get(key) or {}).items():
                out[k] = out.get(k, 0) + v
        return out

    hist: dict = {}
    for s in snaps:
        for kind, (counts, sum_s, n) in (
                s.get("device_time_hist") or {}).items():
            dst = hist.setdefault(kind, _new_hist())
            for i, c in enumerate(counts):
                dst[0][i] += c
            dst[1] += sum_s
            dst[2] += n
    wasted: dict = {}
    for s in snaps:
        for kind, reasons in (s.get("wasted_flops") or {}).items():
            dst = wasted.setdefault(kind, {})
            for reason, flops in reasons.items():
                dst[reason] = dst.get(reason, 0) + flops
    useful_total = sum(s.get("useful_flops_total", 0) for s in snaps)
    wasted_total = sum(s.get("wasted_flops_total", 0) for s in snaps)
    attributed = useful_total + wasted_total
    dispatch = _sum_maps("dispatches")
    dispatch_total = sum(dispatch.values())
    sampled_total = sum(s.get("sampled_total", 0) for s in snaps)
    device_ns = _sum_maps("device_ns")
    device_total = sum(device_ns.values())
    wall = max(s.get("wall_seconds", 0.0) for s in snaps)
    peaks = [s.get("peak_flops") for s in snaps]
    peak = sum(p for p in peaks if p) if all(peaks) else None
    rate = sum(s.get("useful_flops_per_s", 0.0) for s in snaps)
    return {
        "sample_every": max(s.get("sample_every", 0) for s in snaps),
        "peak_flops": peak,
        "dispatches": dispatch,
        "device_ns": device_ns,
        "ewma_ns": {},          # per-replica estimate; not mergeable
        "device_time_hist": {
            kind: (list(h[0]), h[1], h[2]) for kind, h in hist.items()},
        "sampled": _sum_maps("sampled"),
        "sampled_ewma_ns": {},
        "sampled_total": sampled_total,
        "sampling_share": (sampled_total / dispatch_total
                           if dispatch_total else 0.0),
        "useful_flops": _sum_maps("useful_flops"),
        "wasted_flops": wasted,
        "useful_flops_total": useful_total,
        "wasted_flops_total": wasted_total,
        "useful_flop_share": (useful_total / attributed
                              if attributed else 1.0),
        "device_seconds_total": device_total / 1e9,
        "wall_seconds": wall,
        "device_time_share": (min(1.0, device_total / 1e9 / wall)
                              if wall else 0.0),
        "idle_seconds": max(0.0, wall - device_total / 1e9),
        "useful_flops_per_s": rate,
        "mfu": (rate / peak if peak else None),
    }
