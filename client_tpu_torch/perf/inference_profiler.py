"""InferenceProfiler — search driver + measurement + stabilization: the
port's copy of ``client_tpu/perf/inference_profiler.py``.

- Linear/binary/none search over concurrency or request rate, and one
  profile at a custom intervals file's rate.
- A sliding stability window of 3 measurements: BOTH infer/sec and
  latency within ±stability of the window average, an optional latency
  threshold early-break, a max_trials cap.
- ``measure()``: server-stats snapshot deltas around a time- or
  count-based window.
- Valid-latency filtering: only requests fully inside the measurement
  window count; sequences are counted on sequence_end; schedule-delayed
  requests are excluded from rate math.

- The metrics half: ``/metrics`` scraped at the window's ends and up to
  three times inside it (the queue depths' p50 and max), the families'
  deltas in ``ServerMetricsStats`` (the goodput plane's per-kind
  dispatches, device seconds and FLOPs among them), the window gates
  that read them (``fail_on_incident`` names the newest incident bundle,
  ``min_goodput`` the useful-FLOP floor), and the slowest traced
  requests' phase split joined with the scraped exemplars. Where the
  backend has no metrics plane the status carries no scraped metrics
  rather than zeros.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

from client_tpu_torch.perf.model_parser import ModelParser
from client_tpu_torch.perf.perf_utils import early_exit


@dataclasses.dataclass
class LatencyStats:
    avg_us: float = 0.0
    std_us: float = 0.0
    min_us: float = 0.0
    max_us: float = 0.0
    percentiles_us: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ServerSideStats:
    inference_count: int = 0
    execution_count: int = 0
    success_count: int = 0
    queue_count: int = 0
    queue_time_us: float = 0.0
    compute_input_time_us: float = 0.0
    compute_infer_time_us: float = 0.0
    compute_output_time_us: float = 0.0
    cache_hit_count: int = 0
    cache_hit_time_us: float = 0.0
    cache_miss_count: int = 0
    cache_miss_time_us: float = 0.0
    rejected_count: int = 0   # admission-control sheds in the window
    composing_models: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ServerMetricsStats:
    """Deltas scraped from the server's Prometheus /metrics plane around
    the measurement window. The fleet families are read when the model
    runs a replica fleet, the runtime ones (its compile set) when the
    server exports them; absent families leave their fields at their
    defaults with their ``*_scraped`` flag False."""

    scraped: bool = False
    queue_depth_p50: float = 0.0
    queue_depth_max: float = 0.0
    batches_per_sec: float = 0.0
    inferences_per_sec: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    # token-generation families (client_tpu_generation_*): present only
    # when the profiled model carries a generation engine
    generation_scraped: bool = False
    generation_tokens_per_sec: float = 0.0
    generation_slot_occupancy: float = 0.0  # busy-slot-s / (slots * window)
    # engine-thread phase wall deltas over the window (seconds), keyed
    # admit/dispatch/retire_fetch/retire_deliver/pace — the share of
    # retire in this split is the serving-overhead regression signal
    # the profiler can fail a window on (see retire_share_ceiling)
    engine_phase_s: dict = dataclasses.field(default_factory=dict)
    # token-ring deferred-retire families: fetch-count delta over the
    # window plus the fetch-lag gauge at window end
    generation_chunks: int = 0
    ring_fetches: int = 0
    ring_forced_fetches: int = 0
    ring_lag_chunks: float = 0.0
    # configured dispatches per fetch (gauge at window end; 1 covers
    # stride-1 overlapped AND overlap-off engines, whose amortization
    # is ~1 by construction, not by regression)
    ring_fetch_stride: float = 0.0
    # chunked-prefill lane families
    # (client_tpu_generation_prefill_*): present only when the engine
    # runs prefill_mode="chunked"; deltas over the window. The lane's
    # engine-phase share plus a nonzero generation queue is the
    # starvation signal the prefill-share window gate fires on.
    prefill_tokens: int = 0
    prefill_chunks: int = 0
    # dedicated-prefill-lane families
    # (client_tpu_generation_prefill_lane_*): present only when the
    # engine runs a dedicated prefill slot set (prefill_slots > 0) —
    # lane occupancy at window end + handoff delta over the window
    lane_scraped: bool = False
    lane_slots: float = 0.0
    lane_active: float = 0.0
    lane_handoffs: int = 0
    # host-tier families (client_tpu_generation_tier_*): present only
    # when the engine arms the host-RAM prefix tier — spill/restore/
    # hit deltas over the window, tier residency at window end
    tier_scraped: bool = False
    tier_blocks: float = 0.0
    tier_spills: int = 0
    tier_restores: int = 0
    tier_hits: int = 0
    # generation-engine pending-queue gauge (requests awaiting a slot
    # — NOT the scheduler queue_depth_p50 above): MAX over the
    # window's periodic samples, so the starvation gate does not hinge
    # on whether the queue happened to be drained at the instant of
    # the end-of-window scrape
    generation_queue_depth: float = 0.0

    @property
    def ring_amortization(self) -> float:
        """Dispatches per D2H ring fetch over the window. ~1.0 is the
        pre-ring regression shape (every dispatch paid its own
        transfer); a healthy stride-k engine reports ~k."""
        return self.generation_chunks / self.ring_fetches \
            if self.ring_fetches else 0.0
    # prefix-cache families (client_tpu_generation_prefix_cache_*):
    # present only when the engine runs the KV block pool; deltas over
    # the measurement window
    prefix_cache_scraped: bool = False
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_saved_tokens: int = 0
    prefix_evictions: int = 0
    prefix_blocks_used: int = 0   # gauge at window end, not a delta
    # speculation families (client_tpu_generation_spec_*): present only
    # when the engine runs a draft model; deltas over the window
    spec_scraped: bool = False
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_rejected: int = 0
    spec_rounds: int = 0
    spec_acceptance_gauge: float = 0.0   # rolling EWMA at window end
    # runtime (compile/memory) families (client_tpu_runtime_*): present
    # when a served model carries a compile set (every TorchModel and
    # generation engine). Compile deltas over the window must be 0 on a
    # warmed server
    # — a non-zero count means a mid-serving compile stole wall time
    # per-tenant SLO families (client_tpu_slo_*): present only when
    # the profiled model carries the SLO stats plane. One row per
    # (tenant, slo_class): windowed quantile gauges at window end,
    # burn rate, and reject/latency attribution (sheds/requests are
    # window deltas) — the serving-side split the report's SLO block
    # and the per-tenant CSV columns render
    slo_scraped: bool = False
    slo_tenants: dict = dataclasses.field(default_factory=dict)
    # closed-loop scheduler families (client_tpu_sched_*): present
    # only when the profiled engine runs the SLO scheduler
    # (server/scheduling.py). Preemption/resume counts are window
    # deltas; the knob gauges are the controller's LIVE values at
    # window end — a latency-mode window shows budget at its floor,
    # stride 1, duty 1.0, spec 0.
    sched_scraped: bool = False
    sched_preemptions: int = 0
    sched_resumes: int = 0
    sched_queue_depth: float = 0.0     # fair-queue total at window end
    sched_prefill_budget: float = 0.0
    sched_fetch_stride: float = 0.0
    sched_dispatch_duty: float = 0.0
    sched_spec_enabled: float = 1.0
    # replica-fleet families (client_tpu_fleet_*): present only when
    # the profiled model runs a ReplicaFleet (server/fleet.py).
    # Routed/re-routed/affinity/drain counts are window deltas (summed
    # across replicas); health/queue-depth are gauges at window end.
    fleet_scraped: bool = False
    fleet_replicas: float = 0.0
    fleet_healthy: float = 0.0
    fleet_queue_depth: float = 0.0
    fleet_routed: int = 0
    fleet_rerouted: int = 0
    fleet_affinity_hits: int = 0
    fleet_drains: int = 0
    # goodput / device-time attribution families
    # (client_tpu_goodput_*): present when the profiled engine carries
    # the GoodputTracker. Per-kernel-kind device seconds, dispatches
    # and useful FLOPs are window deltas (the roofline table's
    # columns); the shares the gate reads are recomputed from the
    # window's FLOP deltas, not the lifetime gauges, so one bad window
    # cannot hide behind a good lifetime average.
    goodput_scraped: bool = False
    goodput_device_s: dict = dataclasses.field(default_factory=dict)
    goodput_dispatches: dict = dataclasses.field(default_factory=dict)
    goodput_kind_useful_flops: dict = dataclasses.field(
        default_factory=dict)
    goodput_useful_flops: float = 0.0    # window delta, all kinds
    goodput_wasted_flops: float = 0.0    # window delta, all kinds
    goodput_sampling_share: float = 0.0  # gauge at window end
    goodput_mfu: float = 0.0             # gauge at window end
    goodput_mfu_present: bool = False    # absent on CPU / unknown card
    runtime_scraped: bool = False
    runtime_compiles: int = 0             # delta over the window
    runtime_unexpected_compiles: int = 0  # delta over the window
    # warmup-cost honesty (ABSOLUTE values at window end, not deltas —
    # warmup happens before the first window; the counters guard the
    # sealed-set growth bucket grids like the lane-batch x chunk grid
    # and the gamma ladder multiply into)
    runtime_warmup_compiles: int = 0
    runtime_warmup_compile_s: float = 0.0
    hbm_bytes_in_use: float = 0.0   # gauges at window end, summed over
    hbm_bytes_limit: float = 0.0    # devices; 0 when the backend
    #                                 reports no memory stats (CPU)
    # paged-pool HBM attribution split (model_memory_bytes components
    # kv_pool_live/prefix/free, summed over models at window end) —
    # present only when a profiled engine runs kv_layout="paged"
    hbm_pool_live_bytes: float = 0.0
    hbm_pool_prefix_bytes: float = 0.0
    hbm_pool_free_bytes: float = 0.0
    # watchdog / incident plane: per-detector incident deltas over the
    # window (client_tpu_watchdog_incidents_total) plus the sample count
    # and the incident-ring depth gauge at window end — the signal the
    # opt-in --fail-on-incident window gate reads
    watchdog_scraped: bool = False
    watchdog_samples: int = 0            # delta over the window
    watchdog_incidents: dict = dataclasses.field(default_factory=dict)
    watchdog_ring_depth: float = 0.0     # gauge at window end

    @property
    def watchdog_incident_count(self) -> int:
        """Incidents fired inside the window, all detectors."""
        return sum(self.watchdog_incidents.values())

    @property
    def cache_hit_rate(self) -> float:
        lookups = self.cache_hits + self.cache_misses
        return self.cache_hits / lookups if lookups else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        lookups = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / lookups if lookups else 0.0

    @property
    def spec_acceptance_rate(self) -> float:
        """Window acceptance rate: accepted / proposed draft tokens."""
        return self.spec_accepted / self.spec_proposed \
            if self.spec_proposed else 0.0

    @property
    def hbm_headroom_bytes(self) -> float:
        """Device memory still free at window end (limit - in_use)."""
        return max(0.0, self.hbm_bytes_limit - self.hbm_bytes_in_use)

    @property
    def engine_retire_share(self) -> float:
        """Fraction of the engine thread's phase wall spent retiring
        (fetch wait + token delivery) over the window — the factor the
        overlapped token ring exists to keep small."""
        total = sum(self.engine_phase_s.values())
        if total <= 0:
            return 0.0
        return (self.engine_phase_s.get("retire_fetch", 0.0)
                + self.engine_phase_s.get("retire_deliver", 0.0)
                # pre-split engines reported one 'retire' bucket
                + self.engine_phase_s.get("retire", 0.0)) / total

    @property
    def engine_prefill_share(self) -> float:
        """Fraction of the engine thread's phase wall spent in the
        chunked-prefill lane over the window — the axis the
        prefill_token_budget knob bounds. High share with a nonzero
        pending queue means prompt ingestion is starving decode
        admission (the regression the prefill-share ceiling gates)."""
        total = sum(self.engine_phase_s.values())
        if total <= 0:
            return 0.0
        return self.engine_phase_s.get("prefill", 0.0) / total

    @property
    def goodput_useful_flop_share(self) -> float:
        """Window useful-FLOP share: useful / (useful + wasted) over
        the measurement window's FLOP deltas — the ratio the
        --min-goodput gate compares against its floor."""
        total = self.goodput_useful_flops + self.goodput_wasted_flops
        return self.goodput_useful_flops / total if total else 1.0

    @property
    def goodput_device_seconds(self) -> float:
        """Attributed device seconds over the window, all kinds."""
        return sum(self.goodput_device_s.values())

    @property
    def spec_tokens_per_round(self) -> float:
        """Mean verified tokens emitted per round (accepted + 1) — the
        draft-overhead efficiency axis: at gamma draft steps per round,
        speculation pays off while this exceeds the draft/target cost
        ratio times gamma + 1."""
        return (self.spec_accepted + self.spec_rounds) / self.spec_rounds \
            if self.spec_rounds else 0.0


@dataclasses.dataclass
class GenerationClientStats:
    """Client-observed token-stream measurements from the streaming load
    workers: TTFT per request, per-token inter-token gaps."""

    enabled: bool = False
    request_count: int = 0   # requests that produced a first token
    token_count: int = 0
    tokens_per_sec: float = 0.0
    ttft_avg_us: float = 0.0
    ttft_percentiles_us: dict = dataclasses.field(default_factory=dict)
    itl_avg_us: float = 0.0
    itl_percentiles_us: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PerfStatus:
    concurrency: int = 0
    request_rate: float = 0.0
    client_infer_per_sec: float = 0.0
    client_sequence_per_sec: float = 0.0
    valid_count: int = 0
    delayed_count: int = 0
    # sheds (503/UNAVAILABLE) this client observed inside the window —
    # the client-side twin of server.rejected_count
    client_rejected_count: int = 0
    client_retried_count: int = 0
    window_s: float = 0.0
    latency: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    avg_request_time_us: float = 0.0
    server: ServerSideStats = dataclasses.field(
        default_factory=ServerSideStats)
    metrics: ServerMetricsStats = dataclasses.field(
        default_factory=ServerMetricsStats)
    generation: GenerationClientStats = dataclasses.field(
        default_factory=GenerationClientStats)
    # per-request phase breakdown of the window's slowest traced requests
    # (server spans joined with the scraped /metrics exemplar trace ids):
    # [{trace_id, total_us, queue_us, prefill_us, handoff_us, decode_us,
    # fetch_us, replica, route_leg, in_window, in_exemplars}]; empty when
    # the service exposes no trace plane or tracing is off
    slowest_requests: list = dataclasses.field(default_factory=list)
    stabilized: bool = False
    error: Optional[str] = None   # measurement failure (e.g. every window
    #                               empty) — such a status is never a row


class InferenceProfiler:
    def __init__(self, manager, parser: ModelParser, backend,
                 measurement_window_ms: int = 5000,
                 measurement_mode: str = "time_windows",
                 measurement_request_count: int = 50,
                 stability_threshold: float = 0.1,
                 max_trials: int = 10,
                 latency_threshold_us: int = 0,
                 percentiles: tuple = (50, 90, 95, 99),
                 stability_percentile: Optional[int] = None,
                 include_server_stats: bool = True,
                 fail_on_window_compiles: bool = True,
                 fail_on_incident: bool = False,
                 retire_share_ceiling: float = 0.2,
                 prefill_share_ceiling: float = 0.0,
                 min_goodput: float = 0.0):
        """The window gates, as the reference's (``_window_violation``):
        ``fail_on_window_compiles`` fails a window that saw a
        serving-phase compile (a CUDA-graph capture after the model
        sealed its compile set). ``retire_share_ceiling`` is the largest share
        of the generation engine's phase wall the retire phases may take
        in a busy window whose dispatches per ring fetch fell well below
        the configured stride (0 disables). ``prefill_share_ceiling`` is
        the largest share the chunked-prefill lane may take while
        requests queue for a slot (0, the default, disables).
        ``min_goodput`` is the least useful-FLOP share (useful / (useful
        + wasted) over the window's FLOP deltas) a window at slot
        occupancy >= 0.5 must keep (0, the default, disables).
        ``fail_on_incident`` fails a window in which the watchdog fired
        any incident, naming the detectors and the newest bundle."""
        self.manager = manager
        self.parser = parser
        self.backend = backend
        self.window_ms = measurement_window_ms
        self.mode = measurement_mode
        self.request_count = measurement_request_count
        self.stability = stability_threshold
        self.max_trials = max_trials
        self.latency_threshold_us = latency_threshold_us
        self.percentiles = percentiles
        self.stability_percentile = stability_percentile
        self.include_server_stats = include_server_stats
        self.fail_on_window_compiles = fail_on_window_compiles
        self.fail_on_incident = fail_on_incident
        self.retire_share_ceiling = retire_share_ceiling
        self.prefill_share_ceiling = prefill_share_ceiling
        self.min_goodput = min_goodput

    def _stability_latency_us(self, status: PerfStatus) -> float:
        """Latency used for stabilization + threshold checks: the average
        or, with a stability percentile, that percentile."""
        if self.stability_percentile:
            return status.latency.percentiles_us.get(
                self.stability_percentile, status.latency.avg_us)
        return status.latency.avg_us

    # ---- search driver ----

    @staticmethod
    def _failed(status: PerfStatus, level) -> bool:
        """A failed measurement (every window empty) is warned about and
        never becomes a result row. Single-point runs raise instead."""
        if status.error is None:
            return False
        import sys

        print(f"warning: level {level}: {status.error}", file=sys.stderr,
              flush=True)
        return True

    def profile_concurrency_range(self, start: int, end: int, step: int,
                                  search_mode: str = "linear",
                                  latency_threshold_us: int = 0) -> list:
        self.latency_threshold_us = latency_threshold_us or \
            self.latency_threshold_us
        results = []
        if search_mode == "none":
            status = self._profile_concurrency(start)
            if status.error is not None:
                raise RuntimeError(status.error)
            results.append(status)
        elif search_mode == "binary":
            lo, hi = start, end
            while lo <= hi and not early_exit.is_set():
                mid = (lo + hi) // 2
                status = self._profile_concurrency(mid)
                if self._failed(status, mid):
                    hi = mid - step  # unmeasurable == over threshold
                    continue
                results.append(status)
                if self._meets_threshold(status):
                    lo = mid + step
                else:
                    hi = mid - step
        else:
            c = start
            while c <= end or end == 0:
                status = self._profile_concurrency(c)
                if not self._failed(status, c):
                    results.append(status)
                    if early_exit.is_set():
                        break  # SIGINT: report what we have
                    if not self._meets_threshold(status):
                        break
                    if end == 0 and not status.stabilized:
                        break
                c += step
                if end == 0 and c > start * 1024:
                    break
        return results

    def profile_request_rate_range(self, start: float, end: float,
                                   step: float,
                                   search_mode: str = "linear") -> list:
        results = []
        if search_mode == "none":
            status = self._profile_rate(start)
            if status.error is not None:
                raise RuntimeError(status.error)
            results.append(status)
        elif search_mode == "binary":
            lo, hi = start, end
            while lo <= hi + 1e-9 and not early_exit.is_set():
                mid = (lo + hi) / 2
                status = self._profile_rate(mid)
                if self._failed(status, mid):
                    hi = mid - step
                    continue
                results.append(status)
                if self._meets_threshold(status):
                    lo = mid + step
                else:
                    hi = mid - step
        else:
            r = start
            while r <= end + 1e-9:
                status = self._profile_rate(r)
                if self._failed(status, r):
                    break  # a stalled rate level ends the ramp
                results.append(status)
                if early_exit.is_set() or not self._meets_threshold(status):
                    break
                r += step
        return results

    def profile_custom(self) -> list:
        """--request-intervals mode: single profile at the file's rate."""
        rate = self.manager.custom_request_rate()
        self.manager.start()
        status = self._stabilize()
        if status.error is not None:
            raise RuntimeError(status.error)
        status.request_rate = rate
        return [status]

    def _meets_threshold(self, status: PerfStatus) -> bool:
        if self.latency_threshold_us <= 0:
            return True
        return self._stability_latency_us(status) <= \
            self.latency_threshold_us

    def _profile_concurrency(self, concurrency: int) -> PerfStatus:
        self.manager.change_concurrency_level(concurrency)
        status = self._stabilize()
        status.concurrency = concurrency
        return status

    def _profile_rate(self, rate: float) -> PerfStatus:
        self.manager.change_request_rate(rate, self.window_ms / 1e3)
        status = self._stabilize()
        status.request_rate = rate
        return status

    # ---- stabilization ----

    def _stabilize(self) -> PerfStatus:
        window = []  # sliding window of (ips, latency_us, status)
        last_valid = None
        for _ in range(self.max_trials):
            self.manager.check_health()
            status = self.measure()
            if early_exit.is_set():
                # SIGINT mid-stabilization: keep the last measurement so
                # the caller can still print a (partial) report
                status.stabilized = False
                return status
            if status.valid_count == 0:
                continue  # empty window: retry, never a result
            violation = self._window_violation(status)
            if violation:
                # a violated window is a measurement failure the run must
                # surface, not average away: the latency threshold's
                # early stop
                status.stabilized = False
                status.error = violation
                return status
            last_valid = status
            window.append((status.client_infer_per_sec,
                           self._stability_latency_us(status), status))
            if len(window) > 3:
                window.pop(0)
            if self.latency_threshold_us > 0 and \
                    self._stability_latency_us(status) > \
                    self.latency_threshold_us:
                status.stabilized = False
                return status  # over threshold: stop early
            if len(window) == 3 and self._is_stable(window):
                status.stabilized = True
                return status
        if last_valid is not None:
            last_valid.stabilized = False
            return last_valid
        # every window came back empty: that is a measurement FAILURE, not
        # a 0-infer/s data point
        status = PerfStatus()
        status.error = (
            f"no valid requests recorded in {self.max_trials} measurement "
            f"windows of {self.window_ms} ms — requests outlive the window "
            "or the model is stalled; widen the measurement window")
        return status

    def _window_violation(self, status: PerfStatus) -> Optional[str]:
        """Serving-invariant checks a measurement window must pass (the
        reference's, in its order): no serving-phase compile, no watchdog
        incident under ``fail_on_incident``, the generation engine's
        retire and prefill shares under their ceilings, and the
        useful-FLOP share above ``min_goodput``. Returns a readable
        violation or None."""
        sm = status.metrics
        if sm is None or not sm.scraped:
            return None
        if self.fail_on_window_compiles and sm.runtime_scraped \
                and sm.runtime_unexpected_compiles > 0:
            # sealed-set violations only: a warmup-phase compile in an
            # early window is legal (the stability window machinery
            # already discards the wall time it skews), but a compile
            # AFTER the model declared its compile set closed stalls
            # every in-flight stream and invalidates the measurement
            return (
                f"{sm.runtime_unexpected_compiles} serving-phase "
                f"compile(s) inside the measurement window "
                f"({sm.runtime_compiles} total) — a warmed server's "
                "sealed compile set must stay closed; the compile "
                "stalled every in-flight stream and stole wall time "
                "from the measurement")
        # the incident gate (opt-in): the server's always-on watchdog
        # fired during the window — whatever the detectors caught
        # (stall, leak, burn spike, ...) also invalidates the window's
        # wall time as a steady-state data point
        if self.fail_on_incident and sm.watchdog_scraped \
                and sm.watchdog_incident_count > 0:
            fired = ", ".join(
                f"{det} x{n}" for det, n in
                sorted(sm.watchdog_incidents.items()))
            newest = self._newest_incident()
            tail = (f" — newest bundle {newest['id']}"
                    f" ({newest['detector']})" if newest else "")
            return (
                f"{sm.watchdog_incident_count} watchdog incident(s) "
                f"fired inside the measurement window [{fired}]{tail}"
                " — the serving invariants the always-on detectors "
                "guard broke while measuring; retrieve the evidence "
                "bundle from GET /v2/debug/incidents")
        # the retire ceiling targets the pre-ring regression SHAPE:
        # a default-stride engine paying one D2H per dispatch
        # (amortization ~1) while retire dominates the phase wall at
        # saturation. A healthy overlapped engine legitimately parks in
        # retire_fetch when it is device-bound (the host has nothing
        # else to do), so share alone must not fail a window — and an
        # engine CONFIGURED for stride 1 (or overlap off, which reports
        # stride 1) has amortization ~1 by construction, so the floor
        # scales with the configured stride (3/4 of it, capped at the
        # legacy 2.0): stride 1 can never trip it, stride k trips only
        # when the achieved amortization falls well below k.
        amort_floor = min(2.0, 0.75 * sm.ring_fetch_stride) \
            if sm.ring_fetch_stride > 0 else 2.0
        if (self.retire_share_ceiling > 0 and sm.generation_scraped
                and sm.engine_phase_s
                and sm.engine_retire_share > self.retire_share_ceiling
                and sm.generation_slot_occupancy >= 0.5
                and sm.generation_chunks > 0
                and sm.ring_amortization < amort_floor):
            return (
                f"engine retire-phase share "
                f"{sm.engine_retire_share:.0%} exceeds the "
                f"{self.retire_share_ceiling:.0%} ceiling with "
                f"{sm.ring_amortization:.1f} dispatches per D2H fetch "
                "— the per-chunk fetch stall the overlapped token "
                "ring removed is back (raise fetch_stride or "
                "investigate the transport)")
        # the prefill-share ceiling targets lane starvation: the
        # chunked-prefill lane dominating the engine's phase wall
        # WHILE requests queue for slots means prompt ingestion is
        # eating the decode capacity those requests are waiting for.
        # An idle-queue window is exempt — with nobody waiting, a
        # prefill-dominated wall is just an ingestion-heavy workload
        # doing its job (the symmetric shape to the retire gate's
        # device-bound exemption).
        if (self.prefill_share_ceiling > 0 and sm.generation_scraped
                and sm.engine_phase_s
                and sm.engine_prefill_share > self.prefill_share_ceiling
                and sm.generation_queue_depth > 0):
            return (
                f"engine prefill-lane share "
                f"{sm.engine_prefill_share:.0%} exceeds the "
                f"{self.prefill_share_ceiling:.0%} ceiling with "
                f"{sm.generation_queue_depth:.0f} request(s) queued "
                "for a slot during the window — prompt ingestion is "
                "starving decode "
                "admission (lower prefill_token_budget, or raise the "
                "ceiling if the workload is ingestion-bound)")
        # the goodput floor targets wasted device work: a BUSY window
        # (occupancy >= 0.5 — an idle engine wastes nothing worth
        # gating on) whose window-delta useful-FLOP share falls below
        # the floor is burning its device time on padding rows, frozen
        # passengers, table slack or rejected speculation — throughput
        # can look healthy while most FLOPs produce nothing.
        if (self.min_goodput > 0 and sm.goodput_scraped
                and sm.generation_scraped
                and (sm.goodput_useful_flops
                     + sm.goodput_wasted_flops) > 0
                and sm.goodput_useful_flop_share < self.min_goodput
                and sm.generation_slot_occupancy >= 0.5):
            return (
                f"useful-FLOP share {sm.goodput_useful_flop_share:.0%} "
                f"fell below the {self.min_goodput:.0%} goodput floor "
                f"with {sm.generation_slot_occupancy:.0%} slot "
                "occupancy — the engine is busy but most of its device "
                "work is waste (padding / frozen / table_slack / "
                "spec_reject; see the report's goodput block for the "
                "per-kind split)")
        return None

    def _is_stable(self, window) -> bool:
        avg_ips = sum(w[0] for w in window) / len(window)
        avg_lat = sum(w[1] for w in window) / len(window)
        for ips, lat, _ in window:
            if avg_ips <= 0 or abs(ips - avg_ips) / avg_ips > self.stability:
                return False
            if avg_lat <= 0 or abs(lat - avg_lat) / avg_lat > self.stability:
                return False
        return True

    # ---- one measurement ----

    # percentiles of the token series
    GENERATION_PERCENTILES = (50, 95, 99)

    def measure(self) -> PerfStatus:
        server_before = self._server_stats_snapshot()
        metrics_before = self._metrics_snapshot()
        stat_before = self.manager.accumulated_client_stat()
        swap_gen = getattr(self.manager, "swap_generation_samples", None)
        if swap_gen is not None:
            swap_gen()  # discard pre-window token samples
        queue_depths = []
        gen_queue_depths = []
        self._record_queue_depth(metrics_before, queue_depths,
                                 gen_queue_depths)

        window_start = time.monotonic_ns()
        if self.mode == "count_windows":
            deadline = time.monotonic() + 10 * self.window_ms / 1e3
            base = self.manager.count_collected_requests()
            next_sample = time.monotonic() + 0.5
            while self.manager.count_collected_requests() - base \
                    < self.request_count and time.monotonic() < deadline \
                    and not early_exit.is_set():
                time.sleep(0.01)
                if metrics_before is not None \
                        and time.monotonic() >= next_sample:
                    self._record_queue_depth(self._metrics_snapshot(),
                                             queue_depths,
                                             gen_queue_depths)
                    next_sample = time.monotonic() + 0.5
        else:
            # Event.wait returns as soon as SIGINT fires, cutting the
            # window short instead of sleeping through it. With a metrics
            # plane available, the wait is chunked so the queue-depth
            # gauge is sampled a few times across the window (p50/max
            # need more than the two endpoint scrapes).
            window_s = self.window_ms / 1e3
            if metrics_before is None:
                early_exit.wait(window_s)
            else:
                deadline = time.monotonic() + window_s
                while not early_exit.is_set():
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    early_exit.wait(min(remaining, window_s / 4))
                    if remaining > window_s / 4:
                        self._record_queue_depth(self._metrics_snapshot(),
                                                 queue_depths,
                                                 gen_queue_depths)
        window_end = time.monotonic_ns()

        server_after = self._server_stats_snapshot()
        metrics_after = self._metrics_snapshot()
        self._record_queue_depth(metrics_after, queue_depths,
                                 gen_queue_depths)
        stat_after = self.manager.accumulated_client_stat()
        timestamps = self.manager.swap_timestamps()
        status = self._summarize(timestamps, window_start, window_end,
                                 server_before, server_after,
                                 stat_before, stat_after)
        status.metrics = self._metrics_delta(metrics_before, metrics_after,
                                             queue_depths, status.window_s,
                                             gen_queue_depths)
        if swap_gen is not None:
            ttft_ns, itl_ns, tokens = swap_gen()
            status.generation = self._generation_stats(
                ttft_ns, itl_ns, tokens, status.window_s)
        status.slowest_requests = self._slowest_requests(
            self._server_traces_snapshot(), window_start, window_end,
            metrics_after)
        return status

    def _generation_stats(self, ttft_ns: list, itl_ns: list, tokens: int,
                          window_s: float) -> GenerationClientStats:
        out = GenerationClientStats()
        if not ttft_ns and not tokens:
            return out
        out.enabled = True
        out.request_count = len(ttft_ns)
        out.token_count = tokens
        out.tokens_per_sec = tokens / window_s if window_s > 0 else 0.0

        def pcts(ns_list):
            us = sorted(v / 1e3 for v in ns_list)
            n = len(us)
            table = {p: us[min(n - 1, max(0, math.ceil(p / 100 * n) - 1))]
                     for p in self.GENERATION_PERCENTILES}
            return sum(us) / n, table

        if ttft_ns:
            out.ttft_avg_us, out.ttft_percentiles_us = pcts(ttft_ns)
        if itl_ns:
            out.itl_avg_us, out.itl_percentiles_us = pcts(itl_ns)
        return out

    # ---- slowest-request breakdown (trace <-> exemplar join) ----

    # duration-span name -> breakdown bucket (the queue/prefill/
    # handoff/decode/fetch shares report.py renders)
    _BREAKDOWN_SPANS = {
        "QUEUE_WAIT": "queue_us",
        "PREFILL_CHUNK": "prefill_us",
        "LANE_HANDOFF": "handoff_us",
        "DECODE": "decode_us",
        "RING_DELIVER": "fetch_us",
    }
    SLOWEST_REQUEST_COUNT = 5

    def _server_traces_snapshot(self) -> Optional[list]:
        if not self.include_server_stats:
            return None
        try:
            return self.backend.server_traces()
        except Exception:  # noqa: BLE001 — the plane is optional
            return None

    def _newest_incident(self) -> Optional[dict]:
        """Newest incident bundle of the profiled model from the debug
        incident plane (None when the plane is off — the metrics-side
        counter deltas still carry the gate; the bundle only adds the
        incident id worth quoting in the violation)."""
        try:
            doc = self.backend.server_incidents()
        except Exception:  # noqa: BLE001 — the plane is optional
            return None
        newest = None
        for m in (doc or {}).get("models", []):
            if m.get("model") != self.parser.model_name:
                continue
            for inc in (m.get("incidents") or {}).get("incidents") or []:
                if newest is None or inc.get("ns", 0) >= newest.get(
                        "ns", 0):
                    newest = inc
        return newest

    def _slowest_requests(self, traces: Optional[list],
                          window_start: int, window_end: int,
                          metrics_after: Optional[dict]) -> list:
        """Join scraped server traces with the window: one row per
        traced request with its phase split (queue/prefill/handoff/
        decode/fetch, from the dur_ns span records), the routing
        decision (FLEET_ROUTE leg + replica), and whether the
        trace-id also appeared in the scraped /metrics exemplars —
        the link from a bad histogram bucket back to a concrete
        request. In-process backends share the monotonic clock, so
        rows filter to the measurement window; over the network the
        clock domains differ, so when NO trace lands inside the
        window the filter is skipped (newest completed traces win)
        rather than silently dropping everything."""
        if not traces:
            return []
        exemplar_ids = set()
        if metrics_after:
            for _fam, _labels, ex in metrics_after.get("exemplars", []):
                tid = (ex.get("labels") or {}).get("trace_id")
                if tid:
                    exemplar_ids.add(tid)
        rows = []
        for tr in traces:
            stamps = tr.get("timestamps") or []
            spans = [s for s in stamps
                     if isinstance(s.get("ns"), (int, float))]
            if not spans:
                continue
            t0 = min(s["ns"] for s in spans)
            t1 = max(s["ns"] + s.get("dur_ns", 0) for s in spans)
            row = {"trace_id": tr.get("id", ""),
                   "total_us": (t1 - t0) / 1e3,
                   "queue_us": 0.0, "prefill_us": 0.0,
                   "handoff_us": 0.0, "decode_us": 0.0,
                   "fetch_us": 0.0, "replica": None, "route_leg": "",
                   "in_window": t1 >= window_start
                   and t0 <= window_end,
                   "in_exemplars": tr.get("id", "") in exemplar_ids}
            for s in spans:
                field = self._BREAKDOWN_SPANS.get(s.get("name"))
                if field is not None and "dur_ns" in s:
                    row[field] += s["dur_ns"] / 1e3
                elif s.get("name") == "FLEET_ROUTE":
                    row["replica"] = s.get("replica")
                    row["route_leg"] = s.get("leg", "")
            rows.append(row)
        if any(r["in_window"] for r in rows):
            rows = [r for r in rows if r["in_window"]]
        rows.sort(key=lambda r: r["total_us"], reverse=True)
        return rows[:self.SLOWEST_REQUEST_COUNT]

    # ---- /metrics scrape ----

    def _metrics_snapshot(self) -> Optional[dict]:
        if not self.include_server_stats:
            return None
        try:
            return self.backend.server_metrics()
        except Exception:  # noqa: BLE001 — the plane is optional
            return None

    def _metric_sum(self, parsed: dict, name: str,
                    match: Optional[dict] = None) -> float:
        """Sum samples of one family across versions of the profiled
        model (unlabeled families sum their single sample); ``match``
        restricts to samples whose labels equal every given value
        (per-phase counter deltas, per-(tenant, slo_class) rows)."""
        total = 0.0
        for n, labels, v in parsed.get("samples", []):
            if n != name:
                continue
            if match and any(labels.get(k) != mv
                             for k, mv in match.items()):
                continue
            if "model" in labels \
                    and labels["model"] != self.parser.model_name:
                continue
            total += v
        return total

    def _record_queue_depth(self, parsed: Optional[dict],
                            samples: list,
                            gen_samples: Optional[list] = None) -> None:
        """One periodic queue-depth sample: scheduler depth into
        ``samples`` (p50/max summarized at window end) and, when a
        list is given, the generation engine's pending-slot depth
        into ``gen_samples`` — both gauges drain fast relative to a
        window, so endpoint scrapes alone under-observe them (the
        prefill-share starvation gate keys on the window MAX)."""
        if parsed is not None:
            samples.append(self._metric_sum(parsed,
                                            "client_tpu_queue_depth"))
            if gen_samples is not None:
                gen_samples.append(self._metric_sum(
                    parsed, "client_tpu_generation_queue_depth"))

    def _metrics_delta(self, before: Optional[dict], after: Optional[dict],
                       queue_depths: list, window_s: float,
                       gen_queue_depths: Optional[list] = None
                       ) -> ServerMetricsStats:
        out = ServerMetricsStats()
        if before is None or after is None:
            return out
        out.scraped = True
        if queue_depths:
            depths = sorted(queue_depths)
            out.queue_depth_p50 = depths[len(depths) // 2]
            out.queue_depth_max = depths[-1]

        def delta(name):
            return self._metric_sum(after, name) \
                - self._metric_sum(before, name)

        if window_s > 0:
            out.batches_per_sec = \
                delta("client_tpu_inference_exec_count_total") / window_s
            out.inferences_per_sec = \
                delta("client_tpu_inference_count_total") / window_s
        out.cache_hits = int(delta("client_tpu_cache_hits_total"))
        out.cache_misses = int(delta("client_tpu_cache_misses_total"))
        # token-generation families: present only for engine-backed models
        slots = self._metric_sum(after, "client_tpu_generation_slots")
        if slots > 0 and window_s > 0:
            out.generation_scraped = True
            out.generation_tokens_per_sec = \
                delta("client_tpu_generation_tokens_total") / window_s
            out.generation_slot_occupancy = min(1.0, max(0.0, (
                delta("client_tpu_generation_slot_busy_seconds")
                / (slots * window_s))))
            # engine phase split: per-phase deltas of the labeled
            # wall-seconds counter (retire share is the regression axis)
            phase_name = "client_tpu_generation_engine_phase_seconds"
            for phase in set(
                    labels.get("phase") for n, labels, _v
                    in after.get("samples", []) if n == phase_name):
                if phase is None:
                    continue
                d = (self._metric_sum(after, phase_name,
                                      {"phase": phase})
                     - self._metric_sum(before, phase_name,
                                        {"phase": phase}))
                if d > 0:
                    out.engine_phase_s[phase] = d
            out.generation_chunks = int(delta(
                "client_tpu_generation_chunks_total"))
            out.ring_fetches = int(delta(
                "client_tpu_generation_ring_fetches_total"))
            out.ring_forced_fetches = int(delta(
                "client_tpu_generation_ring_forced_fetches_total"))
            out.ring_lag_chunks = self._metric_sum(
                after, "client_tpu_generation_ring_lag_chunks")
            out.ring_fetch_stride = self._metric_sum(
                after, "client_tpu_generation_ring_fetch_stride")
            # chunked-prefill lane counters (absent families delta to
            # 0 — only prefill_mode="chunked" engines export them) and
            # the pending-queue gauge the prefill-share gate reads —
            # the MAX over the window's periodic samples, so the
            # starvation signal does not hinge on whether the queue
            # happened to drain just before the end-of-window scrape
            out.prefill_tokens = int(delta(
                "client_tpu_generation_prefill_tokens_total"))
            out.prefill_chunks = int(delta(
                "client_tpu_generation_prefill_chunks_total"))
            out.generation_queue_depth = max(
                [self._metric_sum(
                    after, "client_tpu_generation_queue_depth")]
                + list(gen_queue_depths or ()))
        # dedicated-prefill-lane families: exported only when the
        # engine runs a dedicated prefill slot set (the slots gauge
        # doubles as the presence signal)
        if self._metric_sum(
                after, "client_tpu_generation_prefill_lane_slots") > 0:
            out.lane_scraped = True
            out.lane_slots = self._metric_sum(
                after, "client_tpu_generation_prefill_lane_slots")
            out.lane_active = self._metric_sum(
                after, "client_tpu_generation_prefill_lane_active")
            out.lane_handoffs = int(delta(
                "client_tpu_generation_prefill_lane_handoffs_total"))
        # host-tier families: exported only when the host-RAM prefix
        # tier is armed (the spills counter doubles as the presence
        # signal — the blocks gauge may legitimately read 0)
        if any(n == "client_tpu_generation_tier_spills_total"
               for n, _l, _v in after.get("samples", [])):
            out.tier_scraped = True
            out.tier_blocks = self._metric_sum(
                after, "client_tpu_generation_tier_blocks")
            out.tier_spills = int(delta(
                "client_tpu_generation_tier_spills_total"))
            out.tier_restores = int(delta(
                "client_tpu_generation_tier_restores_total"))
            out.tier_hits = int(delta(
                "client_tpu_generation_tier_hits_total"))
        # prefix-cache families: exported only when the KV block pool
        # runs (the capacity gauge doubles as the presence signal)
        if self._metric_sum(
                after, "client_tpu_generation_prefix_cache_blocks") > 0:
            out.prefix_cache_scraped = True
            out.prefix_hits = int(delta(
                "client_tpu_generation_prefix_cache_hits_total"))
            out.prefix_misses = int(delta(
                "client_tpu_generation_prefix_cache_misses_total"))
            out.prefix_saved_tokens = int(delta(
                "client_tpu_generation_prefix_cache_saved_tokens_total"))
            out.prefix_evictions = int(delta(
                "client_tpu_generation_prefix_cache_evictions_total"))
            out.prefix_blocks_used = int(self._metric_sum(
                after, "client_tpu_generation_prefix_cache_blocks_used"))
        # speculation families: exported only when a draft model runs
        # (the rounds counter doubles as the presence signal)
        if any(n == "client_tpu_generation_spec_rounds_total"
               for n, _l, _v in after.get("samples", [])):
            out.spec_scraped = True
            out.spec_proposed = int(delta(
                "client_tpu_generation_spec_proposed_total"))
            out.spec_accepted = int(delta(
                "client_tpu_generation_spec_accepted_total"))
            out.spec_rejected = int(delta(
                "client_tpu_generation_spec_rejected_total"))
            out.spec_rounds = int(delta(
                "client_tpu_generation_spec_rounds_total"))
            # a rate gauge must be averaged, not summed: multiple
            # versions of the profiled model each export one
            rates = [v for n, labels, v in after.get("samples", [])
                     if n == "client_tpu_generation_spec_acceptance_rate"
                     and labels.get("model",
                                    self.parser.model_name)
                     == self.parser.model_name]
            out.spec_acceptance_gauge = (sum(rates) / len(rates)
                                         if rates else 0.0)
        # per-tenant SLO families: present when the profiled model
        # carries the SLO stats plane (the windowed-quantile gauge
        # doubles as the presence signal). Quantiles/burn are gauges
        # read at window end; sheds/requests are window deltas — the
        # per-tenant extension of the client/server reject split.
        lat_name = "client_tpu_slo_window_latency_seconds"
        slo_keys = sorted({
            (labels.get("tenant", ""), labels.get("slo_class", ""))
            for n, labels, _v in after.get("samples", [])
            if n == lat_name
            and labels.get("model", self.parser.model_name)
            == self.parser.model_name})
        if slo_keys:
            out.slo_scraped = True
            for tenant, slo_class in slo_keys:
                m = {"tenant": tenant, "slo_class": slo_class}
                row = {"burn_rate": self._metric_sum(
                    after, "client_tpu_slo_error_budget_burn_rate", m)}
                for kind in ("ttft", "inter_token", "queue_wait"):
                    for q in ("p50", "p95", "p99"):
                        row[f"{kind}_{q}_s"] = self._metric_sum(
                            after, lat_name,
                            {**m, "kind": kind, "quantile": q})
                for field, fam in (
                        ("shed", "client_tpu_slo_shed_total"),
                        ("requests", "client_tpu_slo_requests_total"),
                        ("admitted", "client_tpu_slo_admitted_total"),
                        ("failures", "client_tpu_slo_failures_total")):
                    row[field] = int(self._metric_sum(after, fam, m)
                                     - self._metric_sum(before, fam, m))
                out.slo_tenants[(tenant, slo_class)] = row
        # closed-loop scheduler families: present only when the engine
        # runs the SLO scheduler (the always-registered fetch-stride
        # knob gauge doubles as the presence signal)
        if any(n == "client_tpu_sched_fetch_stride"
               for n, _l, _v in after.get("samples", [])):
            out.sched_scraped = True
            out.sched_preemptions = int(delta(
                "client_tpu_sched_preemptions_total"))
            out.sched_resumes = int(delta(
                "client_tpu_sched_resumes_total"))
            out.sched_queue_depth = self._metric_sum(
                after, "client_tpu_sched_fair_queue_depth")
            out.sched_prefill_budget = self._metric_sum(
                after, "client_tpu_sched_prefill_token_budget")
            out.sched_fetch_stride = self._metric_sum(
                after, "client_tpu_sched_fetch_stride")
            out.sched_dispatch_duty = self._metric_sum(
                after, "client_tpu_sched_dispatch_duty")
            out.sched_spec_enabled = self._metric_sum(
                after, "client_tpu_sched_spec_enabled")
        # replica-fleet families: present only when the model runs a
        # ReplicaFleet (the replicas cap gauge doubles as the
        # presence signal). Per-replica rows sum scrape-side: the
        # report reads fleet-wide traffic, the per-replica split
        # stays on /metrics and /v2/debug/fleet.
        if self._metric_sum(after, "client_tpu_fleet_replicas") > 0:
            out.fleet_scraped = True
            out.fleet_replicas = self._metric_sum(
                after, "client_tpu_fleet_replicas")
            out.fleet_healthy = self._metric_sum(
                after, "client_tpu_fleet_healthy")
            out.fleet_queue_depth = self._metric_sum(
                after, "client_tpu_fleet_queue_depth")
            out.fleet_routed = int(delta(
                "client_tpu_fleet_routed_total"))
            out.fleet_rerouted = int(delta(
                "client_tpu_fleet_rerouted_total"))
            out.fleet_affinity_hits = int(delta(
                "client_tpu_fleet_affinity_hits_total"))
            out.fleet_drains = int(delta(
                "client_tpu_fleet_drains_total"))
        # goodput families: present when an engine carries the
        # device-time attribution tracker (the dispatches counter
        # doubles as the presence signal). Per-kind columns are window
        # deltas keyed by the kernel label; the share the gate reads
        # is recomputed from the window's FLOP deltas scrape-side.
        gp_name = "client_tpu_goodput_dispatches_total"
        gp_kinds = sorted({
            labels.get("kernel") for n, labels, _v
            in after.get("samples", [])
            if n == gp_name and labels.get("kernel")})
        if gp_kinds:
            out.goodput_scraped = True
            for kind in gp_kinds:
                m = {"kernel": kind}
                d = self._metric_sum(after, gp_name, m) \
                    - self._metric_sum(before, gp_name, m)
                if d > 0:
                    out.goodput_dispatches[kind] = int(d)
                d = (self._metric_sum(
                        after, "client_tpu_goodput_device_seconds_total",
                        m)
                     - self._metric_sum(
                        before,
                        "client_tpu_goodput_device_seconds_total", m))
                if d > 0:
                    out.goodput_device_s[kind] = d
                d = (self._metric_sum(
                        after, "client_tpu_goodput_useful_flops_total",
                        m)
                     - self._metric_sum(
                        before,
                        "client_tpu_goodput_useful_flops_total", m))
                if d > 0:
                    out.goodput_kind_useful_flops[kind] = d
            out.goodput_useful_flops = max(0.0, delta(
                "client_tpu_goodput_useful_flops_total"))
            out.goodput_wasted_flops = max(0.0, delta(
                "client_tpu_goodput_wasted_flops_total"))
            out.goodput_sampling_share = self._metric_sum(
                after, "client_tpu_goodput_sampling_share")
            # MFU needs a known peak denominator: on the CPU the gauge
            # is absent
            out.goodput_mfu_present = any(
                n == "client_tpu_goodput_mfu"
                for n, _l, _v in after.get("samples", []))
            if out.goodput_mfu_present:
                out.goodput_mfu = self._metric_sum(
                    after, "client_tpu_goodput_mfu")
        # watchdog families: present when the profiled model runs the
        # incident plane (the samples counter doubles as the presence
        # signal). Per-detector incident deltas feed the opt-in
        # --fail-on-incident gate and the report's Watchdog block.
        wd_name = "client_tpu_watchdog_incidents_total"
        if any(n == "client_tpu_watchdog_samples_total"
               for n, _l, _v in after.get("samples", [])):
            out.watchdog_scraped = True
            out.watchdog_samples = int(delta(
                "client_tpu_watchdog_samples_total"))
            for det in sorted({
                    labels.get("detector") for n, labels, _v
                    in after.get("samples", [])
                    if n == wd_name and labels.get("detector")}):
                m = {"detector": det}
                d = int(self._metric_sum(after, wd_name, m)
                        - self._metric_sum(before, wd_name, m))
                if d > 0:
                    out.watchdog_incidents[det] = d
            out.watchdog_ring_depth = self._metric_sum(
                after, "client_tpu_watchdog_incident_ring_depth")
        # runtime families: present when a served model carries a
        # compile set (the compiles counter doubles as the signal)
        if any(n == "client_tpu_runtime_compiles_total"
               for n, _l, _v in after.get("samples", [])):
            out.runtime_scraped = True
            out.runtime_compiles = int(delta(
                "client_tpu_runtime_compiles_total"))
            out.runtime_unexpected_compiles = int(delta(
                "client_tpu_runtime_unexpected_compiles_total"))
            # warmup cost is absolute at window end (warmup precedes
            # every window; a nonzero DELTA would be a restart)
            out.runtime_warmup_compiles = int(self._metric_sum(
                after, "client_tpu_runtime_warmup_compiles_total"))
            out.runtime_warmup_compile_s = self._metric_sum(
                after, "client_tpu_runtime_warmup_compile_seconds_total")
            # memory gauges carry (device, kind) labels, no model label —
            # sum per kind across devices at window end
            for n, labels, v in after.get("samples", []):
                if n == "client_tpu_runtime_model_memory_bytes":
                    # paged-pool attribution split rides the component
                    # label (kv_pool_live/prefix/free) — summed over
                    # models at window end, 0 for slot-layout engines
                    comp = labels.get("component")
                    if comp == "kv_pool_live":
                        out.hbm_pool_live_bytes += v
                    elif comp == "kv_pool_prefix":
                        out.hbm_pool_prefix_bytes += v
                    elif comp == "kv_pool_free":
                        out.hbm_pool_free_bytes += v
                    continue
                if n != "client_tpu_runtime_device_memory_bytes":
                    continue
                if labels.get("kind") == "in_use":
                    out.hbm_bytes_in_use += v
                elif labels.get("kind") == "limit":
                    out.hbm_bytes_limit += v
        return out

    def _server_stats_snapshot(self) -> Optional[dict]:
        if not self.include_server_stats:
            return None
        try:
            snap = {}
            names = [(self.parser.model_name, self.parser.model_version)]
            names += self.parser.composing_models
            for name, version in names:
                stats = self.backend.model_inference_statistics(name,
                                                                version)
                for m in stats.get("model_stats", []):
                    snap[(m["name"], m.get("version", ""))] = m
            return snap
        except Exception:  # noqa: BLE001 — the plane is optional
            return None

    # ---- summarization ----

    def _summarize(self, timestamps, window_start, window_end,
                   server_before, server_after,
                   stat_before, stat_after) -> PerfStatus:
        status = PerfStatus()
        window_ns = window_end - window_start
        status.window_s = window_ns / 1e9

        valid_lat_us = []
        valid = 0
        seq_ends = 0
        delayed = 0
        for (start, end, seq_end, was_delayed) in timestamps:
            if start < window_start or end > window_end:
                continue  # only requests fully inside the window
            if was_delayed:
                delayed += 1
                continue  # excluded from rate conclusions
            valid += 1
            if seq_end:
                seq_ends += 1
            valid_lat_us.append((end - start) / 1e3)

        status.valid_count = valid
        status.delayed_count = delayed
        status.client_infer_per_sec = \
            valid * self.manager.batch_size / status.window_s
        status.client_sequence_per_sec = seq_ends / status.window_s
        status.latency = self._latency_stats(valid_lat_us)

        status.client_rejected_count = (
            stat_after.rejected_request_count
            - stat_before.rejected_request_count)
        status.client_retried_count = (
            stat_after.retried_request_count
            - stat_before.retried_request_count)
        dreq = (stat_after.completed_request_count
                - stat_before.completed_request_count)
        dtime = (stat_after.cumulative_total_request_time_ns
                 - stat_before.cumulative_total_request_time_ns)
        status.avg_request_time_us = (dtime / dreq / 1e3) if dreq else 0.0

        if server_before is not None and server_after is not None:
            status.server = self._server_delta(server_before, server_after)
        return status

    def _latency_stats(self, lat_us: list) -> LatencyStats:
        if not lat_us:
            return LatencyStats()
        lat = sorted(lat_us)
        n = len(lat)
        avg = sum(lat) / n
        std = math.sqrt(sum((x - avg) ** 2 for x in lat) / n) if n > 1 else 0
        pct = {}
        for p in self.percentiles:
            idx = min(n - 1, max(0, math.ceil(p / 100 * n) - 1))
            pct[p] = lat[idx]
        return LatencyStats(avg_us=avg, std_us=std, min_us=lat[0],
                            max_us=lat[-1], percentiles_us=pct)

    def _server_delta(self, before: dict, after: dict) -> ServerSideStats:
        main_key = next(
            (k for k in after if k[0] == self.parser.model_name), None)
        out = self._delta_one(before.get(main_key, {}),
                              after.get(main_key, {})) \
            if main_key else ServerSideStats()
        for (name, version) in self.parser.composing_models:
            key = next((k for k in after if k[0] == name), None)
            if key:
                out.composing_models[name] = self._delta_one(
                    before.get(key, {}), after.get(key, {}))
        return out

    @staticmethod
    def _delta_one(before: dict, after: dict) -> ServerSideStats:
        def num(container, field):
            # proto JSON renders (u)int64 as strings — coerce
            return int(container.get(field, 0) or 0)

        def d(path, field="count"):
            b = before.get("inference_stats", {}).get(path, {})
            a = after.get("inference_stats", {}).get(path, {})
            return num(a, field) - num(b, field)

        s = ServerSideStats()
        s.inference_count = (num(after, "inference_count")
                             - num(before, "inference_count"))
        s.execution_count = (num(after, "execution_count")
                             - num(before, "execution_count"))
        s.success_count = d("success")
        s.queue_count = d("queue")
        for name, attr in (("queue", "queue_time_us"),
                           ("compute_input", "compute_input_time_us"),
                           ("compute_infer", "compute_infer_time_us"),
                           ("compute_output", "compute_output_time_us")):
            cnt = d(name)
            ns = d(name, "ns")
            setattr(s, attr, (ns / cnt / 1e3) if cnt else 0.0)
        s.cache_hit_count = d("cache_hit")
        s.cache_hit_time_us = (d("cache_hit", "ns") / s.cache_hit_count / 1e3
                               if s.cache_hit_count else 0.0)
        s.cache_miss_count = d("cache_miss")
        s.cache_miss_time_us = (
            d("cache_miss", "ns") / s.cache_miss_count / 1e3
            if s.cache_miss_count else 0.0)
        s.rejected_count = d("rejected")
        return s
