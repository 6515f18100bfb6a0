"""InferenceProfiler — search driver + measurement + stabilization: the
port's copy of ``client_tpu/perf/inference_profiler.py``.

- Linear/binary/none search over concurrency.
- A sliding stability window of 3 measurements: BOTH infer/sec and
  latency within ±stability of the window average, an optional latency
  threshold early-break, a max_trials cap.
- ``measure()``: server-stats snapshot deltas around a time- or
  count-based window.
- Valid-latency filtering: only requests fully inside the measurement
  window count; sequences are counted on sequence_end; schedule-delayed
  requests are excluded from rate math.

The reference's metrics-plane parts (``ServerMetricsStats``, the
per-window metric deltas, the window-violation gates that read them,
traces and incidents) wait for ROADMAP A13c; the server's ``/metrics``
they read is ported. Where the backend has no metrics plane they report
nothing: a
status carries no metrics field rather than zeros. The request-rate
search waits with the request-rate manager.
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
    generation: GenerationClientStats = dataclasses.field(
        default_factory=GenerationClientStats)
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
                 include_server_stats: bool = True):
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
        stat_before = self.manager.accumulated_client_stat()
        swap_gen = getattr(self.manager, "swap_generation_samples", None)
        if swap_gen is not None:
            swap_gen()  # discard pre-window token samples

        window_start = time.monotonic_ns()
        if self.mode == "count_windows":
            deadline = time.monotonic() + 10 * self.window_ms / 1e3
            base = self.manager.count_collected_requests()
            while self.manager.count_collected_requests() - base \
                    < self.request_count and time.monotonic() < deadline \
                    and not early_exit.is_set():
                time.sleep(0.01)
        else:
            # Event.wait returns as soon as SIGINT fires, cutting the
            # window short instead of sleeping through it
            early_exit.wait(self.window_ms / 1e3)
        window_end = time.monotonic_ns()

        server_after = self._server_stats_snapshot()
        stat_after = self.manager.accumulated_client_stat()
        timestamps = self.manager.swap_timestamps()
        status = self._summarize(timestamps, window_start, window_end,
                                 server_before, server_after,
                                 stat_before, stat_after)
        if swap_gen is not None:
            ttft_ns, itl_ns, tokens = swap_gen()
            status.generation = self._generation_stats(
                ttft_ns, itl_ns, tokens, status.window_s)
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
