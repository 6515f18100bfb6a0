"""Open-loop request-rate load managers: the port's copy of
``client_tpu/perf/request_rate_manager.py``.

A nanosecond schedule is precomputed (Poisson exponential gaps or
constant gaps, or replayed from a user intervals file); worker threads
stride through it, sleep until each slot, and mark requests that start
late as ``delayed`` so the profiler can exclude them from rate
conclusions.
"""

from __future__ import annotations

import random
import threading
import time

from client_tpu_torch.perf.load_manager import LoadManager, ThreadStat
from client_tpu_torch.perf.perf_utils import (
    early_exit,
    is_admission_rejection,
)

DELAY_THRESHOLD_NS = 10_000_000  # late by >10ms => delayed
MAX_WORKER_THREADS = 16


class RequestRateManager(LoadManager):
    def __init__(self, *args, distribution: str = "constant",
                 max_threads: int = MAX_WORKER_THREADS, **kwargs):
        super().__init__(*args, **kwargs)
        self.distribution = distribution
        self.max_threads = max_threads
        self.schedule: list[int] = []
        self.gen_duration_ns = 0

    # ---- schedule ----

    def generate_schedule(self, request_rate: float,
                          duration_s: float = 1.0, seed: int = 0) -> None:
        """Precompute offsets covering max(2x window, 1s)."""
        if request_rate <= 0:
            raise ValueError("request rate must be positive")
        self.gen_duration_ns = int(max(2 * duration_s, 1.0) * 1e9)
        rng = random.Random(seed)
        gap_mean = 1e9 / request_rate
        self.schedule = []
        t = 0.0
        while t < self.gen_duration_ns:
            if self.distribution == "poisson":
                t += rng.expovariate(1.0 / gap_mean)
            else:
                t += gap_mean
            self.schedule.append(int(t))

    def change_request_rate(self, request_rate: float,
                            duration_s: float = 1.0) -> None:
        self.stop_worker_threads()
        self._stop = threading.Event()
        self.generate_schedule(request_rate, duration_s)
        self._spawn_workers()

    def _spawn_workers(self) -> None:
        n_threads = min(self.max_threads, max(1, len(self.schedule)))
        for i in range(n_threads):
            stat = ThreadStat()
            self.thread_stats.append(stat)
            t = threading.Thread(
                target=self._worker, args=(stat, i, n_threads),
                daemon=True, name=f"perf-rate-{i}")
            self.threads.append(t)
            t.start()

    # ---- worker ----

    def _worker(self, stat: ThreadStat, offset: int, stride: int) -> None:
        try:
            backend = self.factory.create()
        except Exception as e:  # noqa: BLE001
            with stat.lock:
                stat.error = f"{type(e).__name__}: {e}"
            return
        try:
            self._run(backend, stat, offset, stride)
        except Exception as e:  # noqa: BLE001
            with stat.lock:
                stat.error = f"{type(e).__name__}: {e}"
        finally:
            if self.parser.is_sequence():
                self.drain_sequences(backend, stat)
            try:
                backend.close()
            except Exception:  # noqa: BLE001
                pass

    def _run(self, backend, stat: ThreadStat, offset: int,
             stride: int) -> None:
        start_time = time.monotonic_ns()
        index = offset
        step = 0
        inflight = [0]
        cv = threading.Condition()

        while not self._stop.is_set() and not early_exit.is_set():
            sched = self.schedule[index % len(self.schedule)]
            wrap = (index // len(self.schedule)) * self.gen_duration_ns
            target = start_time + wrap + sched
            index += stride
            now = time.monotonic_ns()
            if target > now:
                time.sleep((target - now) / 1e9)
                if self._stop.is_set() or early_exit.is_set():
                    break
            delayed = time.monotonic_ns() > target + DELAY_THRESHOLD_NS

            stream, opts = self._issue_options(step)
            inputs = self.prepare_inputs(stream, step)
            outputs = self.prepare_outputs()
            step += 1
            start = time.monotonic_ns()
            seq_end = opts.get("sequence_end", False)

            if self.async_mode:
                def cb(result, error, start=start, seq_end=seq_end,
                       delayed=delayed):
                    end = time.monotonic_ns()
                    with stat.lock:
                        if error is not None:
                            # sheds count, except on sequence workloads
                            # (state already advanced — desync risk)
                            if is_admission_rejection(error) \
                                    and not self.parser.is_sequence():
                                stat.stat.rejected_request_count += 1
                            else:
                                stat.error = str(error)
                        else:
                            stat.timestamps.append(
                                (start, end, seq_end, delayed))
                            stat.stat.completed_request_count += 1
                            stat.stat.cumulative_total_request_time_ns += \
                                end - start
                    with cv:
                        inflight[0] -= 1
                        cv.notify()

                with cv:
                    inflight[0] += 1
                backend.async_infer(cb, self.parser.model_name, inputs,
                                    outputs, **opts)
            else:
                err = None
                try:
                    backend.infer(self.parser.model_name, inputs, outputs,
                                  **opts)
                except Exception as e:  # noqa: BLE001
                    err = e
                end = time.monotonic_ns()
                with stat.lock:
                    if err is not None:
                        if is_admission_rejection(err) \
                                and not self.parser.is_sequence():
                            stat.stat.rejected_request_count += 1
                            continue
                        stat.error = f"{type(err).__name__}: {err}"
                        return
                    stat.timestamps.append((start, end, seq_end, delayed))
                    stat.stat.completed_request_count += 1
                    stat.stat.cumulative_total_request_time_ns += end - start
        with cv:
            cv.wait_for(lambda: inflight[0] == 0, timeout=30)

    def _issue_options(self, step: int) -> tuple:
        opts = {}
        if self.parser.is_sequence():
            slot = step % len(self.sequence_stats)
            seq = self.sequence_stats[slot]
            with seq.lock:
                opts = self.sequence_options(slot)
                stream = seq.data_stream
        else:
            # rotate multi-stream data across requests (single-stream
            # loaders reduce to the old always-stream-0 behavior)
            stream = step % max(1, self.data.num_streams)
        return stream, opts


class CustomLoadManager(RequestRateManager):
    """Replays a user-supplied inter-request intervals file
    (``--request-intervals``)."""

    def __init__(self, *args, intervals_file: str = "", **kwargs):
        super().__init__(*args, **kwargs)
        self.intervals_file = intervals_file

    def init_custom_intervals(self) -> None:
        """File format: one interval per line, nanoseconds."""
        intervals = []
        with open(self.intervals_file) as f:
            for line in f:
                line = line.strip()
                if line:
                    intervals.append(int(line))
        if not intervals:
            raise ValueError(f"{self.intervals_file}: no intervals")
        self.schedule = []
        t = 0
        for gap in intervals:
            t += gap
            self.schedule.append(t)
        self.gen_duration_ns = t

    def custom_request_rate(self) -> float:
        """1 / mean interval."""
        if not self.schedule:
            self.init_custom_intervals()
        return 1e9 * len(self.schedule) / self.gen_duration_ns

    def start(self) -> None:
        self.stop_worker_threads()
        self._stop = threading.Event()
        if not self.schedule:
            self.init_custom_intervals()
        self._spawn_workers()
