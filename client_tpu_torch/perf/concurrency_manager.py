"""Closed-loop concurrency load manager: the port's copy of
``client_tpu/perf/concurrency_manager.py``.

Hold N outstanding requests: async mode keeps a window of in-flight
async calls per thread (at most ``max_threads`` threads), sync mode runs
one blocking loop per concurrency slot, streaming mode keeps a window of
requests on one stream per thread.
"""

from __future__ import annotations

import threading
import time

from client_tpu_torch.perf.load_manager import LoadManager, ThreadStat
from client_tpu_torch.perf.perf_utils import early_exit, is_admission_rejection

MAX_WORKER_THREADS = 16


class ConcurrencyManager(LoadManager):
    def __init__(self, *args, max_threads: int = MAX_WORKER_THREADS,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.max_threads = max_threads
        self._concurrency = 0

    def change_concurrency_level(self, concurrency: int) -> None:
        """Re-spawn workers at the new level."""
        self.stop_worker_threads()
        self._stop = threading.Event()
        self._concurrency = concurrency
        if concurrency == 0:
            return
        if self.async_mode:
            n_threads = min(self.max_threads, concurrency)
        else:
            n_threads = concurrency  # one blocking loop per slot
        share = concurrency // n_threads
        extra = concurrency % n_threads
        for i in range(n_threads):
            slots = share + (1 if i < extra else 0)
            if slots == 0:
                continue
            stat = ThreadStat()
            self.thread_stats.append(stat)
            t = threading.Thread(
                target=self._worker, args=(stat, slots, i),
                daemon=True, name=f"perf-conc-{i}")
            self.threads.append(t)
            t.start()

    # ---- worker ----

    def _worker(self, stat: ThreadStat, slots: int, widx: int) -> None:
        try:
            backend = self.factory.create()
        except Exception as e:  # noqa: BLE001
            with stat.lock:
                stat.error = f"{type(e).__name__}: {e}"
            return
        try:
            if self.streaming:
                self._worker_streaming(backend, stat, slots)
            elif self.async_mode:
                self._worker_async(backend, stat, slots)
            else:
                self._worker_sync(backend, stat, widx)
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

    def _issue_options(self, ctx_slot: int) -> tuple:
        """(stream, step-advance handled by caller, options)."""
        opts = {}
        if self.parser.is_sequence():
            slot = ctx_slot % len(self.sequence_stats)
            seq = self.sequence_stats[slot]
            with seq.lock:
                opts = self.sequence_options(slot)
                stream = seq.data_stream
        else:
            # rotate multi-stream data across requests (single-stream
            # loaders reduce to the old always-stream-0 behavior) — the
            # shared-prefix workload depends on cycling its per-stream
            # suffixes
            stream = ctx_slot % max(1, self.data.num_streams)
        return stream, opts

    def _worker_sync(self, backend, stat: ThreadStat, widx: int) -> None:
        step = 0
        while not self._stop.is_set() and not early_exit.is_set():
            # sequences keep per-worker slot affinity (widx); plain
            # requests rotate streams per request like the async and
            # streaming workers do (their counters advance per issue)
            stream, opts = self._issue_options(
                widx if self.parser.is_sequence() else step)
            inputs = self.prepare_inputs(stream, step)
            outputs = self.prepare_outputs()
            start = time.monotonic_ns()
            err = None
            try:
                backend.infer(self.parser.model_name, inputs, outputs,
                              **opts)
            except Exception as e:  # noqa: BLE001
                err = e
            end = time.monotonic_ns()
            shed = False
            with stat.lock:
                if err is not None:
                    # a shed (503/UNAVAILABLE) is load-test DATA, not a
                    # worker-fatal failure: count it and keep driving.
                    # EXCEPT for sequence workloads: the slot's sequence
                    # state already advanced, so a swallowed shed would
                    # silently desync start/end accounting — keep it
                    # fatal there.
                    if is_admission_rejection(err) \
                            and not self.parser.is_sequence():
                        stat.stat.rejected_request_count += 1
                        shed = True
                    else:
                        stat.error = f"{type(err).__name__}: {err}"
                        return
                else:
                    stat.timestamps.append(
                        (start, end, opts.get("sequence_end", False),
                         False))
                    stat.stat.completed_request_count += 1
                    stat.stat.cumulative_total_request_time_ns += \
                        end - start
            if shed:
                # brief backoff: an instant reissue after a shed makes
                # the closed loop spin on 503s, burning the host CPU
                # the server needs to actually serve
                time.sleep(0.002)
            step += 1

    def _worker_async(self, backend, stat: ThreadStat, slots: int) -> None:
        inflight = [0]
        cv = threading.Condition()
        step = [0]
        shed_recently = [False]

        def issue():
            stream, opts = self._issue_options(step[0])
            inputs = self.prepare_inputs(stream, step[0])
            outputs = self.prepare_outputs()
            start = time.monotonic_ns()
            seq_end = opts.get("sequence_end", False)

            def cb(result, error):
                end = time.monotonic_ns()
                with stat.lock:
                    if error is not None:
                        if is_admission_rejection(error) \
                                and not self.parser.is_sequence():
                            stat.stat.rejected_request_count += 1
                            shed_recently[0] = True
                        else:
                            stat.error = str(error)
                    else:
                        stat.timestamps.append((start, end, seq_end, False))
                        stat.stat.completed_request_count += 1
                        stat.stat.cumulative_total_request_time_ns += \
                            end - start
                with cv:
                    inflight[0] -= 1
                    cv.notify()

            backend.async_infer(cb, self.parser.model_name, inputs,
                                outputs, **opts)
            step[0] += 1

        while not self._stop.is_set() and not early_exit.is_set():
            with cv:
                while inflight[0] >= slots and not self._stop.is_set() \
                        and not early_exit.is_set():
                    cv.wait(timeout=0.1)
                if self._stop.is_set() or early_exit.is_set():
                    break
                inflight[0] += 1
            if shed_recently[0]:
                # same anti-spin backoff as the sync path: shed slots
                # free instantly, so an unpaced refill loop would hammer
                # the server with 503-speed reissues
                shed_recently[0] = False
                time.sleep(0.002)
            try:
                issue()
            except Exception as e:  # noqa: BLE001
                with cv:
                    inflight[0] -= 1
                with stat.lock:
                    stat.error = f"{type(e).__name__}: {e}"
                return
        # drain
        with cv:
            cv.wait_for(lambda: inflight[0] == 0, timeout=30)

    def _worker_streaming(self, backend, stat: ThreadStat,
                          slots: int) -> None:
        """A bidirectional stream: responses arrive on the stream
        callback (the backend's ``start_stream``).

        Against a decoupled model every request yields N token responses
        followed by a ``triton_final_response``-flagged close; the worker
        records the client-observed token series per request — TTFT
        (issue to first token) and per-token inter-token gaps — on top of
        the end-to-end timestamp the final response completes."""
        inflight = [0]
        cv = threading.Condition()
        # key -> [start_ns, seq_end, first_token_ns|None, last_ns, tokens]
        pending: dict[str, list] = {}
        plock = threading.Lock()
        rid = [0]
        decoupled = self.parser.decoupled

        def cb(result, error):
            end = time.monotonic_ns()
            key = None
            if result is not None:
                try:
                    resp = result.get_response()
                    # proto message or dict depending on the client
                    key = resp["id"] if isinstance(resp, dict) \
                        else getattr(resp, "id", None)
                except Exception:  # noqa: BLE001
                    key = None
            final = True if error is not None or not decoupled \
                else _is_final_stream_response(result)
            with plock:
                rec = pending.get(key) if key is not None else None
                if rec is None and pending:
                    key = next(iter(pending))
                    rec = pending[key]
                if rec is not None and final:
                    pending.pop(key, None)
            if rec is None:
                rec = [end, False, None, end, 0]
            if error is None and decoupled and not final:
                # one streamed token: the stream's reader delivers
                # callbacks serially, so rec mutation is race-free
                with stat.lock:
                    if rec[2] is None:
                        rec[2] = end
                        stat.ttft_ns.append(end - rec[0])
                    else:
                        stat.itl_ns.append(end - rec[3])
                    rec[3] = end
                    rec[4] += 1
                    stat.token_count += 1
                return  # request still in flight until the final response
            start, seq_end = rec[0], rec[1]
            with stat.lock:
                if error is not None:
                    if is_admission_rejection(error) \
                            and not self.parser.is_sequence():
                        stat.stat.rejected_request_count += 1
                    else:
                        stat.error = str(error)
                else:
                    stat.timestamps.append((start, end, seq_end, False))
                    stat.stat.completed_request_count += 1
                    stat.stat.cumulative_total_request_time_ns += end - start
            with cv:
                inflight[0] -= 1
                cv.notify()

        backend.start_stream(cb)
        try:
            while not self._stop.is_set() and not early_exit.is_set():
                with cv:
                    while inflight[0] >= slots and not self._stop.is_set() \
                            and not early_exit.is_set():
                        cv.wait(timeout=0.1)
                    if self._stop.is_set() or early_exit.is_set():
                        break
                    inflight[0] += 1
                stream, opts = self._issue_options(rid[0])
                inputs = self.prepare_inputs(stream, rid[0])
                outputs = self.prepare_outputs()
                rid[0] += 1
                key = f"s{id(stat)}_{rid[0]}"
                with plock:
                    pending[key] = [time.monotonic_ns(),
                                    opts.get("sequence_end", False),
                                    None, 0, 0]
                backend.async_stream_infer(
                    self.parser.model_name, inputs, outputs,
                    request_id=key, **opts)
            with cv:
                cv.wait_for(lambda: inflight[0] == 0, timeout=30)
        finally:
            backend.stop_stream()


def _is_final_stream_response(result) -> bool:
    """True when a streamed response carries the decoupled close flag
    (``triton_final_response``); token responses do not."""
    try:
        resp = result.get_response()
    except Exception:  # noqa: BLE001
        return True
    if isinstance(resp, dict):
        v = (resp.get("parameters") or {}).get("triton_final_response",
                                               False)
        if isinstance(v, dict):  # proto-JSON renders the oneof as a dict
            v = v.get("bool_param", False)
        return bool(v)
    params = getattr(resp, "parameters", None)
    if params is not None and "triton_final_response" in params:
        return bool(params["triton_final_response"].bool_param)
    return False
