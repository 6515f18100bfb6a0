"""Request schedulers: direct, dynamic-batching and sequence.

The port's counterpart of ``client_tpu/server/scheduler.py``. The dynamic
batcher pads every batch to a static bucket size
(``ModelConfig.batch_buckets()``), keeps up to ``pipeline_depth`` batches
in flight on the card and completes them on a pool of workers, each
waiting on its batch's CUDA event. Timing is split as the v2 statistics
extension expects: queue (enqueue -> pickup), compute_input (assembly +
H2D), compute_infer (dispatch -> outputs in host memory), compute_output
(split + deliver).

A decoupled model runs on the direct scheduler: ``_execute_one`` sends one
response per item of ``model.stream`` and then an empty response flagged
``triton_final_response``. A model whose ``stream`` takes a ``context``
gets the request's ``StreamContext``: the wire ``timeout`` as an absolute
deadline, the front end's cancel Event and the SLO labels.

Two places of the reference are tied to JAX and become torch checks here:
the device pipeline serves ``TorchModel`` (not ``JaxModel``), and inputs
already on the model's device are recognised as torch tensors (the core
has checked that a tensor input lives on the model's device). When every
request of such a batch directs every output into a shared-memory
region, the batch takes the pre-split path: one forward, per-row views of
the outputs, one CUDA event for the whole batch, and no output leaves the
device. A traced request (``Pending.trace``) gets the compute spans on
every path (COMPUTE_START, COMPUTE_INPUT_END, COMPUTE_OUTPUT_START), and a
decoupled one FIRST_TOKEN at its first response and TOKEN_EMIT every
``TOKEN_EMIT_SAMPLE_EVERY``-th.

The sequence scheduler keys a stateful model's requests by correlation
id: each live sequence holds its state (a ``SequenceModel``'s tensors on
the model's device) and a lock that serialises its requests, and up to
``instance_count`` sequences run at once.
"""

from __future__ import annotations

import collections
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from client_tpu_torch.device import wire_dtype_of
from client_tpu_torch.protocol.dtypes import np_to_wire_dtype
from client_tpu_torch.server import trace as trace_mod
from client_tpu_torch.server.model import (
    SequenceModel,
    ServedModel,
    StreamContext,
    TorchModel,
    accepts_stream_context,
    finish_host_copies,
    start_host_copies,
)
from client_tpu_torch.server.stats import ModelStats
from client_tpu_torch.server.types import (
    InferRequest,
    InferResponse,
    InferTensor,
    ServerError,
    now_ns,
)

ResponseCallback = Callable[[InferResponse, bool], None]

log = logging.getLogger(__name__)


class Pending:
    __slots__ = ("request", "send", "enqueue_ns", "inputs", "bs", "sig",
                 "trace")

    def __init__(self, request: InferRequest, send: ResponseCallback,
                 inputs: dict, trace=None):
        self.request = request
        self.send = send
        self.enqueue_ns = now_ns()
        self.inputs = inputs  # name -> np.ndarray or torch.Tensor
        self.bs = (request.inputs[0].batch_size() if request.inputs else 1)
        self.sig = None       # batch-compat signature, set at submit
        self.trace = trace    # the sampled Trace or None (the core's)


def _error_response(req: InferRequest, msg: str, status: int = 400,
                    retry_after: float | None = None):
    return InferResponse(model_name=req.model_name,
                         model_version=req.model_version, id=req.id,
                         error=msg, error_status=status,
                         retry_after_s=retry_after)


def _success_response(req: InferRequest, outputs: dict,
                      version: str) -> InferResponse:
    out_tensors = []
    for name, arr in outputs.items():
        arr = np.asarray(arr)
        out_tensors.append(InferTensor(
            name=name, datatype=np_to_wire_dtype(arr.dtype),
            shape=tuple(arr.shape), data=arr))
    return InferResponse(model_name=req.model_name, model_version=version,
                         id=req.id, outputs=out_tensors)


def _queue_limit_ns(config_timeout_ns: int, qp, pending: Pending) -> int:
    """Effective queue deadline for one request: the config default
    (zero unless the policy's action is REJECT), tightened by the
    request's own wire ``timeout`` parameter under a REJECT policy."""
    limit = config_timeout_ns
    if qp is not None and qp.timeout_action == "REJECT" \
            and pending.request.timeout_us:
        req_ns = pending.request.timeout_us * 1000
        limit = min(limit, req_ns) if limit else req_ns
    return limit


def _is_device_tensor(v) -> bool:
    return isinstance(v, torch.Tensor)


class SchedulerBase:
    def __init__(self, model: ServedModel, stats: ModelStats, version: str):
        self.model = model
        self.stats = stats
        self.version = version
        self._stopped = False
        # decided once: a model whose stream() takes one argument keeps
        # working
        self._stream_takes_context = (model.config.decoupled
                                      and accepts_stream_context(model.stream))

    def submit(self, pending: Pending) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        self._stopped = True

    def queue_depth(self) -> int:
        """Requests accepted but not yet picked up for execution."""
        return 0

    def inflight(self) -> int:
        """Executions dispatched and not yet completed."""
        return 0

    def _shed(self, pending: Pending, reason: str) -> None:
        """Admission-control rejection: count it and answer 503 at once,
        with a Retry-After hint."""
        self.stats.record_rejection(now_ns() - pending.enqueue_ns)
        pending.send(_error_response(
            pending.request,
            f"request was rejected: {reason} for model "
            f"'{self.model.name}'", 503, retry_after=1.0), True)

    def _execute_one(self, pending: Pending) -> None:
        """Unbatched execution of a single request (direct / decoupled)."""
        req = pending.request
        pickup = now_ns()
        queue_ns = pickup - pending.enqueue_ns
        tr = pending.trace
        try:
            if self.model.config.decoupled:
                # one response per streamed item, then the final flag
                t0 = now_ns()
                if tr is not None:
                    tr.event(trace_mod.COMPUTE_START, pickup)
                    tr.event(trace_mod.COMPUTE_INPUT_END, t0)
                if self._stream_takes_context:
                    # the wire timeout becomes the stream's absolute
                    # deadline, which the engine enforces per dispatch; the
                    # cancel Event is set by the front end
                    deadline_ns = (req.arrival_ns + req.timeout_us * 1000
                                   if req.timeout_us else 0)
                    stream = self.model.stream(
                        pending.inputs,
                        context=StreamContext(
                            trace=tr, enqueue_ns=pending.enqueue_ns,
                            tenant_id=req.tenant_id,
                            slo_class=req.slo_class,
                            deadline_ns=deadline_ns,
                            cancel_event=req.cancel_event))
                else:
                    stream = self.model.stream(pending.inputs)
                n = 0
                for outputs in stream:
                    n += 1
                    if tr is not None:
                        # the first response is the TTFT boundary; later
                        # ones are sampled, so a trace's cost does not grow
                        # with the stream
                        if n == 1:
                            tr.event(trace_mod.FIRST_TOKEN)
                        elif n % trace_mod.TOKEN_EMIT_SAMPLE_EVERY == 0:
                            tr.event(trace_mod.TOKEN_EMIT)
                    pending.send(
                        _success_response(req, outputs, self.version), False)
                if tr is not None:
                    tr.event(trace_mod.COMPUTE_OUTPUT_START)
                pending.send(InferResponse(
                    model_name=req.model_name, model_version=self.version,
                    id=req.id, parameters={"triton_final_response": True}),
                    True)
                t1 = now_ns()
                self.stats.record_execution(
                    batch_size=max(1, req.inputs[0].batch_size()
                                   if req.inputs else 1),
                    num_requests=1, queue_ns_per_request=[queue_ns],
                    compute_input_ns=0, compute_infer_ns=t1 - t0,
                    compute_output_ns=0,
                    request_total_ns_each=[t1 - pending.enqueue_ns])
                return
            t0 = now_ns()
            if tr is not None:
                tr.event(trace_mod.COMPUTE_START, pickup)
            if isinstance(self.model, TorchModel):
                dev_in = self.model.device_put_inputs(pending.inputs)
                t1 = now_ns()
                if tr is not None:
                    tr.event(trace_mod.COMPUTE_INPUT_END, t1)
                outputs = finish_host_copies(start_host_copies(
                    self.model.execute_on_device(dev_in)))
            else:
                t1 = t0
                if tr is not None:
                    tr.event(trace_mod.COMPUTE_INPUT_END, t0)
                outputs = self.model.execute(pending.inputs)
            t2 = now_ns()
            if tr is not None:
                tr.event(trace_mod.COMPUTE_OUTPUT_START, t2)
            pending.send(_success_response(req, outputs, self.version), True)
            bs = req.inputs[0].batch_size() if (
                req.inputs and self.model.config.max_batch_size > 0) else 1
            self.stats.record_execution(
                batch_size=bs, num_requests=1,
                queue_ns_per_request=[queue_ns], compute_input_ns=t1 - t0,
                compute_infer_ns=t2 - t1, compute_output_ns=now_ns() - t2,
                request_total_ns_each=[now_ns() - pending.enqueue_ns])
        except ServerError as e:
            self.stats.record_failure(now_ns() - pending.enqueue_ns)
            pending.send(_error_response(req, str(e), e.status,
                                         retry_after=e.retry_after), True)
        except Exception as e:  # noqa: BLE001 — model errors become responses
            self.stats.record_failure(now_ns() - pending.enqueue_ns)
            pending.send(_error_response(
                req, f"{type(e).__name__}: {e}", 500), True)


class DirectScheduler(SchedulerBase):
    """No batching: bounded instance concurrency, caller-thread execution.
    With a queue policy, requests beyond ``max_queue_size`` waiters are
    shed at once (503) instead of stacking up on the instance semaphore."""

    def __init__(self, model, stats, version):
        super().__init__(model, stats, version)
        self._instances = max(1, model.config.instance_count)
        self._sem = threading.Semaphore(self._instances)
        self._qp = model.config.queue_policy
        self._timeout_ns = (
            self._qp.default_timeout_microseconds * 1000
            if self._qp and self._qp.timeout_action == "REJECT" else 0)
        self._waiting = 0
        self._wlock = threading.Lock()

    def queue_depth(self) -> int:
        return self._waiting

    def inflight(self) -> int:
        return max(0, self._instances - self._sem._value)

    def submit(self, pending: Pending) -> None:
        if self._qp is not None and self._qp.max_queue_size > 0:
            with self._wlock:
                if self._waiting >= self._qp.max_queue_size:
                    self._shed(pending,
                               f"exceeds maximum queue size "
                               f"{self._qp.max_queue_size}")
                    return
                self._waiting += 1
        else:
            with self._wlock:
                self._waiting += 1
        try:
            self._sem.acquire()
        finally:
            with self._wlock:
                self._waiting -= 1
        try:
            limit = _queue_limit_ns(self._timeout_ns, self._qp, pending)
            if limit:
                waited = now_ns() - pending.enqueue_ns
                if waited > limit:
                    self._shed(pending,
                               f"timed out in queue after "
                               f"{waited // 1000} us")
                    return
            self._execute_one(pending)
        finally:
            self._sem.release()


class DynamicBatchScheduler(SchedulerBase):
    """Queue + dispatcher forming padded static-bucket batches, with an
    in-flight pipeline on the card and overlapped completions.

    - ONE dispatcher thread (per instance) gathers a batch, assembles it,
      launches its forward and hands it to a completion worker; up to
      ``dynamic_batching.pipeline_depth`` batches are in flight, so host
      work on one batch overlaps the card's work on the others.
    - Each completion worker waits on its batch's CUDA event (the outputs
      have landed in pinned host memory), then splits and delivers.
    - Host inputs are packed row-wise into a preallocated per-bucket
      buffer that travels with the batch and is recycled at completion,
      then copied to the card at once; inputs already on the device are
      concatenated there.
    - Single-row device inputs whose outputs all go to shared-memory
      regions take the pre-split path (``_complete_split``).
    """

    def __init__(self, model, stats, version):
        super().__init__(model, stats, version)
        cfg = model.config
        db = cfg.dynamic_batching
        self.max_batch = cfg.max_batch_size
        self.buckets = cfg.batch_buckets()
        self.max_delay_ns = (db.max_queue_delay_microseconds * 1000
                             if db else 0)
        self.preferred = sorted(db.preferred_batch_size) if (
            db and db.preferred_batch_size) else []
        self.depth = max(1, getattr(db, "pipeline_depth", 8) or 1)
        self._qp = (db.default_queue_policy if db and db.default_queue_policy
                    else cfg.queue_policy)
        self._queue_timeout_ns = (
            self._qp.default_timeout_microseconds * 1000
            if self._qp and self._qp.timeout_action == "REJECT" else 0)
        # MPMC hand-off without a mutex on the hot path: deque append/
        # popleft are GIL-atomic. The Event only parks an idle dispatcher;
        # the append -> is_set order in submit() vs the clear -> re-check
        # order in _pop_blocking() makes lost wakeups impossible.
        self._dq: collections.deque = collections.deque()
        self._wake = threading.Event()
        self._threads = []
        self._on_card = isinstance(model, TorchModel)
        self._inflight = threading.BoundedSemaphore(self.depth)
        self._host_inflight = 0
        self._host_lock = threading.Lock()
        self._completion_pool = None
        self._ring: dict = {}        # (bucket, sig) -> [free host buffers]
        self._ring_lock = threading.Lock()
        if self._on_card:
            self._completion_pool = ThreadPoolExecutor(
                max_workers=self.depth,
                thread_name_prefix=f"batcher-complete-{cfg.name}")
        for i in range(max(1, cfg.instance_count)):
            t = threading.Thread(target=self._loop, daemon=True,
                                 name=f"batcher-{cfg.name}-{i}")
            t.start()
            self._threads.append(t)

    def queue_depth(self) -> int:
        return len(self._dq)

    def inflight(self) -> int:
        if not self._on_card:
            return self._host_inflight
        return max(0, self.depth - self._inflight._value)

    def submit(self, pending: Pending) -> None:
        if pending.bs > self.max_batch:
            pending.send(_error_response(
                pending.request,
                f"request batch size {pending.bs} exceeds max_batch_size "
                f"{self.max_batch}"), True)
            return
        if self._qp is not None and self._qp.max_queue_size > 0 \
                and len(self._dq) >= self._qp.max_queue_size:
            self._shed(pending, f"exceeds maximum queue size "
                                f"{self._qp.max_queue_size}")
            return
        pending.sig = self._signature(pending)
        self._dq.append(pending)
        if not self._wake.is_set():
            self._wake.set()

    def stop(self) -> None:
        super().stop()
        for _ in self._threads:
            self._dq.append(None)
        self._wake.set()
        stragglers = []
        for t in self._threads:
            t.join(timeout=30)
            if t.is_alive():
                stragglers.append(t)
        if self._completion_pool is not None:
            # runs every submitted completion to its end, then rejects new
            # work (a straggler dispatcher gets a RuntimeError, which
            # _run_batch turns into error responses)
            self._completion_pool.shutdown(wait=not stragglers)

    # -- dispatcher --

    @staticmethod
    def _signature(pending: Pending):
        def dt(v):
            return str(v.dtype) if hasattr(v, "dtype") else "O"

        return tuple(sorted(
            (k, dt(v), _is_device_tensor(v), tuple(v.shape[1:]))
            for k, v in pending.inputs.items()))

    def _reject_expired(self, pending: Pending) -> bool:
        """Queue-timeout policy (REJECT action): shed a request that has
        waited past its queue deadline instead of executing it late."""
        limit = _queue_limit_ns(self._queue_timeout_ns, self._qp, pending)
        if not limit:
            return False
        waited = now_ns() - pending.enqueue_ns
        if waited <= limit:
            return False
        self._shed(pending, f"timed out in queue after {waited // 1000} us")
        return True

    def _pop_blocking(self) -> Optional[Pending]:
        """Blocking dequeue. None means a stop sentinel was consumed."""
        dq = self._dq
        while True:
            try:
                item = dq.popleft()
            except IndexError:
                self._wake.clear()
                if dq:  # re-check closes the clear/append race
                    continue
                self._wake.wait(timeout=1.0)
                continue
            if item is not None and self._reject_expired(item):
                continue
            return item

    def _gather(self, first: Pending) -> list:
        """Collect a batch: same signature, up to max_batch, waiting at most
        max_queue_delay for a preferred size. Queue order is preserved —
        an incompatible request goes back to the FRONT of the deque."""
        batch = [first]
        total = first.bs
        sig = first.sig
        deadline = now_ns() + self.max_delay_ns
        target = next((p for p in self.preferred if p >= total),
                      self.max_batch)
        dq = self._dq
        while total < target:
            try:
                nxt = dq.popleft()
            except IndexError:
                remaining = (deadline - now_ns()) / 1e9
                if remaining <= 0:
                    break
                self._wake.clear()
                if dq:
                    continue
                self._wake.wait(timeout=min(remaining, 1.0))
                continue
            if nxt is None:
                dq.appendleft(None)  # leave the sentinel for a peer
                self._wake.set()
                break
            if self._reject_expired(nxt):
                continue
            if nxt.sig != sig or total + nxt.bs > self.max_batch:
                dq.appendleft(nxt)
                self._wake.set()     # wake a parked peer dispatcher
                break  # flush the current batch first
            batch.append(nxt)
            total += nxt.bs
        return batch

    def _loop(self) -> None:
        while True:
            first = self._pop_blocking()
            if first is None:
                return
            batch = self._gather(first)
            try:
                self._run_batch(batch)
            except Exception:  # noqa: BLE001 — keep the dispatcher alive
                log.exception(
                    "batch execution failed for model '%s' version %s "
                    "(batch of %d request(s) answered with errors)",
                    self.model.name, self.version, len(batch))

    # -- batch assembly --

    def _acquire_slot(self, bucket: int, sig, template: dict):
        """Preallocated host buffers for one batch (recycled on
        completion; the in-flight semaphore bounds how many exist)."""
        key = (bucket, sig)
        with self._ring_lock:
            free = self._ring.get(key)
            if free:
                return key, free.pop()
        slot = {name: np.empty((bucket,) + tuple(arr.shape[1:]), arr.dtype)
                for name, arr in template.items()}
        return key, slot

    def _release_slot(self, key, slot) -> None:
        with self._ring_lock:
            self._ring.setdefault(key, []).append(slot)

    def _assemble_host(self, batch: list, sizes: list, total: int,
                       bucket: int):
        """Host-side batch assembly. Returns (inputs, slot_key, slot)."""
        names = list(batch[0].inputs.keys())
        if not self._on_card:
            # host models may return (views of) their input buffers, so no
            # recycling here — fresh buffers per batch
            slot_key, slot = None, None
            assembled = {
                name: np.empty((bucket,) + tuple(
                    batch[0].inputs[name].shape[1:]),
                    batch[0].inputs[name].dtype)
                for name in names}
        else:
            slot_key, slot = self._acquire_slot(bucket, batch[0].sig,
                                                batch[0].inputs)
            assembled = slot
        for name in names:
            buf = assembled[name]
            off = 0
            for p, bs in zip(batch, sizes):
                buf[off:off + bs] = p.inputs[name]
                off += bs
            if bucket > total:
                buf[total:bucket] = 0
        return assembled, slot_key, slot

    def _run_batch(self, batch: list) -> None:
        sizes = [p.bs for p in batch]
        total = sum(sizes)
        bucket = next((b for b in self.buckets if b >= total), self.max_batch)
        slot_key = slot = None
        acquired = False
        try:
            if self._on_card:
                # pipeline backpressure (waiting for an in-flight slot) is
                # QUEUE time, not input-processing time — acquire before
                # stamping the pickup so the stats attribute it correctly
                self._inflight.acquire()
                acquired = True
            pickup = now_ns()
            queue_ns = [pickup - p.enqueue_ns for p in batch]
            t0 = pickup
            if self._on_card and all(_is_device_tensor(v)
                                     for v in batch[0].inputs.values()):
                # inputs already on the device (shared-memory regions):
                # assembly is a concatenation there, and no host transfer
                # happens
                parts = [p.inputs for p in batch]
                all_single = all(s == 1 for s in sizes)
                if all_single and self._all_outputs_shm(batch):
                    # outputs never leave the device: pre-split rows and
                    # one event for the batch instead of a slab fetch
                    t1 = now_ns()
                    split, event = self.model.execute_parts_fused_split(
                        parts, bucket)
                    self._completion_pool.submit(
                        self._complete_split, batch, total, queue_ns, t0,
                        t1, split, event)
                    return
                t1 = now_ns()
                if all_single:
                    dev_out = self.model.execute_parts_fused(parts, bucket)
                else:
                    dev_out = self.model.execute_parts_ragged(parts, bucket)
                copies = start_host_copies(dev_out)
                self._completion_pool.submit(
                    self._complete, batch, sizes, total, queue_ns, t0, t1,
                    copies, None, None)
                return
            host_in, slot_key, slot = self._assemble_host(batch, sizes,
                                                          total, bucket)
            if self._on_card:
                dev_in = self.model.device_put_inputs(host_in)
                t1 = now_ns()
                copies = start_host_copies(
                    self.model.execute_on_device(dev_in))
                self._completion_pool.submit(
                    self._complete, batch, sizes, total, queue_ns, t0, t1,
                    copies, slot_key, slot)
                return
            t1 = now_ns()
            with self._host_lock:
                self._host_inflight += 1
            try:
                outputs = self.model.execute(host_in)
            finally:
                with self._host_lock:
                    self._host_inflight -= 1
            self._deliver(batch, sizes, total, queue_ns, t0, t1, now_ns(),
                          outputs)
        except Exception as e:  # noqa: BLE001 — batch failure -> per-request errors
            if acquired:
                self._inflight.release()
            if slot is not None:
                self._release_slot(slot_key, slot)
            for p in batch:
                self.stats.record_failure(now_ns() - p.enqueue_ns)
                p.send(_error_response(
                    p.request, f"{type(e).__name__}: {e}", 500), True)

    @staticmethod
    def _stamp_compute_spans(batch: list, t0: int, t1: int, t2: int) -> None:
        """The compute spans of a batch's traced requests: pickup
        (COMPUTE_START), batch assembly and H2D done (COMPUTE_INPUT_END),
        the outputs ready and their delivery starting
        (COMPUTE_OUTPUT_START)."""
        for p in batch:
            tr = p.trace
            if tr is not None:
                tr.event(trace_mod.COMPUTE_START, t0)
                tr.event(trace_mod.COMPUTE_INPUT_END, t1)
                tr.event(trace_mod.COMPUTE_OUTPUT_START, t2)

    @staticmethod
    def _all_outputs_shm(batch: list) -> bool:
        """True when every request directs every requested output into a
        shared-memory region (so no output data needs to ride a
        response)."""
        for p in batch:
            outs = p.request.outputs
            if not outs:
                return False
            for o in outs:
                if o.shm_region is None:
                    return False
        return True

    # -- completion worker (pool) --

    def _complete_split(self, batch, total, queue_ns, t0, t1, split,
                        event) -> None:
        """Completion of the shm-output path: the batch's one CUDA event
        confirms the whole batch; the outputs stay on the device."""
        try:
            if event is not None:
                event.synchronize()
            # the in-flight slot is held through the delivery below (the
            # reference's pacing rule): released right after the wait, the
            # dispatcher runs ahead of the closed-loop client refill and
            # forms underfilled padded batches
            t2 = now_ns()
            self._stamp_compute_spans(batch, t0, t1, t2)
            # per-output wire metadata is the same for every row: once per
            # batch, not once per request
            metas = [(name, wire_dtype_of(rows[0]), tuple(rows[0].shape),
                      rows) for name, rows in split.items()]
            version = self.version
            for i, p in enumerate(batch):
                req = p.request
                p.send(InferResponse(
                    model_name=req.model_name, model_version=version,
                    id=req.id,
                    outputs=[InferTensor(name=n, datatype=dt, shape=shp,
                                         data=rows[i])
                             for (n, dt, shp, rows) in metas]), True)
            t3 = now_ns()
            self.stats.record_execution(
                batch_size=total, num_requests=len(batch),
                queue_ns_per_request=queue_ns,
                compute_input_ns=t1 - t0, compute_infer_ns=t2 - t1,
                compute_output_ns=t3 - t2,
                request_total_ns_each=[t3 - p.enqueue_ns for p in batch])
        except Exception as e:  # noqa: BLE001
            for p in batch:
                self.stats.record_failure(now_ns() - p.enqueue_ns)
                p.send(_error_response(
                    p.request, f"{type(e).__name__}: {e}", 500), True)
        finally:
            self._inflight.release()

    def _complete(self, batch, sizes, total, queue_ns, t0, t1, copies,
                  slot_key, slot) -> None:
        try:
            # the batch's CUDA event: the forward ran and its outputs are
            # in pinned host memory
            outputs = finish_host_copies(copies)
            self._deliver(batch, sizes, total, queue_ns, t0, t1, now_ns(),
                          outputs)
        except Exception as e:  # noqa: BLE001
            for p in batch:
                self.stats.record_failure(now_ns() - p.enqueue_ns)
                p.send(_error_response(
                    p.request, f"{type(e).__name__}: {e}", 500), True)
        finally:
            if slot is not None:
                self._release_slot(slot_key, slot)
            self._inflight.release()

    def _deliver(self, batch, sizes, total, queue_ns, t0, t1, t2,
                 outputs) -> None:
        self._stamp_compute_spans(batch, t0, t1, t2)
        # compute_output: split rows back per request + deliver
        off = 0
        for p, bs in zip(batch, sizes):
            sliced = {k: v[off:off + bs] for k, v in outputs.items()}
            p.send(_success_response(p.request, sliced, self.version), True)
            off += bs
        t3 = now_ns()
        self.stats.record_execution(
            batch_size=total, num_requests=len(batch),
            queue_ns_per_request=queue_ns,
            compute_input_ns=t1 - t0, compute_infer_ns=t2 - t1,
            compute_output_ns=t3 - t2,
            request_total_ns_each=[t3 - p.enqueue_ns for p in batch])


class SequenceScheduler(SchedulerBase):
    """Correlation-id-keyed stateful execution (the reference's
    ``SequenceScheduler``).

    Each live sequence owns a state (a ``SequenceModel``'s, on its
    device) and a lock serialising its requests; distinct sequences run
    concurrently up to ``instance_count``. A request without a
    correlation id, or opening an unknown id without START, is a 400; a
    START past ``max_candidate_sequences`` live ones is a 503 with a
    Retry-After hint; a START on a live id gives it a fresh state; END
    releases it; a sequence idle longer than
    ``max_sequence_idle_microseconds`` is dropped at the next submit."""

    class _Seq:
        __slots__ = ("state", "lock", "last_ns")

        def __init__(self, state):
            self.state = state
            self.lock = threading.Lock()
            self.last_ns = now_ns()

    def __init__(self, model, stats, version):
        super().__init__(model, stats, version)
        self._instances = max(1, model.config.instance_count)
        self._sem = threading.Semaphore(self._instances)
        self._sequences: dict = {}
        self._map_lock = threading.Lock()
        sb = model.config.sequence_batching
        self.max_idle_ns = (sb.max_sequence_idle_microseconds * 1000
                            if sb else 10**15)
        self.max_candidates = sb.max_candidate_sequences if sb else 1024

    def live_sequences(self) -> int:
        with self._map_lock:
            return len(self._sequences)

    def inflight(self) -> int:
        return max(0, self._instances - self._sem._value)

    def _evict_idle(self) -> None:
        cutoff = now_ns() - self.max_idle_ns
        with self._map_lock:
            dead = [k for k, s in self._sequences.items() if s.last_ns < cutoff]
            for k in dead:
                del self._sequences[k]

    def _init_state(self):
        return (self.model.init_state()
                if isinstance(self.model, SequenceModel) else None)

    def submit(self, pending: Pending) -> None:
        req = pending.request
        corr = req.sequence_id
        if not corr:
            pending.send(_error_response(
                req, "sequence model requires a correlation id"), True)
            return
        self._evict_idle()
        with self._map_lock:
            seq = self._sequences.get(corr)
            if seq is None:
                if not req.sequence_start:
                    pending.send(_error_response(
                        req, f"sequence {corr} has no START request"), True)
                    return
                if len(self._sequences) >= self.max_candidates:
                    pending.send(_error_response(
                        req, "max_candidate_sequences exceeded", 503,
                        retry_after=1.0), True)
                    return
                seq = self._Seq(self._init_state())
                self._sequences[corr] = seq
            elif req.sequence_start:
                # fresh tensors: a step writes its state in place, so the
                # old ones are never reused
                seq.state = self._init_state()
        with seq.lock, self._sem:
            pickup = now_ns()
            queue_ns = pickup - pending.enqueue_ns
            tr = pending.trace
            try:
                if tr is not None:
                    tr.event(trace_mod.COMPUTE_START, pickup)
                    tr.event(trace_mod.COMPUTE_INPUT_END, pickup)
                if isinstance(self.model, SequenceModel):
                    outputs, new_state = self.model.step(pending.inputs,
                                                         seq.state)
                    seq.state = new_state
                else:
                    outputs = self.model.execute(pending.inputs)
                seq.last_ns = now_ns()
                if tr is not None:
                    tr.event(trace_mod.COMPUTE_OUTPUT_START, seq.last_ns)
                pending.send(_success_response(req, outputs, self.version),
                             True)
                total = now_ns() - pending.enqueue_ns
                self.stats.record_execution(
                    batch_size=1, num_requests=1,
                    queue_ns_per_request=[queue_ns], compute_input_ns=0,
                    compute_infer_ns=total - queue_ns, compute_output_ns=0,
                    request_total_ns_each=[total])
            except Exception as e:  # noqa: BLE001
                self.stats.record_failure(now_ns() - pending.enqueue_ns)
                pending.send(_error_response(
                    req, f"{type(e).__name__}: {e}", 500), True)
        if req.sequence_end:
            with self._map_lock:
                self._sequences.pop(corr, None)


def make_scheduler(model: ServedModel, stats: ModelStats,
                   version: str) -> SchedulerBase:
    cfg = model.config
    if cfg.sequence_batching is not None or isinstance(model, SequenceModel):
        return SequenceScheduler(model, stats, version)
    if cfg.decoupled:
        return DirectScheduler(model, stats, version)
    if cfg.max_batch_size > 0 and cfg.dynamic_batching is not None:
        return DynamicBatchScheduler(model, stats, version)
    return DirectScheduler(model, stats, version)
