"""Served model abstractions: the port's counterpart of
``client_tpu/server/model.py``.

A ServedModel executes one *batch*: ``dict[name -> array] ->
dict[name -> array]``. Batching/padding policy lives in the scheduler;
models only ever see the bucket shapes the scheduler pads to.

TorchModel is the device path (the counterpart of the reference's
JaxModel): parameters become resident on the model's device at load(),
inputs are copied in per call (or arrive as device tensors), and outputs
come back through pinned host memory guarded by a CUDA event, or, on the
shm-output path (``execute_parts_fused_split``), stay on the device as
per-row views of the batch's own output slab.

The compile plane (``server/runtime_stats.py``): the forward's three
entry points are watched by the reference's names, ``apply``,
``fused_batch`` and ``fused_batch_split``, and on the card they run as
CUDA graphs per bucket, captured at their first call (``warmup`` captures
every bucket, then seals the set; the two fused kinds replay one graph
per bucket, and each kind's first call is recorded). The dynamic batch's
parts are concatenated outside the graph, straight into its static input
slab, and every replay's outputs are copied out of the graph's static
output slab under the watch's graph lock: the next replay overwrites
that slab while earlier batches are still in flight. ``execute_parts_ragged`` stays
unwatched and eager, as the reference's ``_assemble_jit`` stays
unwatched. Under a mesh, and on the CPU, the entry points are watched and
run eagerly. ``runtime_observability`` gives the compile snapshot and the
weights' bytes.

A TorchModel over a ``mesh`` (``parallel.mesh.make_mesh``) is sharded
over one process per device, PyTorch's tensor-parallel serving idiom
(``parallel/spmd.py``): every rank builds it with the same arguments,
``param_sharding`` (a spec tree, ``transformer.param_specs`` for the
transformer) cuts each rank's block of the weights, and rank 0, the
driver, serves it behind the core. Each forward on rank 0 broadcasts a
plan and the whole batch over the model's own process group; every rank
runs ``apply_fn`` on its dp block (``input_sharding``, e.g. ``("dp",
None)``) with ``mesh=``, and returns outputs that are whole but for the
batch dim, which is all-gathered over the input's batch axis. The other
ranks run ``follow()`` until rank 0 unloads the model.

SequenceModel, a TorchModel, is the stateful model the sequence scheduler
drives: an explicit state (``init_state()``, ``step(inputs, state) -> (outputs,
state)``) that stays on the model's device between requests.
"""

from __future__ import annotations

import inspect
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from client_tpu_torch.device import resolve_device
from client_tpu_torch.protocol.dtypes import wire_to_np_dtype
from client_tpu_torch.server.config import ModelConfig
from client_tpu_torch.server.runtime_stats import (
    CompileWatch,
    GraphCapture,
    capture_inputs,
    clone_outputs,
    pytree_nbytes,
)
from client_tpu_torch.server.types import DEFAULT_SLO_CLASS, DEFAULT_TENANT


def start_host_copies(dev_out: dict) -> tuple:
    """Start the device->host copies of every output: a non-blocking copy
    of each CUDA tensor into pinned host memory, then one CUDA event
    recorded behind them on the current stream. Returns ``(host, event)``
    — CPU tensors already in host memory pass through, and ``event`` is
    None when nothing was on the card. ``finish_host_copies`` waits on the
    event and hands back numpy arrays."""
    host = {}
    card = None
    for name, t in dev_out.items():
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            host[name] = buf
            card = t.device
        else:
            host[name] = t
    event = None
    if card is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(card))
    return host, event


def finish_host_copies(copies: tuple) -> dict:
    """Wait for ``start_host_copies``' event; return numpy outputs."""
    host, event = copies
    if event is not None:
        event.synchronize()
    return {name: t.numpy() for name, t in host.items()}


def _host_tensor(arr) -> torch.Tensor:
    """A numpy array (or array-like) as a CPU tensor, copying only when
    the buffer is read-only (wire payloads) or not contiguous."""
    arr = np.asarray(arr)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr)


def accepts_stream_context(fn) -> bool:
    """True when ``fn`` can be called as ``fn(inputs, context=...)``: it
    declares a ``context`` parameter passable by keyword, or a
    ``**kwargs`` catch-all. The one definition PyModel and the scheduler
    use, so a one-argument stream callable keeps its calling convention
    everywhere."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    ctx = params.get("context")
    if ctx is not None and ctx.kind in (ctx.POSITIONAL_OR_KEYWORD,
                                        ctx.KEYWORD_ONLY):
        return True
    return any(p.kind == p.VAR_KEYWORD for p in params.values())


class StreamContext:
    """Per-request serving context handed down to a decoupled model (the
    reference's ``StreamContext``).

    ``tenant_id`` / ``slo_class`` carry the request's SLO labels, as the
    front end validated them. ``deadline_ns`` / ``cancel_event`` bound the
    request's lifetime: the absolute monotonic-ns deadline made from the
    wire ``timeout`` parameter (0 = none), and an optional Event a front
    end sets when the caller goes away (gRPC context cancellation). The
    continuous-batching engine frees the stream's slot and prefix pins
    when either fires instead of decoding to the budget. ``trace`` is the
    request's sampled ``Trace`` (None: untraced), which the engine stamps
    with its spans."""

    __slots__ = ("trace", "enqueue_ns", "tenant_id", "slo_class",
                 "deadline_ns", "cancel_event")

    def __init__(self, trace=None, enqueue_ns: int = 0,
                 tenant_id: str = DEFAULT_TENANT,
                 slo_class: str = DEFAULT_SLO_CLASS,
                 deadline_ns: int = 0, cancel_event=None):
        self.trace = trace
        self.enqueue_ns = enqueue_ns
        self.tenant_id = tenant_id
        self.slo_class = slo_class
        self.deadline_ns = deadline_ns
        self.cancel_event = cancel_event


class ServedModel:
    """Base class: execute() one batch of host arrays; stream() for a
    decoupled model."""

    def __init__(self, config: ModelConfig):
        self.config = config

    @property
    def name(self) -> str:
        return self.config.name

    def load(self) -> None:
        """Acquire device resources; called at registration."""

    def unload(self) -> None:
        """Release device resources."""

    def execute(self, inputs: dict) -> dict:
        raise NotImplementedError

    def stream(self, inputs: dict,
               context: Optional[StreamContext] = None) -> Iterator[dict]:
        """A decoupled model yields zero or more responses per request.
        ``context`` (given by the scheduler) carries the request's
        deadline, cancel Event and SLO labels."""
        yield self.execute(inputs)

    def warmup(self) -> None:
        """Run every batch bucket once (optional)."""

    def warmup_serving(self) -> None:
        """Run serving-only execution paths once (optional)."""


class PyModel(ServedModel):
    """Host (CPU/Python) model — preprocessing steps, test doubles, the
    generation engine's front (``stream_fn`` yields a decoupled model's
    responses), etc."""

    def __init__(self, config: ModelConfig, fn: Callable[[dict], dict],
                 stream_fn: Optional[Callable[[dict], Iterator[dict]]] = None):
        super().__init__(config)
        self._fn = fn
        self._stream_fn = stream_fn
        # a stream_fn opts into the serving context by declaring a
        # `context` keyword (decided once here, not per request)
        self._stream_takes_context = (stream_fn is not None
                                      and accepts_stream_context(stream_fn))

    def execute(self, inputs: dict) -> dict:
        return self._fn(inputs)

    def stream(self, inputs: dict,
               context: Optional[StreamContext] = None) -> Iterator[dict]:
        if self._stream_fn is not None:
            if self._stream_takes_context:
                yield from self._stream_fn(inputs, context=context)
            else:
                yield from self._stream_fn(inputs)
        else:
            yield self.execute(inputs)


class TorchModel(ServedModel):
    """A PyTorch model hosted on the card (or, when asked, the CPU).

    apply_fn(params, inputs: dict[str, Tensor]) -> dict[str, Tensor].
    ``params`` is any nesting of dicts of tensors; it moves to ``device``
    at load(). ``device`` defaults to CUDA and raises without it.

    ``mesh`` shards the model over one process per device (the module
    docstring): ``param_sharding`` is a spec tree of ``params``' structure
    (each leaf a tuple of the mesh axis, or None, of every dim),
    ``input_sharding`` one such tuple for every input (or a dict of them
    by input name) naming the dp axis of the batch dim. Under a mesh the
    device is the mesh's, and ``apply_fn`` is always called with
    ``mesh=`` (the model's own copy of the mesh's groups) on the rank's
    block of the batch; it returns outputs that are whole but for the
    batch dim (a tp-split output is gathered inside ``apply_fn``), which
    the model all-gathers over the input's batch axis.
    """

    def __init__(self, config: ModelConfig,
                 apply_fn: Callable[[Any, dict], dict],
                 params: Any = None, device=None, mesh=None,
                 param_sharding=None, input_sharding=None):
        super().__init__(config)
        self._apply_fn = apply_fn
        self._mesh = self._chan = None
        if mesh is None:
            if (param_sharding, input_sharding) != (None, None):
                raise ValueError("param_sharding and input_sharding lay a "
                                 "model over a mesh; pass mesh=")
            self.device = resolve_device(device)
        else:
            from client_tpu_torch.parallel import spmd
            from client_tpu_torch.parallel.mesh import shard_tree

            self.device = spmd.mesh_device(mesh)
            if device is not None and \
                    resolve_device(device).type != self.device.type:
                raise ValueError(
                    f"device {device!r} conflicts with the mesh's device "
                    f"type {self.device.type!r}: a mesh places the model")
            self._mesh = spmd.ShardMesh(mesh)
            self._chan = spmd.PlanChannel(self._mesh.plan_group)
            if param_sharding is not None:
                params = shard_tree(params, param_sharding, self._mesh)
            self._mesh_call_lock = threading.Lock()
            self._followers_stopped = False
        self._heartbeat = None
        self._input_sharding = input_sharding
        self._params_host = params
        self._params = None
        self._loaded = False
        self._load_lock = threading.RLock()
        # execute_parts_fused_split calls (one per shm-output batch; the
        # smoke test holds it against the batches the stats count)
        self.fused_split_calls = 0
        # runtime plane: every entry point below is watched, so a capture
        # after warmup is counted and logged instead of silently stealing
        # seconds from the serving path
        self.compile_watch = CompileWatch(config.name)
        self._watched = None

    def _watch_entry_points(self) -> dict:
        """{kind: watched entry point} of ``apply``, ``fused_batch`` and
        ``fused_batch_split``: CUDA graphs on the card, eager on the CPU;
        under a mesh rank 0's eager forward, whose fused kinds take the
        concatenated batch."""
        watch = self.compile_watch.watch
        if self._mesh is not None:
            return {k: watch(k, self._mesh_forward)
                    for k in ("apply", "fused_batch", "fused_batch_split")}
        graphs = self.device.type == "cuda"
        dev = self.device

        def fused_capture():
            def bind(params, parts, bucket):
                slab = {name: torch.empty(
                    (sum(p[name].shape[0] for p in parts),)
                    + tuple(parts[0][name].shape[1:]),
                    dtype=parts[0][name].dtype, device=dev)
                    for name in parts[0]}

                def feed(params_now, parts_now, _bucket):
                    if params_now is not params:
                        raise RuntimeError(
                            f"model '{self.name}': its weights were "
                            f"replaced under a captured graph")
                    for name, out in slab.items():
                        torch.cat([p[name] for p in parts_now], dim=0,
                                  out=out)

                return (lambda: self._apply_fn(params, slab)), feed

            return GraphCapture(bind, dev, out=clone_outputs)

        # the two fused kinds compute one forward on one slab: they replay
        # one graph per bucket, and each kind is recorded on its own
        fused = fused_capture() if graphs else None
        return {
            "apply": watch("apply", self._apply_fn,
                           capture=capture_inputs(self._apply_fn, (1,), dev,
                                                  out=clone_outputs)
                           if graphs else None),
            "fused_batch": watch("fused_batch", self._fused_parts,
                                 capture=fused, graph="fused"),
            "fused_batch_split": watch("fused_batch_split",
                                       self._fused_parts, capture=fused,
                                       graph="fused")}

    def _fused_parts(self, params, parts: list, bucket: int) -> dict:
        """The eager fused path: concatenate, then one forward."""
        batched = {name: torch.cat([p[name] for p in parts], dim=0)
                   for name in parts[0]}
        return self._apply_fn(params, batched)

    def load(self) -> None:
        with self._load_lock:
            if self._loaded:
                return
            self._params = _to_device(self._params_host, self.device)
            self._watched = self._watch_entry_points()
            self._loaded = True
            if self._chan is not None and self._chan.is_driver \
                    and self._heartbeat is None:
                self._heartbeat = threading.Thread(
                    target=self._keep_followers, daemon=True,
                    name=f"{self.name}-heartbeat")
                self._heartbeat.start()

    def _keep_followers(self) -> None:
        """Rank 0's heartbeat while the model idles: a NOOP plan whenever
        the channel was silent for ``spmd.HEARTBEAT_S``, so a follower
        waiting for the next forward never times out, until the unload
        ends the followers."""
        from client_tpu_torch.parallel import spmd

        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._followers_stopped:
            time.sleep(spmd.HEARTBEAT_S / 2)
            with self._mesh_call_lock:
                if not self._followers_stopped:
                    self._chan.keepalive()

    def unload(self) -> None:
        with self._load_lock:
            self._params = None
            self._watched = None
            self._loaded = False
            # a reload warms (and seals) again; its warmup compiles must
            # not count as serving-phase violations, and the graphs read
            # the weights just dropped
            self.compile_watch.reset()
        if self._chan is not None and self._chan.is_driver \
                and not self._followers_stopped:
            # the followers' loops end with the driver's model
            from client_tpu_torch.parallel import spmd

            with self._mesh_call_lock:
                self._followers_stopped = True
                self._chan.send(spmd.STOP)
                self._mesh.destroy()

    def follow(self) -> None:
        """A follower rank's loop (every rank of the mesh but 0): load
        this rank's shard, then run each forward rank 0 broadcasts until
        rank 0 unloads the model, then destroy this rank's groups. Raises
        on this rank when rank 0 failed or the mesh broke."""
        from client_tpu_torch.parallel import spmd

        if self._chan is None or self._chan.is_driver:
            raise RuntimeError("follow() runs on the follower ranks of a "
                               "mesh model; rank 0 serves it")
        self.load()

        def run(op, args):
            (meta,) = args
            tensors = [torch.empty(shape, dtype=getattr(torch, dtype),
                                   device=self.device)
                       for _name, shape, dtype in meta]
            spmd.broadcast_tensors(tensors, self._mesh)
            self._forward_shard(self._snapshot(), {
                name: t for (name, _s, _d), t in zip(meta, tensors)})

        with torch.inference_mode():
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            spmd.follow(self._chan, run)
        self._mesh.destroy()

    def _mesh_forward(self, params, inputs: dict) -> dict:
        """Rank 0's forward under the mesh: the plan (names, shapes and
        dtypes), then the whole batch broadcast over the model's group,
        then this rank's share of the forward; returns whole outputs."""
        from client_tpu_torch.parallel import spmd

        with self._mesh_call_lock:
            if self._followers_stopped:
                raise RuntimeError(
                    f"model '{self.name}': its follower ranks stopped at "
                    f"the unload; a mesh model reloads with its ranks")
            names = list(inputs)
            tensors = [inputs[n].to(self.device).contiguous() for n in names]
            self._chan.send("forward", [
                (n, tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for n, t in zip(names, tensors)])
            spmd.broadcast_tensors(tensors, self._mesh)
            return self._forward_shard(params, dict(zip(names, tensors)))

    def _forward_shard(self, params, inputs: dict) -> dict:
        """Every rank: this rank's block of each whole input (by
        ``input_sharding``), ``apply_fn`` on it, and each output's batch
        dim all-gathered over the input's batch axis."""
        from client_tpu_torch.parallel import collectives as col
        from client_tpu_torch.parallel.mesh import axis_group, shard_tree

        def spec_of(specs, name, default=None):
            if isinstance(specs, dict):
                return specs.get(name, default)
            return default if specs is None else specs

        block = {name: shard_tree(x, spec_of(self._input_sharding, name,
                                             ()), self._mesh)
                 for name, x in inputs.items()}
        out = self._apply_fn(params, block, mesh=self._mesh)
        first = spec_of(self._input_sharding, next(iter(inputs), None), ())
        if not first or first[0] is None:
            return out
        group = axis_group(self._mesh, first[0])
        return {name: col.all_gather(y, group, 0) for name, y in out.items()}

    def runtime_observability(self) -> dict:
        """The runtime block (``client_tpu_runtime_*`` and ``GET
        /v2/debug/runtime``): the compile table plus the weights' bytes,
        resident or not yet loaded, as the reference's ``JaxModel``
        reports them; no engine thread (``engine_up`` None)."""
        snap = self.compile_watch.snapshot()
        params = self._params if self._params is not None \
            else self._params_host
        snap["memory"] = {"weights": pytree_nbytes(params)}
        snap["engine_up"] = None
        return snap

    def _snapshot(self):
        """The params to run with, loading first if needed (an unload()
        racing an in-flight call cannot null them out from under it)."""
        return self._snapshot_all()[0]

    def _snapshot_all(self) -> tuple:
        """(params, the watched entry points) as one consistent pair."""
        with self._load_lock:
            if not self._loaded:
                self.load()
            return self._params, self._watched

    def _run(self, params, inputs: dict, watched: dict) -> dict:
        with torch.inference_mode():
            return watched["apply"](params, inputs)

    # -- dynamic-batch paths (inputs already on the device) --

    def _fused(self, kind: str, parts: list, bucket: int) -> dict:
        params, watched = self._snapshot_all()
        if len(parts) < bucket:
            parts = parts + [parts[0]] * (bucket - len(parts))
        with torch.inference_mode():
            if self._mesh is not None:
                batched = {name: torch.cat([p[name] for p in parts], dim=0)
                           for name in parts[0]}
                return watched[kind](params, batched)
            return watched[kind](params, parts, bucket)

    def execute_parts_fused(self, parts: list, bucket: int) -> dict:
        """One forward for a whole dynamic batch of single-row requests.
        The parts list is padded to exactly ``bucket`` entries by
        repeating the first part: padding rows compute values the
        scheduler never delivers, and every batch runs at one shape (one
        graph per bucket, ever)."""
        return self._fused("fused_batch", parts, bucket)

    def execute_parts_fused_split(self, parts: list, bucket: int) -> tuple:
        """Like execute_parts_fused, but the outputs come back PRE-SPLIT:
        ``({name: bucket single-row views of the batch's output slab},
        event)``. Row i belongs to request i; rows beyond the real batch
        are padding. The slab is this batch's own (a replay's copy-out),
        the views cost no kernel (``split(1)``), and the CUDA event
        recorded behind the forward is the batch's completion signal: the
        outputs never leave the device (None on the CPU, where the
        forward has completed on return)."""
        out = self._fused("fused_batch_split", parts, bucket)
        self.fused_split_calls += 1
        split = {name: slab.split(1) for name, slab in out.items()}
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return split, event

    def execute_parts_ragged(self, parts: list, bucket: int) -> dict:
        """Ragged per-request batch sizes: concatenate on the device, pad
        with zero rows up to ``bucket``, then one eager forward, unwatched
        (the reference's ragged assembly is an unwatched jit too)."""
        params = self._snapshot()
        batched = {}
        for name in parts[0]:
            arr = torch.cat([p[name] for p in parts], dim=0)
            if arr.shape[0] < bucket:
                pad = arr.new_zeros((bucket - arr.shape[0],)
                                    + tuple(arr.shape[1:]))
                arr = torch.cat([arr, pad], dim=0)
            batched[name] = arr
        with torch.inference_mode():
            if self._mesh is not None:
                return self._mesh_forward(params, batched)
            return self._apply_fn(params, batched)

    def device_put_inputs(self, inputs: dict) -> dict:
        """Host -> device copy of every input (tensors already on the
        model's device pass through). Host arrays are always copied, on
        the CPU too: the batcher recycles its host buffers once a batch
        completes, while outputs may still view their inputs."""
        out = {}
        for name, v in inputs.items():
            if isinstance(v, torch.Tensor):
                out[name] = v.to(self.device)
            else:
                out[name] = _host_tensor(v).to(self.device, copy=True)
        return out

    def execute_on_device(self, device_inputs: dict) -> dict:
        """Run the forward; returns device-resident outputs (no sync)."""
        params, watched = self._snapshot_all()
        return self._run(params, device_inputs, watched)

    def execute(self, inputs: dict) -> dict:
        dev_out = self.execute_on_device(self.device_put_inputs(inputs))
        return finish_host_copies(start_host_copies(dev_out))

    def _zero_inputs(self, batch: int) -> Optional[dict]:
        """Zero host inputs of the config's shapes at ``batch`` rows (no
        batch dim when 0); None when an input is BYTES."""
        inputs = {}
        for spec in self.config.inputs:
            dims = tuple(1 if d < 0 else int(d) for d in spec.dims)
            np_dtype = wire_to_np_dtype(spec.datatype)
            if np_dtype == np.object_:
                return None
            inputs[spec.name] = np.zeros(((batch,) + dims) if batch
                                         else dims, dtype=np_dtype)
        return inputs

    def warmup(self) -> None:
        """Run every batch bucket once, then the serving paths, so every
        graph is captured (and the kernels' libraries built) before the
        first request; then seal the compile set: any further capture is
        a serving-phase violation the runtime plane counts and logs."""
        for b in self.config.batch_buckets() or (0,):
            inputs = self._zero_inputs(b)
            if inputs is not None:
                self.execute(inputs)
        self.warmup_serving()
        self.compile_watch.seal()

    def warmup_serving(self) -> None:
        """Run the dynamic-batch fused paths (the slab and the pre-split
        variant) at every bucket."""
        if self.config.max_batch_size <= 0 \
                or self.config.dynamic_batching is None:
            return
        part_host = self._zero_inputs(1)
        if part_host is None:
            return  # BYTES tensors never ride the fused device path
        part = self.device_put_inputs(part_host)
        for b in self.config.batch_buckets():
            finish_host_copies(start_host_copies(
                self.execute_parts_fused([part], b)))
            _, event = self.execute_parts_fused_split([part], b)
            if event is not None:
                event.synchronize()


def _to_device(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


class SequenceModel(TorchModel):
    """A stateful model: per-correlation-id state carried across requests
    (the reference's ``SequenceModel``). It reuses TorchModel's
    load/unload of the params onto ``device`` and its runtime block.

    ``init_state_fn()`` builds a fresh state (any nesting of tensors on
    the model's device) and ``step_fn(params, inputs, state) -> (outputs,
    state)`` runs one request; the sequence scheduler threads the state
    through a sequence, and it stays on the device between requests.
    Inputs move to the device per step; outputs come back as host
    arrays. ``step`` is watched (kind ``step``) and runs eagerly. A step
    may write its state in place: the scheduler builds a fresh state at
    every START, never reusing a state's tensors."""

    def __init__(self, config: ModelConfig,
                 step_fn: Callable[[Any, dict, Any], tuple],
                 init_state_fn: Callable[[], Any],
                 params: Any = None, device=None):
        super().__init__(config, apply_fn=None, params=params, device=device)
        self._step_fn = step_fn
        self._init_state_fn = init_state_fn

    def _watch_entry_points(self):
        """``step``, watched and eager: watched but never sealed, since a
        sequence model has no warmup phase (the table records its first
        calls without flagging them)."""
        return self.compile_watch.watch("step", self._step_fn)

    def warmup(self) -> None:
        """No batch buckets to warm (the reference's SequenceModel warms
        nothing either) and no seal."""

    def init_state(self):
        with torch.inference_mode():
            return self._init_state_fn()

    def step(self, inputs: dict, state):
        params, step = self._snapshot_all()
        dev_in = self.device_put_inputs(inputs)
        with torch.inference_mode():
            outputs, new_state = step(params, dev_in, state)
        return finish_host_copies(start_host_copies(outputs)), new_state

    def execute(self, inputs: dict) -> dict:
        out, _ = self.step(inputs, self.init_state())
        return out
