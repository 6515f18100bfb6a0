"""TorchInferenceServer — the transport-independent serving core.

The port's counterpart of ``client_tpu/server/core.py``: the HTTP and
gRPC front ends (and in-process callers) call this object; it owns the model
registry, the schedulers, the shared-memory registries, the response cache,
the statistics and the trace settings.

The model repository: a model is registered programmatically
(``register_model``), through a factory loaded on demand
(``register_model_factory``; a factory that takes an argument gets the
load's config override), or from a repository directory
(``model_repository``: ``<repo>/<name>/model.py`` with
``create_model()``, executed anew at every load, so edits take effect on
reload). ``load_model``, ``unload_model`` (with ``unload_dependents``
for an ensemble's composing models) and ``repository_index`` serve the
v2 repository extension. An ensemble (a config with ``ensemble_steps``)
runs its steps in order through ``infer``, tensors flowing through each
step's input and output maps, and a traced ensemble's steps are child
traces of its own. A request of a sequence is never answered from the
response cache.

Tensors may ride the request, or sit in a registered shared-memory
region (``system_shm``: POSIX regions; ``cuda_shm``: tensors on a
device, read zero-copy by an in-process producer's server). Outputs a
request directs into a region are written there instead of riding the
response.

A request is sampled by the tracer (``trace_level``, ``trace_rate``,
``trace_count``, ``log_frequency``, ``trace_file``, global or per model; a
propagated trace id forces sampling), and its spans are stamped from
arrival through the scheduler and, for a generation stream, inside the
engine. ``metrics_text`` renders the Prometheus exposition
(``server/metrics.py``). A model with ``response_cache`` answers a
repeated request whose inputs are all host arrays from the cache.
Readiness follows a model's engine: a model whose engine thread died is
not ready (under supervision until the rebuilt engine is live, for good
once the crash-loop breaker trips).

The debug surface (served by the front ends behind their opt-in flag):
``debug_runtime`` (card memory and each model's memory ledger),
``debug_engine`` (one engine's slot tables and flight tail),
``debug_slo``, ``debug_scheduler``, ``debug_incidents`` (the watchdog's
bundles), ``debug_faults`` / ``debug_faults_update`` (the fault-injection
schedule) and ``debug_profile`` (a ``torch.profiler`` capture). Waiting
for a later slice: the fleet view.
"""

from __future__ import annotations

import importlib.util
import inspect
import logging
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

import client_tpu_torch
from client_tpu_torch.device import canonical_device, tensor_bytes
from client_tpu_torch.protocol.binary import (
    deserialize_bytes_tensor,
    tensor_to_bytes,
)
from client_tpu_torch.protocol.dtypes import (
    DataType,
    dtype_byte_size,
    element_count,
    np_to_wire_dtype,
    wire_to_np_dtype,
)
from client_tpu_torch.server import faultinject
from client_tpu_torch.server import trace as trace_mod
from client_tpu_torch.server.cache import ResponseCache
from client_tpu_torch.server.config import ModelConfig
from client_tpu_torch.server.metrics import render_server_metrics
from client_tpu_torch.server.model import ServedModel
from client_tpu_torch.server.runtime_stats import (
    device_memory_stats,
    graph_launches_paused,
)
from client_tpu_torch.server.scheduler import Pending, make_scheduler
from client_tpu_torch.server.shm import CudaShmRegistry, SystemShmRegistry
from client_tpu_torch.server.stats import ModelStats
from client_tpu_torch.server.trace import Tracer
from client_tpu_torch.server.types import (
    InferRequest,
    InferResponse,
    InferTensor,
    ServerError,
    now_ns,
)
from client_tpu_torch.utils import cuda_shared_memory as cudashm

log = logging.getLogger(__name__)

SERVER_EXTENSIONS = [
    "classification",
    "sequence",
    "model_repository",
    "model_configuration",
    "binary_tensor_data",
    "statistics",
    "system_shared_memory",
    "cuda_shared_memory",
    "trace",
    "metrics",
    "response_cache",
]


class _ModelEntry:
    def __init__(self, model: ServedModel, version: int):
        self.model = model
        self.version = version
        self.stats = ModelStats()
        self.scheduler = None
        self.state = "UNAVAILABLE"
        self.reason = ""
        self.origin = "programmatic"  # programmatic | factory | repository
        # where the model's tensor inputs must already live (None: a host
        # model, which takes CPU tensors only)
        dev = getattr(model, "device", None)
        self.device = canonical_device(dev) if dev is not None else None


class TorchInferenceServer:
    def __init__(self, name: str = "client-tpu-torch-server",
                 model_repository: Optional[str] = None,
                 cache_bytes: int = 256 * 1024 * 1024):
        self.name = name
        self.version = client_tpu_torch.__version__
        self._lock = threading.Lock()
        self._models: dict[str, dict[int, _ModelEntry]] = {}
        # read-mostly (name, version) -> READY entry mirror: per-request
        # lookups read it without the registry mutex (dict reads are
        # GIL-atomic; mutations rebuild it under the lock)
        self._ready_cache: dict[tuple, _ModelEntry] = {}
        self._repository = model_repository
        self._factories: dict[str, Callable] = {}
        self._start_time = time.time()
        self._live = True
        self.system_shm = SystemShmRegistry()
        self.cuda_shm = CudaShmRegistry()
        self.cache = ResponseCache(max_bytes=cache_bytes)
        self.tracer = Tracer()
        # one profiler capture at a time (debug_profile)
        self._profile_lock = threading.Lock()

    # ------------------------------------------------------------------
    # model lifecycle
    # ------------------------------------------------------------------

    def register_model(self, model: ServedModel, version: int = 1,
                       warmup: bool = False,
                       origin: str = "programmatic") -> None:
        """Programmatic model registration (loads immediately)."""
        entry = _ModelEntry(model, version)
        entry.origin = origin
        model.load()
        if warmup:
            model.warmup()
        entry.scheduler = make_scheduler(model, entry.stats, str(version))
        entry.state = "READY"
        with self._lock:
            self._models.setdefault(model.name, {})[version] = entry
            self._rebuild_ready_cache()

    def register_model_factory(self, name: str, factory: Callable) -> None:
        """Register a factory for explicit load/unload control."""
        self._factories[name] = factory

    def load_model(self, name: str,
                   config_override: Optional[dict] = None) -> None:
        """Load ``name`` from its factory (which gets ``config_override``
        when it takes an argument), else from the repository directory's
        ``<name>/model.py``, else reload a programmatically registered
        model (an override is then a 400); anything else is a 400."""
        factory = self._factories.get(name)
        if factory is not None:
            model = (factory(config_override) if _accepts_arg(factory)
                     else factory())
            self.register_model(model, origin="factory")
            return
        if self._repository:
            model_py = os.path.join(self._repository, name, "model.py")
            if os.path.isfile(model_py):
                # executed anew at every load, so edits take effect
                spec = importlib.util.spec_from_file_location(
                    f"client_tpu_torch_repo_{name}", model_py)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                self.register_model(mod.create_model(), origin="repository")
                return
        # a programmatically registered model keeps its entry across an
        # unload, and a load reloads the same object (a no-op when it is
        # READY). Entries are claimed under the lock (LOADING), so that
        # concurrent loads build one scheduler, and loaded outside it:
        # a device load can take seconds, and every infer needs the lock
        to_load = []
        with self._lock:
            versions = self._models.get(name)
            if versions and all(
                    e.origin == "programmatic" for e in versions.values()):
                if config_override:
                    raise ServerError(
                        f"model '{name}' was registered programmatically; "
                        "config override on load is not supported", 400)
                for entry in versions.values():
                    if entry.state in ("READY", "LOADING"):
                        continue
                    entry.state = "LOADING"
                    to_load.append(entry)
            else:
                versions = None
        if versions is None:
            raise ServerError(
                f"no factory or repository entry for model '{name}'", 400)
        for i, entry in enumerate(to_load):
            try:
                entry.model.load()
                scheduler = make_scheduler(entry.model, entry.stats,
                                           str(entry.version))
            except Exception as e:
                # release every claimed entry left, or a LOADING entry
                # could never be loaded again
                with self._lock:
                    for stuck in to_load[i:]:
                        stuck.state = "UNAVAILABLE"
                        stuck.reason = str(e)
                    self._rebuild_ready_cache()
                raise
            with self._lock:
                entry.scheduler = scheduler
                entry.state = "READY"
                entry.reason = ""
                self._rebuild_ready_cache()

    def unload_model(self, name: str, unload_dependents: bool = False) -> None:
        """Unload every version of ``name`` (its scheduler drains, then
        the model releases its device memory); ``unload_dependents``
        also unloads an ensemble's composing models. Unknown models are a
        400."""
        # entries are claimed under the lock; the scheduler stop and the
        # device unload (seconds, draining batches) run outside it
        to_stop = []
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ServerError(f"model '{name}' is not loaded", 400)
            dependents = []
            if unload_dependents:
                for entry in versions.values():
                    for step in entry.model.config.ensemble_steps:
                        dependents.append(step.model_name)
            for entry in versions.values():
                entry.state = "UNAVAILABLE"
                entry.reason = "unloaded"
                to_stop.append(entry)
            self._rebuild_ready_cache()
        for entry in to_stop:
            if entry.scheduler:
                entry.scheduler.stop()
            entry.model.unload()
        # the unloaded model's last spans may wait in the tracer's
        # log_frequency buffer
        self.tracer.flush()
        for dep in dependents:
            try:
                self.unload_model(dep)
            except ServerError:
                pass

    def _rebuild_ready_cache(self) -> None:
        """Rebuild the lock-free entry mirror. Caller holds self._lock."""
        cache: dict[tuple, _ModelEntry] = {}
        for name, versions in self._models.items():
            ready = [e for e in versions.values() if e.state == "READY"]
            for e in ready:
                cache[(name, str(e.version))] = e
            if ready:
                cache[(name, "")] = max(ready, key=lambda e: e.version)
        self._ready_cache = cache

    def _entry(self, name: str, version: str = "") -> _ModelEntry:
        entry = self._ready_cache.get((name, version))
        if entry is not None and entry.state == "READY":
            return entry
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ServerError(f"unknown model '{name}'", 404)
            if version:
                try:
                    v = int(version)
                except ValueError:
                    raise ServerError(
                        f"invalid model version '{version}'", 400) from None
                entry = versions.get(v)
                if entry is None:
                    raise ServerError(
                        f"unknown version {version} of model '{name}'", 404)
                return entry
            ready = [e for e in versions.values() if e.state == "READY"]
            pool = ready or list(versions.values())
            return max(pool, key=lambda e: e.version)

    # ------------------------------------------------------------------
    # control plane
    # ------------------------------------------------------------------

    def live(self) -> bool:
        return self._live

    def ready(self) -> bool:
        with self._lock:
            entries = [e for vs in self._models.values() for e in vs.values()]
        return self._live and all(e.state == "READY"
                                  and _engine_healthy(e.model)
                                  for e in entries)

    def model_ready(self, name: str, version: str = "") -> bool:
        try:
            entry = self._entry(name, version)
        except ServerError:
            return False
        return entry.state == "READY" and _engine_healthy(entry.model)

    def metadata(self) -> dict:
        return {"name": self.name, "version": self.version,
                "extensions": list(SERVER_EXTENSIONS)}

    def model_metadata(self, name: str, version: str = "") -> dict:
        entry = self._entry(name, version)
        with self._lock:
            versions = sorted(self._models.get(name, {}).keys())
        return entry.model.config.metadata_json(versions)

    def model_config(self, name: str, version: str = "") -> dict:
        return self._entry(name, version).model.config.to_json()

    def repository_index(self, ready_only: bool = False) -> list:
        """Every registered model version with its state and reason, then
        the factories and repository directories not loaded yet
        (``UNAVAILABLE``/``unloaded``); ``ready_only`` keeps READY ones."""
        out = []
        with self._lock:
            loaded = dict(self._models)
        for name, versions in sorted(loaded.items()):
            for v, entry in sorted(versions.items()):
                if ready_only and entry.state != "READY":
                    continue
                out.append({"name": name, "version": str(v),
                            "state": entry.state, "reason": entry.reason})
        for name in sorted(self._factories):
            if name not in loaded:
                out.append({"name": name, "version": "",
                            "state": "UNAVAILABLE", "reason": "unloaded"})
        if self._repository and os.path.isdir(self._repository):
            for name in sorted(os.listdir(self._repository)):
                if name.startswith((".", "_")):
                    continue
                if os.path.isdir(os.path.join(self._repository, name)) \
                        and name not in loaded \
                        and name not in self._factories:
                    out.append({"name": name, "version": "",
                                "state": "UNAVAILABLE", "reason": "unloaded"})
        return out

    def statistics(self, name: str = "", version: str = "") -> dict:
        stats = []
        with self._lock:
            items = list(self._models.items())
        for model_name, versions in sorted(items):
            if name and model_name != name:
                continue
            for v, entry in sorted(versions.items()):
                if version and str(v) != version:
                    continue
                j = entry.stats.to_json(model_name, str(v))
                # a model with its own runtime (the generation engine)
                # adds its live counters; the HTTP JSON carries them, the
                # gRPC proto keeps the KServe field set
                extra = getattr(entry.model, "runtime_stats", None)
                if callable(extra):
                    try:
                        j["runtime"] = extra()
                    except Exception:  # noqa: BLE001 — stats best-effort
                        pass
                stats.append(j)
        if name and not stats:
            raise ServerError(f"unknown model '{name}'", 404)
        return {"model_stats": stats}

    # ---- trace settings ----

    def get_trace_settings(self, model_name: str = "") -> dict:
        return self.tracer.get_settings(model_name)

    def update_trace_settings(self, model_name: str = "",
                              settings: Optional[dict] = None) -> dict:
        return self.tracer.update_settings(model_name, settings)

    # ---- metrics ----

    def metrics_text(self) -> str:
        """The Prometheus exposition served at GET /metrics."""
        return render_server_metrics(self)

    def _model_snapshots(self, hook: str, key: str) -> dict:
        """``{"models": [...]}`` with one row per served model version
        whose model has the ``hook`` method and gives a snapshot (None:
        the feature is off there); a snapshot that raises is left out
        (introspection is best effort)."""
        with self._lock:
            entries = [(name, str(e.version), e)
                       for name, versions in self._models.items()
                       for e in versions.values()]
        models = []
        for name, version, entry in sorted(entries, key=lambda x: x[:2]):
            fn = getattr(entry.model, hook, None)
            if not callable(fn):
                continue
            try:
                snap = fn()
            except Exception:  # noqa: BLE001 — introspection best-effort
                continue
            if snap is None:
                continue
            models.append({"model": name, "version": version,
                           "state": entry.state, key: snap})
        return {"models": models}

    def debug_runtime(self) -> dict:
        """The runtime plane: the card's memory from the caching
        allocator (empty without CUDA) and, for every model with a
        runtime block, its compile table, memory ledger and engine
        liveness."""
        with self._lock:
            entries = [(name, str(e.version), e)
                       for name, versions in self._models.items()
                       for e in versions.values()]
        models = []
        for name, version, entry in sorted(entries, key=lambda x: x[:2]):
            rt = getattr(entry.model, "runtime_observability", None)
            if not callable(rt):
                continue
            try:
                snap = rt()
            except Exception:  # noqa: BLE001 — introspection best-effort
                continue
            snap.update({"model": name, "version": version,
                         "state": entry.state})
            models.append(snap)
        return {"devices": device_memory_stats(), "models": models}

    def debug_engine(self, name: str, version: str = "") -> dict:
        """One model's live engine snapshot (slot tables, queue, pool and
        speculation state, flight-recorder tail); 404 for a model with no
        engine."""
        entry = self._entry(name, version)
        dbg = getattr(entry.model, "engine_debug", None)
        if not callable(dbg):
            raise ServerError(
                f"model '{name}' has no generation engine to introspect",
                404)
        snap = dbg()
        snap["model"] = name
        snap["version"] = str(entry.version)
        return snap

    def debug_slo(self) -> dict:
        """Per-(tenant, slo_class) SLO state of every engine-backed model:
        windowed TTFT, ITL and queue-wait quantiles, error-budget burn and
        outcome counts."""
        return self._model_snapshots("slo_snapshot", "slo")

    def debug_scheduler(self) -> dict:
        """The scheduler state of every model that runs one: fair-queue
        depths, parked reservations, controller mode and knobs,
        preemptions and resumes."""
        return self._model_snapshots("scheduler_snapshot", "scheduler")

    def debug_fleet(self) -> dict:
        """The replica-fleet router state of every model that runs a
        fleet (``fleet_snapshot``): per-replica health, affinity,
        occupancy, routing counters and drain state, with the recent
        decisions and lifecycle events, and the ``autoscale`` block
        (policy, signals, decision ring, canary judge) where the fleet
        runs the autoscaler. Models without a fleet are left out."""
        return self._model_snapshots("fleet_snapshot", "fleet")

    def debug_incidents(self) -> dict:
        """The watchdog's incident bundles of every model that runs it
        (detector, breach, the triggering history, the flight tail and
        the plane snapshots) with the live detector state. The store
        outlives an engine restart, so a crashed engine's death bundle is
        here after the fresh engine serves."""
        return self._model_snapshots("incident_snapshot", "incidents")

    def debug_timeline(self, name: str = "") -> dict:
        """The Chrome-trace / Perfetto timeline (``GET
        /v2/debug/timeline``): every timeline-capable model's
        flight-recorder ring merged with the tracer's completed request
        traces (``server/timeline.build_timeline``), one process per
        replica, the engine-plane tracks and a thread track per traced
        request. ``name`` restricts it to one model (404 when that model
        has no timeline); models without ``timeline_snapshot`` are left
        out."""
        from client_tpu_torch.server import timeline as timeline_mod

        with self._lock:
            entries = [(mname, str(e.version), e)
                       for mname, versions in self._models.items()
                       for e in versions.values()]
        traces_by_model: dict = {}
        for tr in list(self.tracer.completed):
            traces_by_model.setdefault(tr.model_name, []).append(
                tr.to_json())
        models = []
        for mname, version, entry in sorted(entries, key=lambda x: x[:2]):
            if name and mname != name:
                continue
            fn = getattr(entry.model, "timeline_snapshot", None)
            if not callable(fn):
                continue
            try:
                snap = fn()
            except Exception:  # noqa: BLE001 — introspection best-effort
                continue
            models.append({"model": mname, "version": version,
                           "traces": traces_by_model.get(mname, []),
                           "replicas": snap.get("replicas"),
                           "fleet": snap.get("fleet"),
                           "incidents": snap.get("incidents")})
        if name and not models:
            raise ServerError(
                f"model '{name}' has no timeline to export", 404)
        return timeline_mod.build_timeline(models)

    def debug_traces(self, name: str = "") -> dict:
        """Completed request traces (``Trace.to_json`` dicts, oldest
        first) from the tracer's bounded completion ring, ``name``'s only
        when given: the raw spans of ``GET /v2/debug/timeline``, which the
        perf analyzer joins by trace id with what its client measured for
        the slowest-request breakdown."""
        return {"traces": [tr.to_json() for tr in list(self.tracer.completed)
                           if not name or tr.model_name == name]}

    def debug_faults(self) -> dict:
        """The process-global fault-injection schedule (armed specs,
        per-point hit counts)."""
        return faultinject.get_injector().snapshot()

    def debug_faults_update(self, body: dict) -> dict:
        """Arm (``{"faults": [spec...], "seed": n}``) or clear
        (``{"clear": true}``) the fault-injection schedule; a malformed
        spec is a 400."""
        inj = faultinject.get_injector()
        if body.get("clear"):
            inj.clear()
            return inj.snapshot()
        faults = body.get("faults")
        if not isinstance(faults, list) or not faults:
            raise ServerError(
                "body must carry 'faults' (a non-empty list of fault "
                "specs) or 'clear': true", 400)
        try:
            inj.arm(faults, seed=body.get("seed"))
        except (TypeError, ValueError) as e:
            raise ServerError(f"invalid fault spec: {e}", 400) from e
        return inj.snapshot()

    def debug_profile(self, log_dir: str, duration_s: float = 1.0) -> dict:
        """A ``torch.profiler`` capture of ``duration_s`` seconds (the
        host's ops and, once CUDA is in use, every kernel on the card)
        written into ``log_dir`` as a Chrome trace
        (``*.pt.trace.json``, TensorBoard's layout). One capture at a
        time (409 while one runs), at most 60 s."""
        if not log_dir:
            raise ServerError("log_dir is required", 400)
        duration_s = float(duration_s)
        if not 0.0 < duration_s <= 60.0:
            raise ServerError(
                f"duration_s must be in (0, 60], got {duration_s}", 400)
        if not self._profile_lock.acquire(blocking=False):
            raise ServerError(
                "a profiler capture is already running", 409)
        try:
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import (
                ProfilerActivity,
                profile,
                tensorboard_trace_handler,
            )

            os.makedirs(log_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                activities.append(ProfilerActivity.CUDA)
            try:
                # the serving threads' host ops, not only this one's
                config = _ExperimentalConfig(profile_all_threads=True)
            except TypeError:
                # a torch without the option records this thread's host
                # ops; the card's kernels are recorded from every thread
                config = None
            t0 = time.monotonic()
            prof = profile(activities=activities, experimental_config=config)
            # CUPTI is turned on and off between CUDA graph launches, and
            # the trace is written after, with the graphs running again
            with graph_launches_paused():
                prof.start()
            try:
                time.sleep(duration_s)
            finally:
                with graph_launches_paused():
                    prof.stop()
            tensorboard_trace_handler(log_dir)(prof)
            return {"log_dir": log_dir,
                    "duration_s": round(time.monotonic() - t0, 3)}
        finally:
            self._profile_lock.release()

    # ------------------------------------------------------------------
    # data plane
    # ------------------------------------------------------------------

    def infer(self, request: InferRequest,
              response_callback: Optional[Callable] = None
              ) -> Optional[InferResponse]:
        """Run one inference. Sync (returns the response, raises
        ServerError on failure) unless ``response_callback`` is given; it
        is then called with (response, final) for each response, the last
        one with final=True, and infer returns None. A decoupled model
        needs the callback (400 without it); its wire ``timeout`` becomes
        the stream's deadline (a 504 once it passes) and the request's
        ``cancel_event``, set by the front end, ends it with a 499."""
        # arrival and the trace ride locals: an in-process caller may
        # reuse one request object across concurrent calls
        arrival_ns = now_ns()
        request.arrival_ns = arrival_ns
        entry = self._entry(request.model_name, request.model_version)
        if entry.state != "READY":
            raise ServerError(
                f"model '{request.model_name}' is not ready", 400)
        cfg = entry.model.config
        # request.trace mirrors it for the front ends' trace-id echo
        trace = self.tracer.sample(request.model_name, str(entry.version),
                                   propagated_id=request.trace_id,
                                   parent=request.trace_parent)
        request.trace = trace
        if trace is not None:
            trace.event(trace_mod.REQUEST_START, arrival_ns,
                        tenant=request.tenant_id,
                        slo_class=request.slo_class)
            trace.add_tensors("input", request.inputs)
        if cfg.is_ensemble():
            return self._infer_ensemble(entry, request, response_callback,
                                        arrival_ns, trace)
        try:
            inputs = self._resolve_inputs(entry, request)
            if cfg.decoupled and response_callback is None:
                raise ServerError(
                    f"model '{request.model_name}' is decoupled; use the "
                    "streaming API", 400)
        except Exception:
            # the request ends before a sink exists: close its trace here,
            # or it is never exported
            if trace is not None:
                trace.event(trace_mod.REQUEST_END)
                self.tracer.release(trace)
            raise

        # the response cache keys host-resident requests only: an input
        # on the device (a CUDA region, an in-process tensor) or an output
        # directed into a region is never cached, nor is a request of a
        # sequence (its answer depends on the sequence's state)
        cache_key = None
        if cfg.response_cache and not cfg.decoupled \
                and not request.has_sequence() \
                and all(isinstance(v, np.ndarray) for v in inputs.values()) \
                and all(o.shm_region is None for o in request.outputs):
            t0 = now_ns()
            cache_key = ResponseCache.key(request.model_name,
                                          str(entry.version), inputs)
            hit = self.cache.lookup(cache_key)
            if hit is not None:
                entry.stats.record_cache_hit(now_ns() - t0)
                resp = self._postprocess(request, _response_from_outputs(
                    request, hit, str(entry.version)))
                if trace is not None:
                    trace.event(trace_mod.CACHE_HIT)
                    trace.event(trace_mod.REQUEST_END)
                    trace.add_tensors("output", resp.outputs)
                    self.tracer.release(trace)
                if response_callback is not None:
                    response_callback(resp, True)
                    return None
                return resp

        if response_callback is not None:
            def sink_cb(resp: InferResponse, final: bool) -> None:
                if resp.error is None and resp.outputs:
                    resp = self._postprocess(request, resp)
                if final and trace is not None:
                    trace.event(trace_mod.REQUEST_END)
                    if resp.error is None:
                        trace.add_tensors("output", resp.outputs)
                    self.tracer.release(trace)
                response_callback(resp, final)

            if trace is not None:
                trace.event(trace_mod.QUEUE_START)
            entry.scheduler.submit(Pending(request, sink_cb, inputs, trace))
            return None

        done = threading.Event()
        holder: list = []

        def sink(resp: InferResponse, final: bool) -> None:
            if resp.error is None and resp.outputs:
                resp = self._postprocess(request, resp)
            if final and trace is not None:
                trace.event(trace_mod.REQUEST_END)
                if resp.error is None:
                    trace.add_tensors("output", resp.outputs)
                self.tracer.release(trace)
            holder.append(resp)
            if final:
                done.set()

        if trace is not None:
            trace.event(trace_mod.QUEUE_START)
        entry.scheduler.submit(Pending(request, sink, inputs, trace))
        timeout = request.timeout_us / 1e6 if request.timeout_us else None
        if not done.wait(timeout=timeout):
            raise ServerError("inference request timed out", 504)
        resp = holder[-1]
        if resp.error is None and cache_key is not None:
            t0 = now_ns()
            self.cache.insert(cache_key,
                              {t.name: t.data for t in resp.outputs})
            entry.stats.record_cache_miss(now_ns() - t0)
        if resp.error is not None:
            raise ServerError(resp.error, resp.error_status,
                              retry_after=resp.retry_after_s)
        return resp

    # -- helpers --

    def _resolve_inputs(self, entry: _ModelEntry,
                        request: InferRequest) -> dict:
        """Wire tensors -> executable arrays (host numpy or device
        tensors), with the model config's names, datatypes and shapes
        enforced. A tensor input must already live on the model's device:
        it is never moved between devices (400)."""
        cfg = entry.model.config
        specs, required = cfg.input_spec_maps()
        inputs: dict = {}
        for t in request.inputs:
            spec = specs.get(t.name)
            if spec is None and required:
                raise ServerError(
                    f"unexpected input '{t.name}' for model '{cfg.name}'", 400)
            if spec is not None and t.datatype and spec.datatype != t.datatype:
                raise ServerError(
                    f"input '{t.name}' datatype {t.datatype} does not match "
                    f"model config datatype {spec.datatype}", 400)
            if t.device_array is not None:
                v = t.device_array
            elif t.data is not None:
                v = t.data
            elif t.shm_region is not None:
                v = self._read_shm_input(t)
            else:
                raise ServerError(
                    f"input '{t.name}' has no data, shared-memory region, "
                    "or device tensor", 400)
            if isinstance(v, torch.Tensor):
                want = entry.device if entry.device is not None else _CPU
                if v.device != want:
                    raise ServerError(
                        f"input '{t.name}' is a tensor on {v.device}; model "
                        f"'{cfg.name}' runs on {want} and moves no input "
                        "between devices", 400)
            inputs[t.name] = v
            self._check_shape(cfg, spec, t, v)
        missing = required - set(inputs)
        if missing:
            raise ServerError(
                f"missing required input(s) {sorted(missing)} for model "
                f"'{cfg.name}'", 400)
        return inputs

    def _read_shm_input(self, t: InferTensor):
        byte_size = getattr(t, "_shm_nbytes", None)
        if byte_size is None:
            if t.datatype == DataType.BYTES:
                byte_size = t.shm_byte_size
            else:
                byte_size = dtype_byte_size(t.datatype) \
                    * element_count(t.shape)
                if t.shm_byte_size and t.shm_byte_size < byte_size:
                    raise ServerError(
                        f"input '{t.name}' needs {byte_size} bytes but the "
                        f"shared-memory mapping is {t.shm_byte_size} bytes",
                        400)
            # reused request objects (the in-process perf path) skip the
            # recomputation per request
            t._shm_nbytes = byte_size
        region = t.shm_region
        cuda_att = self.cuda_shm.try_attachment(region)
        if cuda_att is not None:
            try:
                return cuda_att.read_array(t.shm_offset, byte_size,
                                           t.datatype, t.shape)
            except cudashm.CudaSharedMemoryException as e:
                raise ServerError(f"input '{t.name}': {e}", 500) from e
        raw = self.system_shm.read(region, t.shm_offset, byte_size)
        shape = tuple(int(d) for d in t.shape)
        if t.datatype == DataType.BYTES:
            return deserialize_bytes_tensor(bytes(raw)).reshape(shape)
        arr = np.frombuffer(raw, dtype=wire_to_np_dtype(t.datatype))
        return arr.reshape(shape)

    @staticmethod
    def _check_shape(cfg: ModelConfig, spec, t: InferTensor, arr) -> None:
        shape = tuple(int(d) for d in t.shape) if t.shape else tuple(arr.shape)
        if spec is None:
            return
        dims = tuple(spec.dims)
        expect_rank = len(dims) + (1 if cfg.max_batch_size > 0 else 0)
        if len(shape) != expect_rank:
            raise ServerError(
                f"input '{t.name}' shape {list(shape)} has rank "
                f"{len(shape)}; model expects rank {expect_rank}", 400)
        trailing = shape[1:] if cfg.max_batch_size > 0 else shape
        for got, want in zip(trailing, dims):
            if want >= 0 and got != want:
                raise ServerError(
                    f"input '{t.name}' shape {list(shape)} does not match "
                    f"model dims {list(dims)}", 400)

    def _postprocess(self, request: InferRequest,
                     resp: InferResponse) -> InferResponse:
        """Requested-output filtering, classification, shm output writes."""
        # cached on the request: frontends that reuse request objects (the
        # in-process perf path) skip rebuilding the map per request
        requested = getattr(request, "_requested_map", None)
        if requested is None:
            requested = {o.name: o for o in request.outputs}
            request._requested_map = requested
        outputs = resp.outputs
        if requested:
            missing = set(requested) - {t.name for t in outputs}
            if missing:
                resp.error = (f"requested output(s) {sorted(missing)} not "
                              f"produced by model '{request.model_name}'")
                resp.error_status = 400
                return resp
            outputs = [t for t in outputs if t.name in requested]
        final = []
        try:
            for t in outputs:
                ro = requested.get(t.name)
                if ro is not None and ro.classification_count > 0:
                    t = _classify(t, ro.classification_count)
                if ro is not None and ro.shm_region is not None:
                    t = self._write_shm_output(t, ro)
                elif isinstance(t.data, torch.Tensor):
                    t = InferTensor(name=t.name, datatype=t.datatype,
                                    shape=t.shape, data=_host(t.data))
                final.append(t)
        except ServerError as e:
            resp.error = str(e)
            resp.error_status = e.status
            return resp
        resp.outputs = final
        return resp

    def _write_shm_output(self, t: InferTensor, ro) -> InferTensor:
        """Store one output in the region ``ro`` names: a device tensor
        into a CUDA region stays on the device (no host round trip);
        anything else is written as bytes."""
        data = t.data
        att = self.cuda_shm.try_attachment(ro.shm_region)
        if att is not None:
            if isinstance(data, torch.Tensor):
                nbytes = data.element_size() * data.numel()
            elif t.datatype == DataType.BYTES:
                nbytes = len(tensor_to_bytes(data, t.datatype))
            else:
                nbytes = np.dtype(data.dtype).itemsize * int(
                    np.prod(data.shape))
            _check_output_size(t.name, nbytes, ro.shm_byte_size)
            try:
                att.write_array(ro.shm_offset, data)
            except cudashm.CudaSharedMemoryException as e:
                raise ServerError(f"output '{t.name}': {e}", 400) from e
        else:
            raw = (tensor_bytes(data) if isinstance(data, torch.Tensor)
                   else tensor_to_bytes(data, t.datatype))
            nbytes = len(raw)
            _check_output_size(t.name, nbytes, ro.shm_byte_size)
            self.system_shm.write(ro.shm_region, ro.shm_offset, raw)
        return InferTensor(name=t.name, datatype=t.datatype, shape=t.shape,
                           data=None, shm_region=ro.shm_region,
                           shm_offset=ro.shm_offset,
                           shm_byte_size=ro.shm_byte_size or nbytes)

    def _infer_ensemble(self, entry: _ModelEntry, request: InferRequest,
                        response_callback, arrival_ns: int,
                        trace=None) -> Optional[InferResponse]:
        """Run an ensemble's steps in config order, each an ``infer`` of
        its composing model; tensors flow through each step's
        ``input_map`` and ``output_map``. A traced ensemble's steps are
        child traces linked by ``parent_id``; an untraced one's are never
        sampled. The ensemble's own statistics row counts one execution:
        routing as compute_input, the steps as compute_infer, the output
        assembly as compute_output."""
        t_start = now_ns()
        if trace is not None:
            trace.event(trace_mod.QUEUE_START, t_start)
        cfg = entry.model.config
        pool: dict[str, InferTensor] = {t.name: t for t in request.inputs}
        queue_ns = now_ns() - arrival_ns
        prep_ns = 0
        infer_ns = 0
        try:
            for step in cfg.ensemble_steps:
                t_prep = now_ns()
                step_inputs = []
                for step_input, ensemble_name in step.input_map.items():
                    src = pool.get(ensemble_name)
                    if src is None:
                        raise ServerError(
                            f"ensemble tensor '{ensemble_name}' is not "
                            f"available for step '{step.model_name}'", 400)
                    step_inputs.append(InferTensor(
                        name=step_input, datatype=src.datatype,
                        shape=src.shape, data=src.data,
                        device_array=src.device_array,
                        shm_region=src.shm_region, shm_offset=src.shm_offset,
                        shm_byte_size=src.shm_byte_size))
                sub = InferRequest(
                    model_name=step.model_name,
                    model_version=(str(step.model_version)
                                   if step.model_version > 0 else ""),
                    id=request.id, inputs=step_inputs,
                    outputs=[], parameters=request.parameters,
                    sequence_id=request.sequence_id,
                    sequence_start=request.sequence_start,
                    sequence_end=request.sequence_end,
                    trace_parent=(trace if trace is not None
                                  else trace_mod.UNSAMPLED_PARENT))
                t_infer = now_ns()
                prep_ns += t_infer - t_prep
                sub_resp = self.infer(sub)
                infer_ns += now_ns() - t_infer
                for out in sub_resp.outputs:
                    mapped = step.output_map.get(out.name)
                    if mapped:
                        pool[mapped] = InferTensor(
                            name=mapped, datatype=out.datatype,
                            shape=out.shape, data=out.data)
            t_collect = now_ns()
            out_tensors = []
            for spec in cfg.outputs:
                t = pool.get(spec.name)
                if t is None:
                    raise ServerError(
                        f"ensemble did not produce output '{spec.name}'", 500)
                out_tensors.append(t)
            resp = InferResponse(model_name=request.model_name,
                                 model_version=str(entry.version),
                                 id=request.id, outputs=out_tensors)
            resp = self._postprocess(request, resp)
            collect_ns = now_ns() - t_collect
            total = now_ns() - arrival_ns
            entry.stats.record_execution(
                batch_size=(request.inputs[0].batch_size()
                            if request.inputs and cfg.max_batch_size > 0
                            else 1),
                num_requests=1, queue_ns_per_request=[queue_ns],
                compute_input_ns=prep_ns, compute_infer_ns=infer_ns,
                compute_output_ns=collect_ns,
                request_total_ns_each=[total])
            if trace is not None:
                trace.event(trace_mod.REQUEST_END)
                trace.add_tensors("output", resp.outputs)
                self.tracer.release(trace)
                trace = None  # released: the handler below must not
            if response_callback is not None:
                response_callback(resp, True)
                return None
            return resp
        except Exception as e:
            if isinstance(e, ServerError):
                entry.stats.record_failure(now_ns() - arrival_ns)
            if trace is not None:
                trace.event(trace_mod.REQUEST_END)
                self.tracer.release(trace)
            raise

    # ------------------------------------------------------------------

    def stop(self) -> None:
        """Stop serving: every scheduler and model, then the shm
        registries, then flush the buffered trace lines. A model with a
        terminal ``shutdown`` gets it instead of ``unload`` (which stages
        a fresh engine for a reload); one that raises does not keep the
        others or the shm cleanup from running."""
        self._live = False
        with self._lock:
            entries = [e for vs in self._models.values() for e in vs.values()]
        for e in entries:
            if e.scheduler:
                e.scheduler.stop()
            try:
                term = getattr(e.model, "shutdown", None)
                if callable(term):
                    term()
                else:
                    e.model.unload()
            except Exception:  # noqa: BLE001 — shutdown is best-effort
                log.exception("model '%s' failed to stop", e.model.name)
        self.system_shm.unregister_all()
        self.cuda_shm.unregister_all()
        # with log_frequency buffering, the file's tail is still in memory
        self.tracer.flush()


def _engine_healthy(model) -> bool:
    """True unless the model has an engine-liveness probe that says its
    engine thread died (a model without an engine is ready by its entry
    state alone); a probe that raises reads as down."""
    probe = getattr(model, "engine_healthy", None)
    if not callable(probe):
        return True
    try:
        return bool(probe())
    except Exception:  # noqa: BLE001 — a broken probe reads as down
        return False


def _accepts_arg(fn) -> bool:
    """True when ``fn`` takes at least one parameter (a factory that
    takes the load's config override)."""
    try:
        return len(inspect.signature(fn).parameters) >= 1
    except (TypeError, ValueError):
        return False


def _response_from_outputs(request: InferRequest, outputs: dict,
                           version: str) -> InferResponse:
    """A response built from cached host outputs."""
    tensors = []
    for name, arr in outputs.items():
        arr = np.asarray(arr)
        tensors.append(InferTensor(name=name,
                                   datatype=np_to_wire_dtype(arr.dtype),
                                   shape=tuple(arr.shape), data=arr))
    return InferResponse(model_name=request.model_name,
                         model_version=version, id=request.id,
                         outputs=tensors)


_CPU = torch.device("cpu")


def _host(data) -> np.ndarray:
    """A response tensor as a host array (device tensors are copied)."""
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def _check_output_size(name: str, nbytes: int, mapped: int) -> None:
    if mapped and nbytes > mapped:
        raise ServerError(
            f"output '{name}' needs {nbytes} bytes but the shared-memory "
            f"mapping is {mapped} bytes", 400)


def _classify(t: InferTensor, k: int) -> InferTensor:
    """v2 classification extension: top-k '<score>:<index>' BYTES strings."""
    arr = _host(t.data)
    k = min(k, arr.shape[-1])
    idx = np.argsort(-arr, axis=-1)[..., :k]
    scores = np.take_along_axis(arr, idx, axis=-1)
    flat_scores = scores.reshape(-1, k)
    flat_idx = idx.reshape(-1, k)
    labels = np.empty((flat_scores.shape[0], k), dtype=np.object_)
    for i in range(flat_scores.shape[0]):
        for j in range(k):
            labels[i, j] = f"{flat_scores[i, j]:f}:{flat_idx[i, j]}".encode()
    new_shape = arr.shape[:-1] + (k,)
    return InferTensor(name=t.name, datatype=DataType.BYTES,
                       shape=new_shape, data=labels.reshape(new_shape))
