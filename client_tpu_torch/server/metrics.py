"""Prometheus metrics plane — dependency-free text-exposition registry.

The port's own copy of ``client_tpu/server/metrics.py`` (framework-free
there; the port imports nothing of the reference package), with the same
naming contract, families, labels and help text. The fleet
families (``client_tpu_fleet_*``) are registered when a model runs a
replica fleet, and the autoscale and canary families
(``client_tpu_autoscale_*``, ``client_tpu_canary_*``) when a fleet runs
the autoscaler (``server/autoscale.py``). The goodput
families are registered as the reference registers them; their MFU pair
only where the engine's card has a known peak (the H100; never on the
CPU). The runtime families (``client_tpu_runtime_*``) are registered
wherever a model carries a compile snapshot, the whole set at once (the
naming contract makes that namespace all or nothing), fed by the
``CompileWatch`` of every model and engine (``server/runtime_stats.py``,
where a compile is a CUDA-graph capture on the card); the device-memory
gauge only where this process holds memory on a card (never on the
CPU). The shared-memory gauges label the device plane ``kind="cuda"``
where the reference says ``"tpu"``.

Mirrors Triton's metrics extension (``GET /metrics`` in the Prometheus
text format 0.0.4): per-model inference counters and duration counters
fed from ``ModelStats``, a request-latency histogram, scheduler queue
depth / in-flight-batch gauges, response-cache hit/miss/eviction
counters, and shared-memory region gauges.

Two layers:

- ``MetricsRegistry`` + metric families: generic counters/gauges/
  histograms with labels, rendered to exposition text. Family names are
  validated at registration against the repo naming contract
  (``scripts/check_metrics_names.py`` lints the rendered output).
- ``collect_server_metrics(core)``: builds a fresh registry from a
  ``TorchInferenceServer`` on every scrape — zero hot-path instrumentation
  cost beyond the histogram buckets ``ModelStats`` already maintains.
"""

from __future__ import annotations

import re
import threading
import time
from bisect import bisect_right

from client_tpu_torch.server.runtime_stats import (
    COMPILE_BUCKETS_S,
    device_memory_stats,
)

# The naming contract, single source of truth for MetricFamily's
# registration check and the scripts/check_metrics_names.py lint.
NAME_RE = re.compile(r"^client_tpu_[a-z_]+(_total|_bytes|_seconds)?$")
COUNTER_SUFFIXES = ("_total", "_seconds", "_bytes")
HIST_SUFFIXES = ("_bucket", "_sum", "_count")

# Request-latency histogram bucket upper bounds, in seconds. Spans the
# realistic serving range: 100us (in-process cache hit) to 10s (stalled).
DEFAULT_BUCKETS_S = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# OpenMetrics exemplars — the histogram-bucket -> trace-id linkage.
# EXEMPLAR_FAMILIES is the complete registry of families allowed to
# render exemplars (all `_seconds` histograms; the lint checks both
# directions: no exemplar outside this set, every member suffixed
# `_seconds`). EXEMPLAR_CAP bounds rendered exemplars per family (the
# newest by wall-clock win), and EXEMPLAR_TRACE_ID_RE is the accepted
# trace-id label value shape — a propagated wire id that violates it
# is silently dropped from exposition rather than corrupting a line.
EXEMPLAR_FAMILIES = (
    "client_tpu_generation_ttft_seconds",
    "client_tpu_generation_inter_token_seconds",
    "client_tpu_generation_queue_wait_seconds",
)
EXEMPLAR_CAP = 10
EXEMPLAR_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._:-]{1,64}$")


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_labels(labelnames, labelvalues, extra: str = "") -> str:
    parts = [f'{n}="{_escape_label(v)}"'
             for n, v in zip(labelnames, labelvalues)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "count", "exemplars")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0
        # bucket idx -> (trace_id, observed_value_seconds, unix_ts);
        # rendered only for families in EXEMPLAR_FAMILIES
        self.exemplars: dict = {}

    def observe(self, value: float) -> None:
        self.counts[bisect_right(self.buckets, value)] += 1
        self.sum += value
        self.count += 1

    def load(self, counts, total_sum: float, count: int) -> None:
        """Adopt a pre-aggregated snapshot (the ModelStats feed)."""
        self.counts = list(counts)
        self.sum = total_sum
        self.count = count

    def load_exemplars(self, exemplars: dict) -> None:
        """Adopt per-bucket exemplars ({idx: (trace_id, value_seconds,
        unix_ts)}) from the stats-layer snapshot. Malformed trace ids
        (a propagated wire id can be anything) are dropped here so the
        exposition text stays parseable."""
        self.exemplars = {
            int(idx): ex for idx, ex in exemplars.items()
            if ex and EXEMPLAR_TRACE_ID_RE.match(str(ex[0]))}


# Collapse label for tenant values beyond a family's cardinality cap
# (mirrors slo_stats.OTHER_TENANT — the stats layer applies the same
# cap upstream; this one is the registration-path backstop).
TENANT_OVERFLOW_LABEL = "__other__"


class MetricFamily:
    """One named metric with a fixed label schema and per-label children.

    Families carrying a ``tenant`` label MUST be registered through
    the cardinality-capped path (``tenant_cap`` > 0): tenant ids come
    off the wire, and an uncapped tenant label would let a tenant-id
    flood mint unbounded exposition lines. Beyond ``tenant_cap``
    distinct tenant values, later ones collapse into
    ``TENANT_OVERFLOW_LABEL``. The ``replica`` label (the fleet
    families) rides the SAME capped path (``replica_cap`` > 0):
    replica ids are server-assigned, but scale-up mints new ones at
    runtime, so the exposition keeps the same hard bound discipline.
    ``scripts/check_metrics_names.py`` enforces the surface-wide twin
    of this rule on rendered output."""

    def __init__(self, name: str, help_text: str, kind: str,
                 labelnames=(), buckets=DEFAULT_BUCKETS_S,
                 tenant_cap: int = 0, replica_cap: int = 0):
        if not NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates the client_tpu naming "
                "contract (see scripts/check_metrics_names.py)")
        if kind == "counter" and not name.endswith(COUNTER_SUFFIXES):
            raise ValueError(
                f"counter {name!r} must end in _total, _seconds or _bytes")
        if "tenant" in labelnames and tenant_cap <= 0:
            raise ValueError(
                f"metric {name!r} carries a 'tenant' label and must be "
                "registered through the cardinality-capped path "
                "(tenant_cap > 0): wire-supplied tenant ids must never "
                "mint unbounded label values")
        if "replica" in labelnames and replica_cap <= 0:
            raise ValueError(
                f"metric {name!r} carries a 'replica' label and must be "
                "registered through the cardinality-capped path "
                "(replica_cap > 0): runtime-attached replicas must "
                "never mint unbounded label values")
        self.name = name
        self.help = help_text
        self.kind = kind  # counter | gauge | histogram
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self.tenant_cap = int(tenant_cap)
        self.replica_cap = int(replica_cap)
        self._tenant_idx = (self.labelnames.index("tenant")
                            if "tenant" in self.labelnames else -1)
        self._replica_idx = (self.labelnames.index("replica")
                             if "replica" in self.labelnames else -1)
        self._model_idx = (self.labelnames.index("model")
                           if "model" in self.labelnames else -1)
        # per-model seen sets: each model owns its own cap budget, so
        # one model's tenants can never collapse another's rows
        self._tenants_seen: dict = {}
        self._replicas_seen: dict = {}
        self._children: dict = {}
        self._lock = threading.Lock()

    def _cap_label(self, key: tuple, idx: int, cap: int,
                   seen_by_scope: dict) -> tuple:
        """Apply one capped label's cardinality bound to a label
        tuple, scoped per model label (caller holds the lock)."""
        value = key[idx]
        scope = key[self._model_idx] if self._model_idx >= 0 else ""
        seen = seen_by_scope.setdefault(scope, set())
        if value not in seen:
            if len(seen) >= cap:
                return key[:idx] + (TENANT_OVERFLOW_LABEL,) \
                    + key[idx + 1:]
            seen.add(value)
        return key

    def labels(self, *labelvalues, **labelkv):
        if labelkv:
            labelvalues = tuple(labelkv[n] for n in self.labelnames)
        key = tuple(str(v) for v in labelvalues)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name} expects labels {self.labelnames}")
        with self._lock:
            if self._tenant_idx >= 0 \
                    and key[self._tenant_idx] != TENANT_OVERFLOW_LABEL:
                key = self._cap_label(key, self._tenant_idx,
                                      self.tenant_cap,
                                      self._tenants_seen)
            if self._replica_idx >= 0 \
                    and key[self._replica_idx] != TENANT_OVERFLOW_LABEL:
                key = self._cap_label(key, self._replica_idx,
                                      self.replica_cap,
                                      self._replicas_seen)
            child = self._children.get(key)
            if child is None:
                child = (_Histogram(self.buckets)
                         if self.kind == "histogram" else _Scalar())
                self._children[key] = child
            return child

    def render(self, out: list) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            items = sorted(self._children.items())
        allowed = self._exemplars_to_render(items)
        for key, child in items:
            if self.kind == "histogram":
                acc = 0
                for i, (bound, n) in enumerate(zip(
                        tuple(self.buckets) + (float("inf"),),
                        child.counts)):
                    acc += n
                    lab = _fmt_labels(self.labelnames, key,
                                      f'le="{_fmt_value(bound)}"')
                    line = f"{self.name}_bucket{lab} {acc}"
                    ex = allowed.get((key, i))
                    if ex is not None:
                        # OpenMetrics exemplar: the bucket's most
                        # recent traced observation
                        line += (f' # {{trace_id="{ex[0]}"}} '
                                 f"{_fmt_value(ex[1])} "
                                 f"{ex[2]:.3f}")
                    out.append(line)
                lab = _fmt_labels(self.labelnames, key)
                out.append(f"{self.name}_sum{lab} {_fmt_value(child.sum)}")
                out.append(f"{self.name}_count{lab} {child.count}")
            else:
                lab = _fmt_labels(self.labelnames, key)
                out.append(f"{self.name}{lab} {_fmt_value(child.value)}")

    def _exemplars_to_render(self, items: list) -> dict:
        """{(label key, bucket idx): exemplar} for this family's
        exposition, empty unless the family is in EXEMPLAR_FAMILIES.
        At most EXEMPLAR_CAP across the family — newest wall-clock
        stamps win, so a scrape under cap pressure keeps the freshest
        trace linkage."""
        if self.kind != "histogram" or self.name not in EXEMPLAR_FAMILIES:
            return {}
        cands = [((key, idx), ex)
                 for key, child in items
                 for idx, ex in sorted(child.exemplars.items())]
        cands.sort(key=lambda kv: kv[1][2], reverse=True)
        return dict(cands[:EXEMPLAR_CAP])


class _Scalar:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def set(self, value: float) -> None:
        self.value = float(value)


class MetricsRegistry:
    def __init__(self):
        self._families: dict[str, MetricFamily] = {}

    def _register(self, name, help_text, kind, labelnames, buckets=None,
                  tenant_cap: int = 0, replica_cap: int = 0):
        if name in self._families:
            raise ValueError(f"metric {name!r} already registered")
        fam = MetricFamily(name, help_text, kind, labelnames,
                           buckets or DEFAULT_BUCKETS_S,
                           tenant_cap=tenant_cap,
                           replica_cap=replica_cap)
        self._families[name] = fam
        return fam

    def counter(self, name, help_text, labelnames=(),
                tenant_cap: int = 0, replica_cap: int = 0) -> MetricFamily:
        return self._register(name, help_text, "counter", labelnames,
                              tenant_cap=tenant_cap,
                              replica_cap=replica_cap)

    def gauge(self, name, help_text, labelnames=(),
              tenant_cap: int = 0, replica_cap: int = 0) -> MetricFamily:
        return self._register(name, help_text, "gauge", labelnames,
                              tenant_cap=tenant_cap,
                              replica_cap=replica_cap)

    def histogram(self, name, help_text, labelnames=(),
                  buckets=DEFAULT_BUCKETS_S) -> MetricFamily:
        return self._register(name, help_text, "histogram", labelnames,
                              buckets)

    def render(self) -> str:
        out: list = []
        for fam in self._families.values():
            fam.render(out)
        return "\n".join(out) + "\n"


# ----------------------------------------------------------------------
# server collection
# ----------------------------------------------------------------------

def collect_server_metrics(core) -> MetricsRegistry:
    """Build a scrape-time registry from a TorchInferenceServer. Counters
    mirror the monotonic ModelStats values, so successive scrapes behave
    exactly like natively-incremented Prometheus counters."""
    reg = MetricsRegistry()
    ml = ("model", "version")
    success = reg.counter("client_tpu_inference_request_success_total",
                          "Successful inference requests", ml)
    failure = reg.counter("client_tpu_inference_request_failure_total",
                          "Failed inference requests", ml)
    rejected = reg.counter("client_tpu_inference_request_rejected_total",
                           "Requests shed by admission control", ml)
    inferences = reg.counter("client_tpu_inference_count_total",
                             "Inferences (batch-1 units) performed", ml)
    executions = reg.counter("client_tpu_inference_exec_count_total",
                             "Model executions (batches) performed", ml)
    queue_s = reg.counter("client_tpu_queue_duration_seconds",
                          "Cumulative time requests spent queued", ml)
    in_s = reg.counter("client_tpu_compute_input_duration_seconds",
                       "Cumulative input-processing time", ml)
    infer_s = reg.counter("client_tpu_compute_infer_duration_seconds",
                          "Cumulative device-execution time", ml)
    out_s = reg.counter("client_tpu_compute_output_duration_seconds",
                        "Cumulative output-processing time", ml)
    latency = reg.histogram("client_tpu_request_duration_seconds",
                            "End-to-end request latency", ml)
    qdepth = reg.gauge("client_tpu_queue_depth",
                       "Requests waiting in the scheduler queue", ml)
    inflight = reg.gauge("client_tpu_inflight_batches",
                         "Batches dispatched and not yet completed", ml)
    live_seq = reg.gauge("client_tpu_live_sequences",
                         "Live stateful sequences", ml)

    with core._lock:
        entries = [(name, str(v), e)
                   for name, versions in core._models.items()
                   for v, e in versions.items()]
    gen_entries = []  # (name, version, generation snapshot)
    rt_entries = []   # (name, version, runtime-plane snapshot)
    fleet_entries = []  # (name, version, fleet snapshot)
    for name, version, entry in sorted(entries):
        gen = getattr(entry.model, "generation_stats", None)
        if callable(gen):
            try:
                gen_entries.append((name, version, gen()))
            except Exception:  # noqa: BLE001 — metrics are best-effort
                pass
        rt = getattr(entry.model, "runtime_observability", None)
        if callable(rt):
            try:
                rt_entries.append((name, version, rt()))
            except Exception:  # noqa: BLE001 — metrics are best-effort
                pass
        fl = getattr(entry.model, "fleet_snapshot", None)
        if callable(fl):
            try:
                fleet_entries.append((name, version, fl()))
            except Exception:  # noqa: BLE001 — metrics are best-effort
                pass
        st = entry.stats
        snap = st.snapshot()
        success.labels(name, version).set(snap["success_count"])
        failure.labels(name, version).set(snap["fail_count"])
        rejected.labels(name, version).set(snap["rejected_count"])
        inferences.labels(name, version).set(snap["inference_count"])
        executions.labels(name, version).set(snap["execution_count"])
        queue_s.labels(name, version).set(snap["queue_ns"] / 1e9)
        in_s.labels(name, version).set(snap["compute_input_ns"] / 1e9)
        infer_s.labels(name, version).set(snap["compute_infer_ns"] / 1e9)
        out_s.labels(name, version).set(snap["compute_output_ns"] / 1e9)
        counts, sum_ns, count = st.latency_histogram()
        latency.labels(name, version).load(counts, sum_ns / 1e9, count)
        sched = entry.scheduler
        if sched is not None:
            qdepth.labels(name, version).set(sched.queue_depth())
            inflight.labels(name, version).set(sched.inflight())
            seqs = getattr(sched, "live_sequences", None)
            if callable(seqs):
                live_seq.labels(name, version).set(seqs())

    if gen_entries:
        _collect_generation(reg, gen_entries)
        slo_entries = [(n, v, s["slo"]) for n, v, s in gen_entries
                       if s.get("slo") is not None]
        if slo_entries:
            _collect_slo(reg, slo_entries)
        sched_entries = [(n, v, s) for n, v, s in gen_entries
                         if s.get("scheduler") is not None]
        if sched_entries:
            _collect_sched(reg, sched_entries)
        gp_entries = [(n, v, s["goodput"]) for n, v, s in gen_entries
                      if s.get("goodput") is not None]
        if gp_entries:
            _collect_goodput(reg, gp_entries)
        wd_entries = [(n, v, s["watchdog"]) for n, v, s in gen_entries
                      if s.get("watchdog") is not None]
        if wd_entries:
            _collect_watchdog(reg, wd_entries)
    # only snapshots with a compile table: the runtime namespace is all or
    # nothing, and a model without a watch has no compile set to report
    rt_entries = [(n, v, s) for n, v, s in rt_entries
                  if "total_compiles" in s]
    if rt_entries:
        _collect_runtime(reg, rt_entries)
    if fleet_entries:
        _collect_fleet(reg, fleet_entries)
        # the autoscaler's families ride the same hook: its controller
        # adds the "autoscale" block to the model's fleet_snapshot()
        as_entries = [(n, v, s) for n, v, s in fleet_entries
                      if s.get("autoscale")]
        if as_entries:
            _collect_autoscale(reg, as_entries)

    # device memory gauges: registered only when a card reports stats (a
    # CPU server has none, and a family of permanent zeros would read as
    # "no pressure" instead of "not measured"); beside the compile set,
    # which the naming contract requires with them
    dev_stats = device_memory_stats() if rt_entries else []
    if dev_stats:
        mem = reg.gauge(
            "client_tpu_runtime_device_memory_bytes",
            "Per-device memory from PJRT memory_stats() (kind = "
            "in_use | peak | limit)", ("device", "kind"))
        for d in dev_stats:
            mem.labels(d["device"], "in_use").set(d["bytes_in_use"])
            mem.labels(d["device"], "peak").set(d["peak_bytes_in_use"])
            mem.labels(d["device"], "limit").set(d["bytes_limit"])

    cache = core.cache.stats()
    reg.counter("client_tpu_cache_hits_total",
                "Response cache hits").labels().set(cache["hits"])
    reg.counter("client_tpu_cache_misses_total",
                "Response cache misses").labels().set(cache["misses"])
    reg.counter("client_tpu_cache_evictions_total",
                "Response cache evictions").labels().set(cache["evictions"])
    reg.gauge("client_tpu_cache_entries",
              "Entries resident in the response cache").labels() \
        .set(cache["entries"])
    reg.gauge("client_tpu_cache_bytes",
              "Bytes resident in the response cache").labels() \
        .set(cache["bytes"])

    shm = reg.gauge("client_tpu_shm_regions",
                    "Registered shared-memory regions", ("kind",))
    shm_b = reg.gauge("client_tpu_shm_bytes",
                      "Bytes across registered shared-memory regions",
                      ("kind",))
    for kind, registry in (("system", core.system_shm),
                           ("cuda", core.cuda_shm)):
        count, nbytes = registry.metrics()
        shm.labels(kind).set(count)
        shm_b.labels(kind).set(nbytes)

    reg.gauge("client_tpu_uptime_seconds",
              "Seconds since server start").labels() \
        .set(time.time() - core._start_time)
    return reg


def _collect_runtime(reg: MetricsRegistry, rt_entries: list) -> None:
    """Compile + per-model memory families (registered only when at least
    one model carries a compile snapshot — a PyModel-only server has no
    compile set to report on), with the reference's names, labels and
    help text.

    Sources: CompileWatch snapshots (server/runtime_stats.py) around every
    watched entry point of TorchModel / SequenceModel / the continuous-
    batching engine (a compile is a CUDA-graph capture on the card, a
    first eager call per signature elsewhere), plus each engine's memory
    ledger. The serving invariant these families guard: after warmup
    seals a model's compile set, the unexpected-compiles counter stays
    0 — the perf profiler asserts exactly that per measurement window."""
    ml = ("model", "version")
    compile_h = reg.histogram(
        "client_tpu_runtime_compile_seconds",
        "XLA compile durations per jitted entry point (the kernel "
        "label names the watched entry point)", ml + ("kernel",),
        buckets=COMPILE_BUCKETS_S)
    compiles = reg.counter(
        "client_tpu_runtime_compiles_total",
        "XLA compiles observed (warmup + serving phases)", ml)
    unexpected = reg.counter(
        "client_tpu_runtime_unexpected_compiles_total",
        "Serving-phase XLA compiles after warmup declared the compile "
        "set closed — each one stalled every in-flight stream", ml)
    warm = reg.counter(
        "client_tpu_runtime_warmup_compiles_total",
        "XLA compiles during warmup (before seal): the sealed-set "
        "size the bucket grids — table widths, lane-batch x chunk "
        "buckets, the gamma ladder — multiply", ml)
    warm_s = reg.counter(
        "client_tpu_runtime_warmup_compile_seconds_total",
        "Wall seconds spent in warmup-phase XLA compiles (engine "
        "startup cost paid per build/restart, guarding ladder-grid "
        "explosion)", ml)
    mem = reg.gauge(
        "client_tpu_runtime_model_memory_bytes",
        "Per-model device-memory attribution (component = weights | "
        "kv_slots | kv_pool | draft_weights | draft_kv). Components "
        "are disjoint EXCEPT the paged-layout breakdown rows: paged "
        "engines drop the dead kv_slots row and export kv_pool_live "
        "| kv_pool_prefix | kv_pool_free, which subdivide the "
        "kv_pool total — do not sum them with it",
        ml + ("component",))
    for name, version, snap in rt_entries:
        # the cumulative per-kind histograms, not the capped debug table:
        # a recompile storm must not freeze the histogram at the table cap
        # while compiles_total keeps counting
        for kind, (counts, sum_s, count) in \
                (snap.get("hist") or {}).items():
            compile_h.labels(name, version, kind) \
                .load(counts, sum_s, count)
        compiles.labels(name, version).set(snap.get("total_compiles", 0))
        unexpected.labels(name, version) \
            .set(snap.get("unexpected_compiles", 0))
        warm.labels(name, version).set(snap.get("warmup_compiles", 0))
        warm_s.labels(name, version) \
            .set(snap.get("warmup_compile_seconds", 0.0))
        for component, nbytes in (snap.get("memory") or {}).items():
            mem.labels(name, version, component).set(nbytes)


def _collect_generation(reg: MetricsRegistry, gen_entries: list) -> None:
    """Token-level generation families (registered only when at least one
    model carries a generation engine — an add_sub-only server does not
    advertise TTFT histograms it can never fill).

    Sources: GenerationStats aggregates (server/stats.py, fed by the
    continuous-batching engine's request lifecycle) plus the engine's
    live gauges and per-phase wall accounting (_phase_s)."""
    ml = ("model", "version")
    ttft = reg.histogram(
        "client_tpu_generation_ttft_seconds",
        "Time from generation enqueue to first emitted token", ml)
    itl = reg.histogram(
        "client_tpu_generation_inter_token_seconds",
        "Mean inter-token latency per completed stream "
        "((last_emit - first_token) / (tokens - 1))", ml)
    qwait = reg.histogram(
        "client_tpu_generation_queue_wait_seconds",
        "Time from generation enqueue to slot admission", ml)
    tokens = reg.counter("client_tpu_generation_tokens_total",
                         "Tokens emitted by generation engines", ml)
    requests = reg.counter("client_tpu_generation_requests_total",
                           "Generation streams completed", ml)
    failures = reg.counter("client_tpu_generation_failures_total",
                           "Generation streams failed or shed at the "
                           "engine gate", ml)
    cancelled = reg.counter(
        "client_tpu_generation_cancelled_total",
        "Generation streams cancelled by their client (connection "
        "close / gRPC cancellation) — a distinct outcome, not a "
        "failure", ml)
    deadline = reg.counter(
        "client_tpu_generation_deadline_expired_total",
        "Generation streams terminated at their end-to-end request "
        "deadline (wire timeout parameter) — a distinct outcome, not "
        "a failure", ml)
    chunks = reg.counter("client_tpu_generation_chunks_total",
                         "Engine chunks dispatched to the device", ml)
    busy = reg.counter(
        "client_tpu_generation_slot_busy_seconds",
        "Time-weighted occupied-slot integral (divide by slots x window "
        "for occupancy)", ml)
    phase = reg.counter(
        "client_tpu_generation_engine_phase_seconds",
        "Engine-thread wall time by phase (admit/dispatch/prefill/"
        "retire_fetch/retire_deliver/pace, plus tier on host-tier "
        "engines)",
        ml + ("phase",))
    up = reg.gauge(
        "client_tpu_engine_up",
        "1 while the model's generation-engine thread is healthy; 0 "
        "after it died on an unexpected error (model readiness flips "
        "with it)", ml)
    # supervision families: present only for engines running under an
    # EngineSupervisor (advertise only what can move)
    sv_entries = [(n, v, s) for n, v, s in gen_entries
                  if s.get("supervisor") is not None]
    sv = {}
    if sv_entries:
        sv["restarts"] = reg.counter(
            "client_tpu_engine_restarts_total",
            "Supervised engine rebuilds completed after an engine-"
            "thread death (each one rebuilt the engine's device state)",
            ml)
        sv["crash_looped"] = reg.gauge(
            "client_tpu_engine_crash_looped",
            "1 once the crash-loop breaker tripped (max_failures "
            "engine deaths within window_s): the supervisor gave up "
            "and the model stays not-ready until an operator reload",
            ml)
    slots = reg.gauge("client_tpu_generation_slots",
                      "Configured engine slot-pool size", ml)
    active = reg.gauge("client_tpu_generation_active_slots",
                       "Slots currently holding a live stream", ml)
    qdepth = reg.gauge("client_tpu_generation_queue_depth",
                       "Generation requests awaiting a slot", ml)
    duty = reg.gauge("client_tpu_generation_dispatch_duty",
                     "Co-location dispatch-duty pacing knob", ml)

    # token-ring / deferred-retire families: present for engines that
    # report a ring snapshot (all overlapped-retire engines do)
    rg_entries = [(n, v, s) for n, v, s in gen_entries
                  if s.get("ring") is not None]
    rg = {}
    if rg_entries:
        rg["fetches"] = reg.counter(
            "client_tpu_generation_ring_fetches_total",
            "Batched D2H token-ring fetches drained (one per "
            "fetch_stride dispatches)", ml)
        rg["forced"] = reg.counter(
            "client_tpu_generation_ring_forced_fetches_total",
            "Ring fetches force-issued by ring-wrap backpressure "
            "(the ring is undersized for the configured stride)", ml)
        rg["lag"] = reg.gauge(
            "client_tpu_generation_ring_lag_chunks",
            "Dispatches enqueued ahead of the last retired ring fetch "
            "(device compute riding ahead of host token delivery)", ml)
        rg["stride"] = reg.gauge(
            "client_tpu_generation_ring_fetch_stride",
            "Configured dispatches per batched D2H ring fetch (1 = "
            "fetch every dispatch, incl. overlap-off engines)", ml)

    # prefill-lane families: present only for engines running the
    # chunked-prefill lane (prefill_mode="chunked") — a monolithic- or
    # token-prefill engine must not advertise lane counters that can
    # never move (same rule as the ring/speculation sets). The
    # tokens/chunks split is the profiler's prefill-share source.
    pf_entries = [(n, v, s) for n, v, s in gen_entries
                  if s.get("prefill_lane") is not None]
    pf = {}
    if pf_entries:
        pf["tokens"] = reg.counter(
            "client_tpu_generation_prefill_tokens_total",
            "Prompt tokens ingested by chunked-prefill lane dispatches "
            "(real tokens, bucket padding excluded)", ml)
        pf["chunks"] = reg.counter(
            "client_tpu_generation_prefill_chunks_total",
            "Resumable chunked-prefill lane dispatches (each ingests "
            "up to prefill_chunk prompt tokens riding the decode "
            "dispatch loop)", ml)

    # dedicated-prefill-lane families: present only for engines
    # running a DEDICATED prefill slot set (prefill_slots > 0) — a
    # piggyback-lane engine must not advertise lane-slot occupancy or
    # handoff counters that can never move (same rule as the
    # ring/speculation sets)
    dl_entries = [(n, v, s) for n, v, s in gen_entries
                  if (s.get("prefill_lane") or {}).get("dedicated")]
    dl = {}
    if dl_entries:
        dl["slots"] = reg.gauge(
            "client_tpu_generation_prefill_lane_slots",
            "Configured dedicated prefill-lane slot count "
            "(disaggregated prefill/decode)", ml)
        dl["active"] = reg.gauge(
            "client_tpu_generation_prefill_lane_active",
            "Prefill-lane slots currently ingesting a prompt", ml)
        dl["handoffs"] = reg.counter(
            "client_tpu_generation_prefill_lane_handoffs_total",
            "Prompts whose finished KV handed off from a prefill slot "
            "to a decode slot (paged: zero-copy block-table move)", ml)

    # batched-lane-dispatch families: present only for engines packing
    # multiple lane slots per dispatch (prefill_lane_batch >= 2) — a
    # round-robin lane must not advertise packing counters that can
    # never move (same advertise-only-what-can-move rule). Mean fill =
    # slots / dispatches; dispatch overhead per ingested token =
    # prefill_chunks / prefill_tokens — both scrape-side ratios of
    # histogram-free counters.
    lb_entries = [(n, v, s) for n, v, s in gen_entries
                  if (s.get("prefill_lane") or {}).get("lane_batch")]
    lb = {}
    if lb_entries:
        lb["width"] = reg.gauge(
            "client_tpu_generation_lane_batch_width",
            "Configured max lane slots one batched prefill-lane "
            "dispatch may pack (the B-ladder top)", ml)
        lb["dispatches"] = reg.counter(
            "client_tpu_generation_lane_batch_dispatches_total",
            "Batched multi-slot prefill-lane dispatches (one "
            "[B, lane_width] execution each)", ml)
        lb["slots"] = reg.counter(
            "client_tpu_generation_lane_batch_slots_total",
            "Lane slots packed across batched prefill-lane dispatches "
            "(divide by dispatches for the mean packing fill)", ml)

    # host-tier families: present only for engines with a host-RAM
    # prefix tier armed (host_tier_bytes > 0) — same
    # advertise-only-what-can-move rule
    tr_entries = [(n, v, s) for n, v, s in gen_entries
                  if s.get("kv_tier") is not None]
    tr = {}
    if tr_entries:
        tr["blocks"] = reg.gauge(
            "client_tpu_generation_tier_blocks",
            "Prefix blocks currently resident in the host-RAM tier "
            "(spilled from the device pool, restorable on a radix "
            "hit)", ml)
        tr["spills"] = reg.counter(
            "client_tpu_generation_tier_spills_total",
            "Prefix blocks spilled device->host on LRU eviction "
            "(async D2H; the trie node stays matchable)", ml)
        tr["restores"] = reg.counter(
            "client_tpu_generation_tier_restores_total",
            "Prefix blocks restored host->device by radix hits "
            "(H2D dispatched ahead of the resume's first lane chunk)",
            ml)
        tr["hits"] = reg.counter(
            "client_tpu_generation_tier_hits_total",
            "Prefix-cache admissions whose matched chain crossed "
            "tier-spilled blocks", ml)

    # paged-pool families: present only for engines running the paged
    # KV layout (kv_layout="paged") — a slot-layout engine has no
    # block occupancy to report (same advertise-only-what-can-move
    # rule as the ring/lane sets). The live/pinned/free split plus the
    # live-token gauge is the capacity dashboard: live tokens over
    # blocks x block_len is pool utilization, pinned is the prefix
    # cache's working set, free is admission headroom.
    pg_entries = [(n, v, s) for n, v, s in gen_entries
                  if s.get("kv_paged") is not None]
    pg = {}
    if pg_entries:
        pg["live_tokens"] = reg.gauge(
            "client_tpu_generation_pool_live_tokens",
            "KV rows resident in the block pool for live streams "
            "(paged layout: the pool is the only KV residence)", ml)
        pg["blocks_live"] = reg.gauge(
            "client_tpu_generation_pool_blocks_live",
            "Pool blocks privately held by live streams (paged "
            "layout)", ml)
        pg["blocks_pinned"] = reg.gauge(
            "client_tpu_generation_pool_blocks_pinned",
            "Pool blocks owned by the radix prefix index (committed "
            "prefixes; evictable unless pinned by a live match)", ml)
        pg["blocks_free"] = reg.gauge(
            "client_tpu_generation_pool_blocks_free",
            "Pool blocks on the free list (admission headroom; "
            "includes reservations not yet drawn)", ml)

    # speculation families exist only when at least one engine runs a
    # draft model — same advertise-only-what-can-move rule as below
    sp_entries = [(n, v, s) for n, v, s in gen_entries
                  if s.get("speculation") is not None]
    sp = {}
    if sp_entries:
        sp["proposed"] = reg.counter(
            "client_tpu_generation_spec_proposed_total",
            "Draft tokens proposed to speculative verify rounds", ml)
        sp["accepted"] = reg.counter(
            "client_tpu_generation_spec_accepted_total",
            "Draft tokens accepted by the parallel verification pass",
            ml)
        sp["rejected"] = reg.counter(
            "client_tpu_generation_spec_rejected_total",
            "Draft tokens rejected by the parallel verification pass",
            ml)
        sp["rounds"] = reg.counter(
            "client_tpu_generation_spec_rounds_total",
            "Speculative verify rounds retired (each emits accepted + "
            "1 tokens)", ml)
        sp["rate"] = reg.gauge(
            "client_tpu_generation_spec_acceptance_rate",
            "Rolling (EWMA) draft-acceptance rate of the engine's "
            "verify rounds", ml)
        sp["gamma"] = reg.gauge(
            "client_tpu_generation_spec_gamma",
            "LIVE verify-depth ceiling (set_speculation_gamma "
            "steering; per-round rung selection is bounded by it, 0 = "
            "speculation off)", ml)
        sp["rung_rounds"] = reg.counter(
            "client_tpu_generation_spec_rung_rounds_total",
            "Verify rounds retired at each gamma-ladder rung (the "
            "gamma label is the round's verify depth; rows per round "
            "= gamma + 1 is the verify-FLOP proxy)", ml + ("gamma",))

    # prefix-cache families exist only when at least one engine runs the
    # KV block pool — a pool-less server must not advertise hit rates it
    # can never produce (same rule as the generation families overall)
    pc_entries = [(n, v, s) for n, v, s in gen_entries
                  if s.get("prefix_cache") is not None]
    pc = {}
    if pc_entries:
        pc["hits"] = reg.counter(
            "client_tpu_generation_prefix_cache_hits_total",
            "Admissions that reused cached prefix KV blocks", ml)
        pc["misses"] = reg.counter(
            "client_tpu_generation_prefix_cache_misses_total",
            "Eligible admissions with no cached prefix", ml)
        pc["evictions"] = reg.counter(
            "client_tpu_generation_prefix_cache_evictions_total",
            "Prefix blocks evicted (LRU) under pool pressure", ml)
        pc["saved"] = reg.counter(
            "client_tpu_generation_prefix_cache_saved_tokens_total",
            "Prompt tokens restored from the pool instead of "
            "re-prefilled", ml)
        pc["commits"] = reg.counter(
            "client_tpu_generation_prefix_cache_commits_total",
            "Requests that committed prompt blocks back to the pool",
            ml)
        pc["blocks"] = reg.gauge(
            "client_tpu_generation_prefix_cache_blocks",
            "Usable KV block-pool capacity", ml)
        pc["used"] = reg.gauge(
            "client_tpu_generation_prefix_cache_blocks_used",
            "KV pool blocks currently holding indexed prefixes", ml)

    for name, version, snap in gen_entries:
        snap_exemplars = snap.get("exemplars") or {}
        for fam, key in ((ttft, "ttft"), (itl, "inter_token"),
                         (qwait, "queue_wait")):
            counts, sum_ns, count = snap[key]
            child = fam.labels(name, version)
            child.load(counts, sum_ns / 1e9, count)
            ex = snap_exemplars.get(key)
            if ex:
                # trace-linked exemplars exist only while tracing is
                # live (untraced observations never record one)
                child.load_exemplars({
                    idx: (tid, ns / 1e9, ts)
                    for idx, (tid, ns, ts) in ex.items()})
        tokens.labels(name, version).set(snap["tokens"])
        requests.labels(name, version).set(snap["completed"])
        failures.labels(name, version).set(snap["failed"])
        cancelled.labels(name, version).set(snap.get("cancelled", 0))
        deadline.labels(name, version).set(
            snap.get("deadline_expired", 0))
        sup = snap.get("supervisor")
        if sup is not None:
            sv["restarts"].labels(name, version).set(sup["restarts"])
            sv["crash_looped"].labels(name, version).set(
                1 if sup["crash_looped"] else 0)
        chunks.labels(name, version).set(snap["chunks_dispatched"])
        busy.labels(name, version).set(snap["slot_busy_ns"] / 1e9)
        for ph, secs in snap["phase_seconds"].items():
            phase.labels(name, version, ph).set(secs)
        up.labels(name, version).set(1 if snap.get("engine_up", True)
                                     else 0)
        slots.labels(name, version).set(snap["n_slots"])
        active.labels(name, version).set(snap["slots_active"])
        qdepth.labels(name, version).set(snap["queue_depth"])
        duty.labels(name, version).set(snap["dispatch_duty"])
        ring = snap.get("ring")
        if ring is not None:
            rg["fetches"].labels(name, version).set(snap["ring_fetches"])
            rg["forced"].labels(name, version) \
                .set(snap["ring_forced_fetches"])
            rg["lag"].labels(name, version).set(ring["lag_chunks"])
            rg["stride"].labels(name, version).set(ring["fetch_stride"])
        lane = snap.get("prefill_lane")
        if lane is not None:
            pf["tokens"].labels(name, version).set(snap["prefill_tokens"])
            pf["chunks"].labels(name, version).set(snap["prefill_chunks"])
            if lane.get("dedicated"):
                dl["slots"].labels(name, version).set(lane["slots"])
                dl["active"].labels(name, version).set(lane["active"])
                dl["handoffs"].labels(name, version) \
                    .set(snap["lane_handoffs"])
            if lane.get("lane_batch"):
                lb["width"].labels(name, version) \
                    .set(lane["lane_batch"])
                lb["dispatches"].labels(name, version) \
                    .set(snap["lane_batch_dispatches"])
                lb["slots"].labels(name, version) \
                    .set(snap["lane_batch_slots"])
        tier = snap.get("kv_tier")
        if tier is not None:
            tr["blocks"].labels(name, version).set(tier["blocks"])
            tr["spills"].labels(name, version).set(tier["spills"])
            tr["restores"].labels(name, version).set(tier["restores"])
            tr["hits"].labels(name, version).set(snap["tier_hits"])
        paged = snap.get("kv_paged")
        if paged is not None:
            pg["live_tokens"].labels(name, version) \
                .set(paged["live_tokens"])
            pg["blocks_live"].labels(name, version) \
                .set(paged["blocks_live"])
            pg["blocks_pinned"].labels(name, version) \
                .set(paged["blocks_pinned"])
            pg["blocks_free"].labels(name, version) \
                .set(paged["blocks_free"])
        spec = snap.get("speculation")
        if spec is not None:
            sp["proposed"].labels(name, version).set(snap["spec_proposed"])
            sp["accepted"].labels(name, version).set(snap["spec_accepted"])
            sp["rejected"].labels(name, version).set(snap["spec_rejected"])
            sp["rounds"].labels(name, version).set(snap["spec_rounds"])
            sp["rate"].labels(name, version).set(spec["acceptance_rate"])
            sp["gamma"].labels(name, version) \
                .set(spec.get("gamma_ceiling", spec.get("gamma", 0)))
            # seed every compiled rung at 0 so the per-rung family is
            # complete from the first scrape (a rung that never ran is
            # an honest 0, not a missing series)
            rung_rounds = snap.get("spec_rung_rounds") or {}
            for rung in spec.get("ladder") or sorted(rung_rounds):
                sp["rung_rounds"].labels(name, version, str(rung)) \
                    .set(rung_rounds.get(rung, 0))
        pool = snap.get("prefix_cache")
        if pool is not None:
            pc["hits"].labels(name, version).set(snap["prefix_hits"])
            pc["misses"].labels(name, version).set(snap["prefix_misses"])
            pc["evictions"].labels(name, version).set(pool["evictions"])
            pc["saved"].labels(name, version) \
                .set(snap["prefix_saved_tokens"])
            pc["commits"].labels(name, version).set(pool["commits"])
            pc["blocks"].labels(name, version).set(pool["blocks"])
            pc["used"].labels(name, version).set(pool["blocks_used"])


def _collect_goodput(reg: MetricsRegistry, gp_entries: list) -> None:
    """Goodput and device-time attribution families
    (``client_tpu_goodput_*``), registered only when at least one engine
    carries a GoodputTracker snapshot (server/goodput.py): per-kind
    cadence-attributed device seconds, the opt-in synchronous sample, and
    the analytical useful/wasted FLOP decomposition. The MFU and peak
    gauges are registered only when some engine knows its card's peak (a
    card of the port's peak table); on the CPU they stay absent: an MFU
    against an unknown denominator would be a made-up number."""
    ml = ("model", "version")
    dispatches = reg.counter(
        "client_tpu_goodput_dispatches_total",
        "Sealed device dispatches per kernel kind (chunk / "
        "paged_decode / spec_g<rung> / lane_chunk / lane_batch<B> / "
        "prefill / handoff / gather / scatter)", ml + ("kernel",))
    dev_s = reg.counter(
        "client_tpu_goodput_device_seconds_total",
        "Device time attributed per kernel kind by the ring-fetch "
        "cadence (wall between drains split over the dispatches "
        "issued in between; sums to busy wall by construction)",
        ml + ("kernel",))
    dev_h = reg.histogram(
        "client_tpu_goodput_device_time_seconds",
        "Per-dispatch attributed device time per kernel kind (same "
        "bucket grid as the compile histogram so the two planes "
        "overlay)", ml + ("kernel",), buckets=COMPILE_BUCKETS_S)
    useful = reg.counter(
        "client_tpu_goodput_useful_flops_total",
        "Analytical-model FLOPs spent on live tokens at their real "
        "context length, per kernel kind", ml + ("kernel",))
    wasted = reg.counter(
        "client_tpu_goodput_wasted_flops_total",
        "Analytical-model FLOPs spent on rows/columns that produced "
        "nothing (reason = padding | frozen | table_slack | "
        "spec_reject)", ml + ("kernel", "reason"))
    sampled = reg.counter(
        "client_tpu_goodput_sampled_dispatches_total",
        "Dispatches additionally timed by the opt-in synchronous "
        "sampling mode (a CUDA event recorded behind the dispatch's "
        "kernels, waited on)", ml)
    sampling_share = reg.gauge(
        "client_tpu_goodput_sampling_share",
        "Fraction of dispatches synchronously sampled (bounded by "
        "1/sample_every; 0 when sampling is off)", ml)
    useful_share = reg.gauge(
        "client_tpu_goodput_useful_flop_share",
        "useful / (useful + wasted) FLOPs over the engine lifetime — "
        "the goodput ratio the profiler gate watches", ml)
    device_share = reg.gauge(
        "client_tpu_goodput_device_time_share",
        "Attributed device seconds over engine wall seconds "
        "(1 - idle share)", ml)
    # advertise only what can move: MFU needs a known peak denominator
    has_peak = any(s.get("peak_flops") for _, _, s in gp_entries)
    mfu = peak_g = None
    if has_peak:
        mfu = reg.gauge(
            "client_tpu_goodput_mfu",
            "Live model FLOP utilization: useful FLOPs/s over the "
            "sliding rate window divided by the card's dense peak "
            "FLOPs (absent on the CPU / unknown cards)", ml)
        peak_g = reg.gauge(
            "client_tpu_goodput_device_peak_flops",
            "Dense bf16 peak FLOP/s of the engine's card (the MFU "
            "denominator)", ml)
    for name, version, snap in gp_entries:
        for kind, n in (snap.get("dispatches") or {}).items():
            dispatches.labels(name, version, kind).set(n)
        for kind, ns in (snap.get("device_ns") or {}).items():
            dev_s.labels(name, version, kind).set(ns / 1e9)
        for kind, (counts, sum_s, count) in \
                (snap.get("device_time_hist") or {}).items():
            dev_h.labels(name, version, kind).load(counts, sum_s, count)
        for kind, flops in (snap.get("useful_flops") or {}).items():
            useful.labels(name, version, kind).set(flops)
        for kind, reasons in (snap.get("wasted_flops") or {}).items():
            for reason, flops in reasons.items():
                wasted.labels(name, version, kind, reason).set(flops)
        sampled.labels(name, version).set(snap.get("sampled_total", 0))
        sampling_share.labels(name, version) \
            .set(snap.get("sampling_share", 0.0))
        useful_share.labels(name, version) \
            .set(snap.get("useful_flop_share", 1.0))
        device_share.labels(name, version) \
            .set(snap.get("device_time_share", 0.0))
        if has_peak and snap.get("peak_flops"):
            peak_g.labels(name, version).set(snap["peak_flops"])
            mfu.labels(name, version).set(snap.get("mfu") or 0.0)


def _collect_slo(reg: MetricsRegistry, slo_entries: list) -> None:
    """Per-tenant / per-SLO-class families (``client_tpu_slo_*``),
    registered only when at least one model carries an SLO stats plane
    (engine-backed generation models do).

    Source: SloStats snapshots (server/slo_stats.py). Every tenant-
    labeled family is registered through the cardinality-capped path —
    the stats layer already collapsed tenants beyond its cap into
    ``__other__``, and the registration cap backstops that invariant
    at the exposition layer. Windowed quantities (latency quantiles,
    burn rate, window request counts) are gauges: they describe the
    sliding window, not a monotonic history."""
    ml = ("model", "version")
    tl = ml + ("tenant", "slo_class")
    cap = max(s.get("max_tenants", 32) for _n, _v, s in slo_entries) + 1
    lat = reg.gauge(
        "client_tpu_slo_window_latency_seconds",
        "Windowed per-(tenant, slo_class) latency quantile (kind = "
        "ttft | inter_token | queue_wait; quantile = p50 | p95 | p99; "
        "sliding window, not cumulative)",
        tl + ("kind", "quantile"), tenant_cap=cap)
    burn = reg.gauge(
        "client_tpu_slo_error_budget_burn_rate",
        "Windowed fraction of the class's requests violating its "
        "objective, divided by its error budget (1 - "
        "target_percentile/100): 1.0 consumes the budget exactly, "
        ">1 burns it down", tl, tenant_cap=cap)
    win_req = reg.gauge(
        "client_tpu_slo_window_requests",
        "Requests settled against their SLO objective inside the "
        "sliding window", tl, tenant_cap=cap)
    admitted = reg.counter(
        "client_tpu_slo_admitted_total",
        "Generation requests accepted into the engine, by tenant and "
        "SLO class", tl, tenant_cap=cap)
    requests = reg.counter(
        "client_tpu_slo_requests_total",
        "Generation streams completed, by tenant and SLO class", tl,
        tenant_cap=cap)
    shed = reg.counter(
        "client_tpu_slo_shed_total",
        "Requests shed by the engine (shutdown gate or full-queue "
        "overload), by tenant and SLO class — the server half of the "
        "perf harness's client/server reject split", tl,
        tenant_cap=cap)
    failures = reg.counter(
        "client_tpu_slo_failures_total",
        "Generation streams failed in flight, by tenant and SLO "
        "class", tl, tenant_cap=cap)
    cancelled = reg.counter(
        "client_tpu_slo_cancelled_total",
        "Generation streams cancelled by their client, by tenant and "
        "SLO class (distinct from failures: not a server fault, and "
        "never settled against the error budget)", tl, tenant_cap=cap)
    deadline = reg.counter(
        "client_tpu_slo_deadline_expired_total",
        "Generation streams terminated at their end-to-end request "
        "deadline, by tenant and SLO class (distinct from failures)",
        tl, tenant_cap=cap)
    violations = reg.counter(
        "client_tpu_slo_violations_total",
        "Requests that violated their SLO class objective, by "
        "objective axis (ttft | itl | queue_wait)",
        tl + ("objective",), tenant_cap=cap)
    tenants = reg.gauge(
        "client_tpu_slo_tenants",
        "Distinct tenants tracked before the cardinality cap "
        "collapses later ones into __other__", ml)
    overflow = reg.counter(
        "client_tpu_slo_tenant_overflow_total",
        "Requests whose tenant was collapsed into __other__ by the "
        "cardinality cap", ml)

    q_label = {0.5: "p50", 0.95: "p95", 0.99: "p99"}
    kinds = (("ttft_ns", "ttft"), ("inter_token_ns", "inter_token"),
             ("queue_wait_ns", "queue_wait"))
    for name, version, snap in slo_entries:
        tenants.labels(name, version).set(snap.get("tenants_tracked", 0))
        overflow.labels(name, version).set(
            snap.get("tenant_overflow", 0))
        for row in snap.get("tenant_classes", ()):
            t, c = row["tenant"], row["slo_class"]
            win = row["window"]
            for key, kind in kinds:
                for q, est_ns in win[key].items():
                    lat.labels(name, version, t, c, kind,
                               q_label.get(float(q), str(q))) \
                        .set(est_ns / 1e9)
            burn.labels(name, version, t, c).set(win["burn_rate"])
            win_req.labels(name, version, t, c).set(win["requests"])
            admitted.labels(name, version, t, c).set(row["admitted"])
            requests.labels(name, version, t, c).set(row["completed"])
            shed.labels(name, version, t, c).set(row["shed"])
            failures.labels(name, version, t, c).set(row["failed"])
            cancelled.labels(name, version, t, c).set(
                row.get("cancelled", 0))
            deadline.labels(name, version, t, c).set(
                row.get("deadline", 0))
            for axis, count in row.get("violations", {}).items():
                violations.labels(name, version, t, c, axis).set(count)


def _collect_sched(reg: MetricsRegistry, sched_entries: list) -> None:
    """Closed-loop scheduler families (``client_tpu_sched_*``),
    registered only when at least one engine runs the SLO scheduler
    (server/scheduling.py) — a scheduler-less engine must not
    advertise preemption counters that can never move.

    Source: the ``scheduler`` block of the engine's generation
    snapshot. The per-(tenant, slo_class) attribution families go
    through the SAME cardinality-capped registration path as the
    ``client_tpu_slo_*`` set (the stats layer resolved tenants through
    the SloStats cap upstream; the registration cap backstops it).
    The controller knob gauges are per-model: LIVE values of the
    dynamic knobs the feedback controller steers — a burn-spike
    incident review needs to see what the controller actually did."""
    ml = ("model", "version")
    tl = ml + ("tenant", "slo_class")
    cap = max((s.get("slo") or {}).get("max_tenants", 32)
              for _n, _v, s in sched_entries) + 1
    preempt = reg.counter(
        "client_tpu_sched_preemptions_total",
        "Running streams preempted by the SLO scheduler (KV committed "
        "to the pool, request re-queued with its generation folded "
        "into the prompt), by the PREEMPTED stream's tenant and SLO "
        "class", tl, tenant_cap=cap)
    resumes = reg.counter(
        "client_tpu_sched_resumes_total",
        "Preempted streams re-admitted through the prefix-restore + "
        "chunked-prefill resume path, by tenant and SLO class", tl,
        tenant_cap=cap)
    qdepth = reg.gauge(
        "client_tpu_sched_fair_queue_depth",
        "Requests waiting in the weighted-fair admission queue, by "
        "(tenant, slo_class) flow", tl, tenant_cap=cap)
    knob_budget = reg.gauge(
        "client_tpu_sched_prefill_token_budget",
        "LIVE chunked-prefill lane per-round token budget (the "
        "feedback controller's latency mode shrinks it to its floor; "
        "0 on engines without the lane)", ml)
    knob_stride = reg.gauge(
        "client_tpu_sched_fetch_stride",
        "LIVE dispatches per batched D2H ring fetch (the controller's "
        "latency mode drops it to 1 to cut token-delivery lag; the "
        "configured bound is the ring_fetch_stride gauge's ceiling)",
        ml)
    knob_duty = reg.gauge(
        "client_tpu_sched_dispatch_duty",
        "LIVE co-location dispatch-duty pacing knob (the controller's "
        "latency mode raises it to 1.0)", ml)
    knob_spec = reg.gauge(
        "client_tpu_sched_spec_enabled",
        "1 while speculative verify rounds are enabled for subsequent "
        "dispatch rounds; 0 while the controller's latency mode holds "
        "them off (greedy output is identical either way)", ml)

    def _split(key: str) -> tuple:
        # tenant/class labels are [A-Za-z0-9._:-]+ (types.TENANT_ID_RE)
        # so "/" is an unambiguous separator
        tenant, _, cls = key.partition("/")
        return tenant, cls

    for name, version, snap in sched_entries:
        sched = snap["scheduler"]
        for key, n in sched.get("preemptions", {}).items():
            t, c = _split(key)
            preempt.labels(name, version, t, c).set(n)
        for key, n in sched.get("resumes", {}).items():
            t, c = _split(key)
            resumes.labels(name, version, t, c).set(n)
        for key, n in sched.get("queue_depths", {}).items():
            t, c = _split(key)
            qdepth.labels(name, version, t, c).set(n)
        knobs = sched.get("knobs", {})
        knob_budget.labels(name, version).set(
            knobs.get("prefill_token_budget", 0))
        knob_stride.labels(name, version).set(
            knobs.get("fetch_stride", 0))
        knob_duty.labels(name, version).set(
            knobs.get("dispatch_duty", 0))
        knob_spec.labels(name, version).set(
            1 if knobs.get("speculation_enabled", True) else 0)



def _collect_fleet(reg: MetricsRegistry, fleet_entries: list) -> None:
    """Replica-fleet router families (``client_tpu_fleet_*``),
    registered only when at least one model runs a ReplicaFleet
    (server/fleet.py) — a single-engine model must not advertise
    routing counters that can never move.

    Source: the model's ``fleet_snapshot()``. Every per-replica
    family goes through the capped-cardinality ``replica`` label path
    (cap = configured replicas + scale-up headroom); the
    ``client_tpu_fleet_replicas`` gauge is the cap's observable, the
    same contract the tenant-labeled namespaces keep with
    ``client_tpu_slo_tenants``."""
    ml = ("model", "version")
    rl = ml + ("replica",)
    # scale-up attaches replicas at runtime: cap at the live count
    # plus headroom so a runaway attach loop cannot mint unbounded
    # exposition rows (later replicas collapse into the overflow
    # label like overflowing tenants do)
    cap = max(s.get("replicas", 1) for _n, _v, s in fleet_entries) + 8
    replicas = reg.gauge(
        "client_tpu_fleet_replicas",
        "Engine replicas configured in the fleet (the replica-label "
        "cardinality cap's observable)", ml)
    healthy = reg.gauge(
        "client_tpu_fleet_healthy",
        "1 while the replica's engine (and supervisor) report "
        "healthy; 0 once its engine thread died or its crash-loop "
        "breaker tripped (the router excludes it)", rl,
        replica_cap=cap)
    draining = reg.gauge(
        "client_tpu_fleet_draining",
        "1 while the replica is draining (router excluded, in-flight "
        "streams finishing ahead of the engine swap)", rl,
        replica_cap=cap)
    qdepth = reg.gauge(
        "client_tpu_fleet_queue_depth",
        "Requests queued on the replica's engine awaiting a slot",
        rl, replica_cap=cap)
    active = reg.gauge(
        "client_tpu_fleet_active_slots",
        "Slots currently holding a live stream on the replica", rl,
        replica_cap=cap)
    routed = reg.counter(
        "client_tpu_fleet_routed_total",
        "Generation submits the router admitted to this replica", rl,
        replica_cap=cap)
    rerouted = reg.counter(
        "client_tpu_fleet_rerouted_total",
        "Submits re-routed AWAY from this replica (its 503 gate "
        "bounced the submit, or it held the warm prefix while "
        "unhealthy/draining)", rl, replica_cap=cap)
    affinity = reg.counter(
        "client_tpu_fleet_affinity_hits_total",
        "Routing decisions this replica won on prefix affinity (its "
        "sketch held the prompt's longest warm leading-block chain)",
        rl, replica_cap=cap)
    drains = reg.counter(
        "client_tpu_fleet_drains_total",
        "Completed drain-swaps of this replica (admission stopped, "
        "streams finished, fresh engine staged)", rl, replica_cap=cap)
    for name, version, snap in fleet_entries:
        replicas.labels(name, version).set(snap.get("replicas", 0))
        for row in snap.get("rows", ()):
            r = str(row["replica"])
            healthy.labels(name, version, r).set(
                1 if row.get("healthy") else 0)
            draining.labels(name, version, r).set(
                1 if row.get("draining") else 0)
            qdepth.labels(name, version, r).set(
                row.get("queue_depth", 0))
            active.labels(name, version, r).set(
                row.get("active_slots", 0))
            routed.labels(name, version, r).set(row.get("routed", 0))
            rerouted.labels(name, version, r).set(
                row.get("rerouted", 0))
            affinity.labels(name, version, r).set(
                row.get("affinity_hits", 0))
            drains.labels(name, version, r).set(row.get("drains", 0))


def _collect_autoscale(reg: MetricsRegistry,
                       as_entries: list) -> None:
    """Fleet autoscaler and canary rollout families
    (``client_tpu_autoscale_*`` / ``client_tpu_canary_*``), registered
    only when at least one fleet runs the controller
    (``server/autoscale.FleetController``): a fleet without an autoscale
    policy advertises no actuation counters that can never move.

    Source: the ``autoscale`` block the controller adds to
    ``fleet_snapshot()``, and the fleet's live ``canary`` block. The
    per-replica gauges take the capped ``replica`` label path of
    ``client_tpu_fleet_*`` (cap = live replicas + scale-up
    headroom)."""
    ml = ("model", "version")
    rl = ml + ("replica",)
    cap = max(s.get("replicas", 1) for _n, _v, s in as_entries) + 8
    rounds = reg.counter(
        "client_tpu_autoscale_rounds_total",
        "Control rounds the fleet autoscaler has run (its step "
        "cadence observable)", ml)
    ups = reg.counter(
        "client_tpu_autoscale_scale_ups_total",
        "Replicas the autoscaler attached (warmed + sealed before "
        "routing) on sustained burn/queue pressure", ml)
    downs = reg.counter(
        "client_tpu_autoscale_scale_downs_total",
        "Replicas the autoscaler drained and detached on sustained "
        "idle (zero failed streams per drain)", ml)
    pressure = reg.counter(
        "client_tpu_autoscale_pressure_events_total",
        "Times the autoscaler dropped a burning replica's preempt-"
        "burn threshold (the escalation ladder's rung between knob "
        "steering and scale-up)", ml)
    flips = reg.counter(
        "client_tpu_autoscale_steer_flips_total",
        "Latency/throughput mode transitions across the autoscaler's "
        "per-replica in-engine knob controllers", ml)
    burn = reg.gauge(
        "client_tpu_autoscale_burn",
        "Fleet max windowed per-class error-budget burn at the last "
        "control round (the scale-up signal; 1.0 = budget exactly "
        "consumed)", ml)
    queue = reg.gauge(
        "client_tpu_autoscale_queue_depth",
        "Mean queued requests per admitting replica at the last "
        "control round (the other scale-up signal)", ml)
    rmin = reg.gauge(
        "client_tpu_autoscale_replicas_min",
        "Lower replica bound the autoscaler will not drain below", ml)
    rmax = reg.gauge(
        "client_tpu_autoscale_replicas_max",
        "Upper replica bound the autoscaler will not attach above",
        ml)
    cooldown = reg.gauge(
        "client_tpu_autoscale_cooldown_active",
        "1 while the post-actuation cooldown suppresses further "
        "scale verbs (the anti-flap gate)", ml)
    rep_burn = reg.gauge(
        "client_tpu_autoscale_replica_burn",
        "Windowed max per-class burn per replica at the last control "
        "round (the per-replica steering/pressure signal)", rl,
        replica_cap=cap)
    rep_pressured = reg.gauge(
        "client_tpu_autoscale_replica_pressured",
        "1 while the autoscaler holds this replica's preempt-burn "
        "threshold down (pressure rung engaged)", rl,
        replica_cap=cap)
    c_active = reg.gauge(
        "client_tpu_canary_active",
        "1 while a canary rollout is in flight (one replica at the "
        "new version taking the tenant-hash split)", ml)
    c_split = reg.gauge(
        "client_tpu_canary_split_pct",
        "Percent of tenants (by stable hash) routed to the live "
        "canary replica (0 with no rollout in flight)", ml)
    c_routed = reg.counter(
        "client_tpu_canary_routed_total",
        "Submits routed to the live canary replica this rollout "
        "(resets when the rollout settles — the judge's min-requests "
        "floor observable)", ml)
    c_promote = reg.counter(
        "client_tpu_canary_promotions_total",
        "Canary rollouts auto-promoted on clean SLO gates (stable "
        "set drain-swapped onto the new version)", ml)
    c_rollback = reg.counter(
        "client_tpu_canary_rollbacks_total",
        "Canary rollouts auto-rolled-back on a breached gate (canary "
        "drained + detached, zero failed streams)", ml)
    for name, version, snap in as_entries:
        a = snap["autoscale"]
        sig = a.get("last_signals", {})
        rounds.labels(name, version).set(a.get("rounds", 0))
        ups.labels(name, version).set(a.get("scale_ups", 0))
        downs.labels(name, version).set(a.get("scale_downs", 0))
        pressure.labels(name, version).set(
            a.get("pressure_events", 0))
        flips.labels(name, version).set(a.get("steer_flips", 0))
        burn.labels(name, version).set(sig.get("burn", 0.0))
        queue.labels(name, version).set(sig.get("queue_depth", 0.0))
        rmin.labels(name, version).set(a.get("min_replicas", 0))
        rmax.labels(name, version).set(a.get("max_replicas", 0))
        cooldown.labels(name, version).set(
            1 if a.get("cooldown_active") else 0)
        pressured = set(a.get("pressured_replicas", ()))
        for idx, p in sig.get("per_replica", {}).items():
            r = str(idx)
            rep_burn.labels(name, version, r).set(p.get("burn", 0.0))
            rep_pressured.labels(name, version, r).set(
                1 if idx in pressured else 0)
        canary = snap.get("canary")
        c_active.labels(name, version).set(1 if canary else 0)
        c_split.labels(name, version).set(
            canary["split_pct"] if canary else 0)
        c_routed.labels(name, version).set(
            canary["routed"] if canary else 0)
        c_promote.labels(name, version).set(a.get("promotions", 0))
        c_rollback.labels(name, version).set(a.get("rollbacks", 0))


def _collect_watchdog(reg: MetricsRegistry, wd_entries: list) -> None:
    """Watchdog / incident-plane families (``client_tpu_watchdog_*``),
    registered only when at least one engine runs the watchdog
    (server/watchdog.py) — an engine built with ``watchdog=False`` must
    not advertise incident counters that can never move.

    Source: the ``watchdog`` block of the generation snapshot. Every
    detector row is seeded at zero, so "no incidents yet" differs from
    "watchdog off" on the scrape side. The per-detector counts come from
    the incident store, which outlives supervised engine restarts, so the
    counter stays monotone across a crash."""
    from client_tpu_torch.server.watchdog import DETECTORS, INCIDENT_KINDS

    ml = ("model", "version")
    dl = ml + ("detector",)
    samples = reg.counter(
        "client_tpu_watchdog_samples_total",
        "Watchdog detector evaluations (accepted metric-history "
        "samples) across the model's engines", ml)
    incidents = reg.counter(
        "client_tpu_watchdog_incidents_total",
        "Incident bundles recorded per detector (anomaly detectors "
        "plus the promoted engine_death bundle); counts live on the "
        "restart-surviving incident store", dl)
    active = reg.gauge(
        "client_tpu_watchdog_detector_active",
        "1 while the detector's episode is open (it fired and has "
        "not yet seen enough consecutive healthy samples to clear)",
        dl)
    depth = reg.gauge(
        "client_tpu_watchdog_incident_ring_depth",
        "Incident bundles resident in the bounded in-process ring "
        "(capacity-bounded; evictions count as drops)", ml)
    dropped = reg.counter(
        "client_tpu_watchdog_incidents_dropped_total",
        "Incident bundles evicted from the full in-process ring "
        "(still in the spill file when one is configured)", ml)
    for name, version, wd in wd_entries:
        samples.labels(name, version).set(wd.get("samples", 0))
        store = wd.get("store") or {}
        counts = store.get("counts") or {}
        for det in INCIDENT_KINDS:
            incidents.labels(name, version, det).set(counts.get(det, 0))
        dets = wd.get("detectors") or {}
        for det in DETECTORS:
            st = dets.get(det) or {}
            active.labels(name, version, det).set(
                1 if st.get("active") else 0)
        depth.labels(name, version).set(store.get("depth", 0))
        dropped.labels(name, version).set(store.get("dropped_total", 0))


def render_server_metrics(core) -> str:
    return collect_server_metrics(core).render()


# ----------------------------------------------------------------------
# scrape-side parsing (the perf profiler and the naming lint)
# ----------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)(?:\s+\d+)?"
    r"(?:\s+#\s+\{(?P<exlabels>[^}]*)\}\s+(?P<exvalue>\S+)"
    r"(?:\s+(?P<exts>-?\d+(?:\.\d+)?))?)?$")
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")


def _unescape_label(value: str) -> str:
    # single pass so '\\n' (escaped backslash + n) is not misread as a
    # newline escape
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), value)


def parse_prometheus_text(text: str) -> dict:
    """Parse exposition text into {families: {name: {type, help}},
    samples: [(name, {label: value}, float)], exemplars: [(name,
    {label: value}, {labels, value, ts})]}. Samples stay 3-tuples (the
    profiler and tests unpack them); OpenMetrics exemplar suffixes on
    bucket lines land in the separate ``exemplars`` list. Raises
    ValueError on any malformed line — used both by the profiler scrape
    and the tests that assert /metrics validity line by line."""
    families: dict = {}
    samples: list = []
    exemplars: list = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 4:
                raise ValueError(f"line {lineno}: malformed HELP: {line!r}")
            families.setdefault(parts[2], {})["help"] = parts[3]
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            families.setdefault(parts[2], {})["type"] = parts[3]
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        labels = {k: _unescape_label(v)
                  for k, v in _LABEL_RE.findall(m.group("labels") or "")}
        raw = m.group("value")
        value = float("inf") if raw == "+Inf" else \
            float("-inf") if raw == "-Inf" else float(raw)
        samples.append((m.group("name"), labels, value))
        if m.group("exlabels") is not None:
            ex_labels = {k: _unescape_label(v)
                         for k, v in _LABEL_RE.findall(
                             m.group("exlabels"))}
            exemplars.append((m.group("name"), labels, {
                "labels": ex_labels,
                "value": float(m.group("exvalue")),
                "ts": (float(m.group("exts"))
                       if m.group("exts") else None),
            }))
    return {"families": families, "samples": samples,
            "exemplars": exemplars}


def sample_value(parsed: dict, name: str, labels: dict | None = None):
    """First sample matching name and (subset of) labels, else None."""
    labels = labels or {}
    for n, labs, value in parsed["samples"]:
        if n == name and all(labs.get(k) == v for k, v in labels.items()):
            return value
    return None
