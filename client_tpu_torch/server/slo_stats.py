"""Per-tenant and per-SLO-class serving statistics: the port's own copy of
``client_tpu/server/slo_stats.py`` (the port imports nothing of the JAX
package, even where a module has no JAX in it).

- :class:`WindowedQuantileSketch`: a bounded-memory sliding-window
  quantile estimator, a ring of per-interval counts over a fixed
  log-spaced bucket grid. ``quantile`` merges the intervals still inside
  the window and answers at the winning bucket's geometric midpoint, so
  its relative error is bounded by ``sqrt(growth) - 1``
  (:data:`SLO_QUANTILE_REL_ERROR`).
- :class:`SloStats`: per ``(tenant, slo_class)`` windowed TTFT,
  inter-token and queue-wait sketches, cumulative admission, shed,
  completion, cancel, deadline and failure counts, and the error-budget
  burn rate of each declared class over the window (the fraction of its
  requests that violated an objective, over ``1 - target_percentile /
  100``; 1.0 spends the budget exactly).

Tenant ids and class names come off the wire, so their cardinality is
capped: past ``max_tenants`` distinct tenants (and ``max_classes``
undeclared classes) later values collapse into :data:`OTHER_TENANT` and
are counted in ``tenant_overflow`` / ``class_overflow``. The engine stamps
the RESOLVED labels on the request, so every later record lands under one
key.

Stdlib and numpy only; thread-safe (engine and front-end threads write,
any thread reads).
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass

import numpy as np

# Defaults stamped on requests that carry no tenant/class parameters:
# every request is attributable, so the single-tenant server's plane
# degrades to one (default, best_effort) row instead of vanishing.
DEFAULT_TENANT = "default"
DEFAULT_SLO_CLASS = "best_effort"
# Collapse label for tenants beyond the cardinality cap.
OTHER_TENANT = "__other__"

# ----------------------------------------------------------------------
# bucket grid
# ----------------------------------------------------------------------

# Log-spaced bucket bounds in ns spanning the serving range 50us..120s.
# Growth 1.15 per bucket => a geometric-midpoint estimate is within
# sqrt(1.15) - 1 ~ 7.2% relative error of any value inside the bucket.
SLO_BUCKET_GROWTH = 1.15
_SLO_MIN_NS = 50_000          # 50 us
_SLO_MAX_NS = 120_000_000_000  # 120 s


def _make_bounds() -> tuple:
    bounds = []
    b = float(_SLO_MIN_NS)
    while b < _SLO_MAX_NS:
        bounds.append(b)
        b *= SLO_BUCKET_GROWTH
    bounds.append(float(_SLO_MAX_NS))
    return tuple(bounds)


SLO_BUCKETS_NS = _make_bounds()

# Documented accuracy contract of WindowedQuantileSketch.quantile for
# values within [_SLO_MIN_NS, _SLO_MAX_NS]: relative error bounded by
# sqrt(SLO_BUCKET_GROWTH) - 1 (values outside the grid clamp to its
# edges). tests/test_torch_slo_stats.py holds both packages' sketches to
# it against a sorted-array NumPy quantile.
SLO_QUANTILE_REL_ERROR = math.sqrt(SLO_BUCKET_GROWTH) - 1.0


def _bucket_estimates() -> np.ndarray:
    """Per-bucket point estimates (geometric midpoints): bucket 0 is
    [0, b0] (estimated at b0 / sqrt(g) — its log-space midpoint if its
    lower edge were b0/g), bucket j is (b[j-1], b[j]], the overflow
    bucket is estimated at the top edge times sqrt(g)."""
    b = np.asarray(SLO_BUCKETS_NS)
    root = math.sqrt(SLO_BUCKET_GROWTH)
    est = np.empty(len(b) + 1)
    est[0] = b[0] / root
    est[1:-1] = np.sqrt(b[:-1] * b[1:])
    est[-1] = b[-1] * root
    return est


_BUCKET_EST_NS = _bucket_estimates()


class WindowedQuantileSketch:
    """Sliding-window quantile estimates over a ring of per-interval
    fixed-bucket summaries.

    The window is split into ``intervals`` equal slices; each owns one
    row of bucket counts. An observation lands in the row of the
    current absolute interval number; a row whose interval has rotated
    out of the window is zeroed before reuse. ``quantile`` merges the
    rows still inside the window, so the effective lookback is between
    ``window_s - window_s/intervals`` and ``window_s``.

    NOT thread-safe on its own — SloStats serializes access.
    """

    __slots__ = ("_interval_s", "_counts", "_ids", "_clock")

    def __init__(self, window_s: float = 30.0, intervals: int = 10,
                 clock=time.monotonic):
        if window_s <= 0 or intervals < 1:
            raise ValueError("window_s must be > 0 and intervals >= 1")
        self._interval_s = window_s / intervals
        self._counts = np.zeros((intervals, len(SLO_BUCKETS_NS) + 1),
                                np.int64)
        # absolute interval number each row currently holds (-1 = empty)
        self._ids = np.full(intervals, -1, np.int64)
        self._clock = clock

    def _slot(self, now_interval: int) -> int:
        i = now_interval % len(self._ids)
        if self._ids[i] != now_interval:
            self._counts[i, :] = 0
            self._ids[i] = now_interval
        return i

    def observe(self, ns: float) -> None:
        k = int(self._clock() / self._interval_s)
        i = self._slot(k)
        j = int(np.searchsorted(SLO_BUCKETS_NS, max(0.0, float(ns)),
                                side="left"))
        self._counts[i, j] += 1

    def _live_counts(self) -> np.ndarray:
        k = int(self._clock() / self._interval_s)
        live = (self._ids > k - len(self._ids)) & (self._ids <= k)
        if not live.any():
            return np.zeros(self._counts.shape[1], np.int64)
        return self._counts[live].sum(axis=0)

    def count(self) -> int:
        """Observations currently inside the window."""
        return int(self._live_counts().sum())

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (ns) of the observations in the window,
        or 0.0 when the window is empty. Relative error is bounded by
        SLO_QUANTILE_REL_ERROR for values inside the bucket grid."""
        counts = self._live_counts()
        total = int(counts.sum())
        if total == 0:
            return 0.0
        rank = max(1, math.ceil(min(max(q, 0.0), 1.0) * total))
        j = int(np.searchsorted(np.cumsum(counts), rank, side="left"))
        return float(_BUCKET_EST_NS[j])

    def quantiles(self, qs=(0.5, 0.95, 0.99)) -> dict:
        """{q: estimate_ns} over ONE merged pass (a scrape asks for
        several quantiles of the same window)."""
        counts = self._live_counts()
        total = int(counts.sum())
        if total == 0:
            return {q: 0.0 for q in qs}
        cum = np.cumsum(counts)
        out = {}
        for q in qs:
            rank = max(1, math.ceil(min(max(q, 0.0), 1.0) * total))
            j = int(np.searchsorted(cum, rank, side="left"))
            out[q] = float(_BUCKET_EST_NS[j])
        return out


class _WindowedCounter:
    """Sliding-window (violations, total) pair on the same ring
    rotation as the sketch — feeds the error-budget burn rate."""

    __slots__ = ("_interval_s", "_vals", "_ids", "_clock")

    def __init__(self, window_s: float, intervals: int, clock):
        self._interval_s = window_s / intervals
        self._vals = np.zeros((intervals, 2), np.int64)  # [violations, total]
        self._ids = np.full(intervals, -1, np.int64)
        self._clock = clock

    def add(self, violated: bool) -> None:
        k = int(self._clock() / self._interval_s)
        i = k % len(self._ids)
        if self._ids[i] != k:
            self._vals[i, :] = 0
            self._ids[i] = k
        self._vals[i, 0] += 1 if violated else 0
        self._vals[i, 1] += 1

    def window(self) -> tuple:
        """(violations, total) inside the window."""
        k = int(self._clock() / self._interval_s)
        live = (self._ids > k - len(self._ids)) & (self._ids <= k)
        if not live.any():
            return 0, 0
        v = self._vals[live].sum(axis=0)
        return int(v[0]), int(v[1])


# ----------------------------------------------------------------------
# objectives + per-(tenant, class) aggregation
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class SloObjective:
    """One SLO class's latency objectives. A 0 target disables that
    axis; ``target_percentile`` is the percentile the targets apply to
    AND sets the error budget (p99 => 1% of requests may violate)."""

    ttft_ms: float = 0.0
    itl_ms: float = 0.0
    queue_wait_ms: float = 0.0
    target_percentile: float = 99.0

    def budget_fraction(self) -> float:
        return max(1e-9, 1.0 - self.target_percentile / 100.0)

    def violated(self, ttft_ns: float, itl_ns, queue_wait_ns: float) -> list:
        """Names of the objective axes this request violated (empty =
        met). ``itl_ns`` None = stream too short to define an ITL."""
        out = []
        if self.ttft_ms > 0 and ttft_ns > self.ttft_ms * 1e6:
            out.append("ttft")
        if self.itl_ms > 0 and itl_ns is not None \
                and itl_ns > self.itl_ms * 1e6:
            out.append("itl")
        if self.queue_wait_ms > 0 \
                and queue_wait_ns > self.queue_wait_ms * 1e6:
            out.append("queue_wait")
        return out


class _TenantClassStats:
    __slots__ = ("ttft", "inter_token", "queue_wait", "budget",
                 "admitted", "completed", "failed", "shed",
                 "cancelled", "deadline", "violations")

    def __init__(self, window_s: float, intervals: int, clock):
        self.ttft = WindowedQuantileSketch(window_s, intervals, clock)
        self.inter_token = WindowedQuantileSketch(window_s, intervals,
                                                  clock)
        self.queue_wait = WindowedQuantileSketch(window_s, intervals,
                                                 clock)
        self.budget = _WindowedCounter(window_s, intervals, clock)
        # cumulative attribution counters (monotonic).
        # cancelled/deadline are DISTINCT from failed: a client that
        # hangs up (or whose request deadline expired) is not a server
        # fault, and folding them together would poison burn triage.
        self.admitted = 0
        self.completed = 0
        self.failed = 0
        self.shed = 0
        self.cancelled = 0
        self.deadline = 0
        self.violations: dict = {}  # objective axis -> cumulative count


# scrape-side quantile set (matches the profiler's SLO percentiles)
SLO_QUANTILES = (0.5, 0.95, 0.99)


class SloStats:
    """Per-(tenant, slo_class) windowed latency quantiles, error-budget
    burn and admission/shed/failure attribution for one generation
    engine. The engine thread (and submit callers) write; any scrape
    thread reads via :meth:`snapshot`."""

    def __init__(self, objectives: dict | None = None,
                 window_s: float = 30.0, intervals: int = 10,
                 max_tenants: int = 32, max_classes: int = 8,
                 clock=time.monotonic):
        if max_tenants < 1 or max_classes < 1:
            raise ValueError("max_tenants/max_classes must be >= 1")
        self._lock = threading.Lock()
        self._objectives = dict(objectives or {})
        self._window_s = float(window_s)
        self._intervals = int(intervals)
        self._max_tenants = int(max_tenants)
        self._max_classes = int(max_classes)
        self._clock = clock
        self._stats: dict = {}       # (tenant, slo_class) -> _TenantClassStats
        self._tenants: set = set()   # distinct (un-collapsed) tenants seen
        # undeclared classes seen off the wire (declared objectives and
        # the default class are always admitted — their cardinality is
        # operator-controlled, not wire-controlled)
        self._classes: set = set()
        self.tenant_overflow = 0     # requests collapsed into OTHER_TENANT
        self.class_overflow = 0      # requests whose class collapsed

    # -- key resolution (the cardinality cap) --

    def resolve(self, tenant: str, slo_class: str) -> tuple:
        """Map wire (tenant_id, slo_class) to their labels: beyond
        ``max_tenants`` distinct tenants (resp. ``max_classes``
        distinct *undeclared* classes — declared objective classes and
        the default are operator-controlled and always admitted),
        later values collapse into OTHER_TENANT so neither wire
        dimension can mint unbounded label values or per-cell sketch
        memory. Callers stamp the RESOLVED labels on the request, so
        every later lifecycle record stays consistent."""
        with self._lock:
            if tenant not in self._tenants:
                if len(self._tenants) < self._max_tenants:
                    self._tenants.add(tenant)
                else:
                    self.tenant_overflow += 1
                    tenant = OTHER_TENANT
            if slo_class != DEFAULT_SLO_CLASS \
                    and slo_class not in self._objectives \
                    and slo_class not in self._classes:
                if len(self._classes) < self._max_classes:
                    self._classes.add(slo_class)
                else:
                    self.class_overflow += 1
                    slo_class = OTHER_TENANT
            return tenant, slo_class

    def resolve_tenant(self, tenant: str) -> str:
        """Tenant-only resolution (see :meth:`resolve`)."""
        return self.resolve(tenant, DEFAULT_SLO_CLASS)[0]

    def _cell(self, tenant: str, slo_class: str) -> _TenantClassStats:
        key = (tenant, slo_class)
        cell = self._stats.get(key)
        if cell is None:
            cell = _TenantClassStats(self._window_s, self._intervals,
                                     self._clock)
            self._stats[key] = cell
        return cell

    # -- lifecycle feeds --

    def record_admitted(self, tenant: str, slo_class: str) -> None:
        with self._lock:
            self._cell(tenant, slo_class).admitted += 1

    def record_shed(self, tenant: str, slo_class: str) -> None:
        with self._lock:
            self._cell(tenant, slo_class).shed += 1

    def record_queue_wait(self, tenant: str, slo_class: str,
                          ns: float) -> None:
        with self._lock:
            self._cell(tenant, slo_class).queue_wait.observe(max(0, ns))

    def record_ttft(self, tenant: str, slo_class: str, ns: float) -> None:
        with self._lock:
            self._cell(tenant, slo_class).ttft.observe(max(0, ns))

    def record_completion(self, tenant: str, slo_class: str,
                          ttft_ns: float, itl_ns,
                          queue_wait_ns: float) -> None:
        """A stream closed normally: feed the ITL sketch (``itl_ns``
        None = too short to define one) and settle the request against
        its class objective for the burn-rate window."""
        with self._lock:
            cell = self._cell(tenant, slo_class)
            cell.completed += 1
            if itl_ns is not None:
                cell.inter_token.observe(max(0, itl_ns))
            obj = self._objectives.get(slo_class)
            if obj is None:
                # undeclared class: tracked (quantiles, attribution)
                # but holds no objective, so it can never burn budget
                return
            axes = obj.violated(ttft_ns, itl_ns, queue_wait_ns)
            for axis in axes:
                cell.violations[axis] = cell.violations.get(axis, 0) + 1
            cell.budget.add(bool(axes))

    def record_failure(self, tenant: str, slo_class: str) -> None:
        with self._lock:
            self._cell(tenant, slo_class).failed += 1

    def record_cancelled(self, tenant: str, slo_class: str) -> None:
        """A stream was cancelled by its client mid-flight. Counted as
        its own outcome (not a failure): the burn window is untouched —
        a cancelled request never settled against its objective."""
        with self._lock:
            self._cell(tenant, slo_class).cancelled += 1

    def record_deadline(self, tenant: str, slo_class: str) -> None:
        """A stream hit its end-to-end request deadline. Its own
        outcome (not a failure) for the same triage reason."""
        with self._lock:
            self._cell(tenant, slo_class).deadline += 1

    # -- live control-plane reads (server/scheduling.py) --

    def class_burn(self, slo_class: str) -> float:
        """Live windowed error-budget burn rate of ONE class,
        aggregated across its tenants — the preemption trigger's
        signal (the per-tenant snapshot rows are the attribution view;
        a scheduler acts on the class as a whole). 0.0 for classes
        with no declared objective (they hold no budget to burn)."""
        obj = self._objectives.get(slo_class)
        if obj is None:
            return 0.0
        with self._lock:
            violations = total = 0
            for (_tenant, cls), cell in self._stats.items():
                if cls != slo_class:
                    continue
                v, t = cell.budget.window()
                violations += v
                total += t
        if not total:
            return 0.0
        return (violations / total) / obj.budget_fraction()

    def max_class_burn(self) -> float:
        """Max live windowed burn across every declared objective
        class — the feedback controller's scalar input (an engine
        trades throughput for latency when ANY declared class is
        burning, whoever the tenant). ONE locked pass over the cells:
        this runs once per engine dispatch round, so it must not pay
        classes-many lock acquisitions and rescans."""
        if not self._objectives:
            return 0.0
        with self._lock:
            acc: dict = {}  # class -> [violations, total]
            for (_tenant, cls), cell in self._stats.items():
                if cls not in self._objectives:
                    continue
                v, t = cell.budget.window()
                pair = acc.setdefault(cls, [0, 0])
                pair[0] += v
                pair[1] += t
        burn = 0.0
        for cls, (v, t) in acc.items():
            if t:
                burn = max(burn, (v / t)
                           / self._objectives[cls].budget_fraction())
        return burn

    # -- scrape --

    def snapshot(self) -> dict:
        """Point-in-time view for the engine's stats and
        ``core.debug_slo``: per-(tenant, class) windowed quantiles (ns),
        budget state, cumulative attribution; plus the cap state."""
        with self._lock:
            classes = {}
            for name, obj in self._objectives.items():
                classes[name] = {
                    "ttft_ms": obj.ttft_ms, "itl_ms": obj.itl_ms,
                    "queue_wait_ms": obj.queue_wait_ms,
                    "target_percentile": obj.target_percentile,
                }
            rows = []
            for (tenant, slo_class), cell in sorted(self._stats.items()):
                violations, total = cell.budget.window()
                obj = self._objectives.get(slo_class)
                budget = obj.budget_fraction() if obj else None
                frac = violations / total if total else 0.0
                rows.append({
                    "tenant": tenant,
                    "slo_class": slo_class,
                    "window": {
                        "ttft_ns": cell.ttft.quantiles(SLO_QUANTILES),
                        "inter_token_ns":
                            cell.inter_token.quantiles(SLO_QUANTILES),
                        "queue_wait_ns":
                            cell.queue_wait.quantiles(SLO_QUANTILES),
                        "requests": total,
                        "violating_requests": violations,
                        "violation_fraction": frac,
                        "burn_rate": (frac / budget
                                      if budget is not None else 0.0),
                    },
                    "admitted": cell.admitted,
                    "completed": cell.completed,
                    "failed": cell.failed,
                    "shed": cell.shed,
                    "cancelled": cell.cancelled,
                    "deadline": cell.deadline,
                    "violations": dict(cell.violations),
                })
            return {
                "window_s": self._window_s,
                "quantiles": list(SLO_QUANTILES),
                "quantile_rel_error": SLO_QUANTILE_REL_ERROR,
                "max_tenants": self._max_tenants,
                "max_classes": self._max_classes,
                "tenants_tracked": len(self._tenants),
                "tenant_overflow": self.tenant_overflow,
                "class_overflow": self.class_overflow,
                "classes": classes,
                "tenant_classes": rows,
            }


def objectives_from_configs(slo_classes) -> dict:
    """{class name: SloObjective} from config-layer SloClassConfig
    objects (or dicts with the same fields) — the bridge between the
    model config JSON's ``slo_classes`` block and this module."""
    out = {}
    for c in slo_classes or ():
        if isinstance(c, dict):
            fields = dict(c)
            name = fields.pop("name")
            out[name] = SloObjective(**fields)
        else:
            out[c.name] = SloObjective(
                ttft_ms=c.ttft_ms, itl_ms=c.itl_ms,
                queue_wait_ms=c.queue_wait_ms,
                target_percentile=c.target_percentile)
    return out
