"""The port's per-tenant SLO statistics (client_tpu_torch.server.slo_stats)
held against the JAX package's copy on the same feeds.

- Under a fake clock, the same seeded sequence of lifecycle records
  (admissions, sheds, queue waits, TTFTs, completions against declared
  objectives, cancels, deadlines, failures; a tenant flood past the cap)
  gives equal snapshots, burns and resolved labels, with the window
  rolling over several times.
- Both sketches stay within the stated relative-error bound
  (``SLO_QUANTILE_REL_ERROR``, sqrt(1.15) - 1) of a sorted-array numpy
  quantile for values inside the bucket grid, and return the same
  estimate.
- ``objectives_from_configs`` reads config objects and dicts alike.

Tolerance: snapshots and estimates exact (the same float arithmetic on
the same inputs); against numpy, the stated bound.
"""

import math

import numpy as np
import pytest

from client_tpu.server import slo_stats as jslo
from client_tpu_torch.server import config as tconfig
from client_tpu_torch.server import slo_stats as tslo


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def _objectives(mod):
    return {"gold": mod.SloObjective(ttft_ms=50.0, itl_ms=5.0,
                                     target_percentile=95.0),
            "silver": mod.SloObjective(queue_wait_ms=20.0)}


def _drive(mod, seed: int) -> list:
    clock = FakeClock()
    st = mod.SloStats(_objectives(mod), window_s=4.0, intervals=8,
                      max_tenants=6, max_classes=3, clock=clock)
    rng = np.random.default_rng(seed)
    trace = []
    classes = ["gold", "silver", "best_effort", "x1", "x2", "x3", "x4"]
    for step in range(1500):
        clock.t += float(rng.exponential(0.02))
        tenant = f"t{int(rng.integers(0, 10))}"
        cls = classes[int(rng.integers(len(classes)))]
        tenant, cls = st.resolve(tenant, cls)
        op = int(rng.integers(8))
        ns = float(rng.lognormal(17.0, 1.5))
        if op == 0:
            st.record_admitted(tenant, cls)
        elif op == 1:
            st.record_shed(tenant, cls)
        elif op == 2:
            st.record_queue_wait(tenant, cls, ns)
        elif op == 3:
            st.record_ttft(tenant, cls, ns)
        elif op == 4:
            itl = None if rng.random() < 0.2 else ns / 40
            st.record_completion(tenant, cls, ns, itl, ns / 3)
        elif op == 5:
            st.record_cancelled(tenant, cls)
        elif op == 6:
            st.record_deadline(tenant, cls)
        else:
            st.record_failure(tenant, cls)
        if step % 100 == 0:
            trace.append((tenant, cls, st.class_burn("gold"),
                          st.class_burn("silver"), st.max_class_burn(),
                          st.snapshot()))
    trace.append(st.snapshot())
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_feeds_give_equal_snapshots(seed):
    assert _drive(tslo, seed) == _drive(jslo, seed)


def test_bounds_and_constants_are_the_reference():
    assert tslo.SLO_BUCKETS_NS == jslo.SLO_BUCKETS_NS
    assert tslo.SLO_QUANTILE_REL_ERROR == jslo.SLO_QUANTILE_REL_ERROR
    assert tslo.SLO_QUANTILE_REL_ERROR == pytest.approx(
        math.sqrt(1.15) - 1.0)
    assert (tslo.DEFAULT_TENANT, tslo.DEFAULT_SLO_CLASS,
            tslo.OTHER_TENANT) == (jslo.DEFAULT_TENANT,
                                   jslo.DEFAULT_SLO_CLASS,
                                   jslo.OTHER_TENANT)


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "bimodal"])
def test_sketches_stay_within_the_stated_bound(dist):
    rng = np.random.default_rng(7)
    if dist == "lognormal":
        vals = rng.lognormal(18.0, 2.0, size=4000)
    elif dist == "uniform":
        vals = rng.uniform(1e5, 5e10, size=4000)
    else:
        vals = np.concatenate([rng.normal(2e6, 1e5, 2000),
                               rng.normal(3e9, 1e8, 2000)])
    vals = np.clip(vals, 6e4, 1.1e11)
    clock = FakeClock()
    sketches = [mod.WindowedQuantileSketch(30.0, 10, clock)
                for mod in (tslo, jslo)]
    for v in vals:
        for sk in sketches:
            sk.observe(v)
    srt = np.sort(vals)
    for q in (0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999):
        exact = srt[max(1, math.ceil(q * len(srt))) - 1]
        got, want = (sk.quantile(q) for sk in sketches)
        assert got == want
        assert abs(got - exact) / exact \
            <= tslo.SLO_QUANTILE_REL_ERROR + 1e-12, (q, got, exact)
    assert sketches[0].quantiles() == sketches[1].quantiles()
    assert sketches[0].count() == len(vals)
    # the window forgets
    clock.t += 31.0
    assert sketches[0].count() == 0 and sketches[0].quantile(0.5) == 0.0


def test_objectives_from_configs_reads_configs_and_dicts():
    rows = [tconfig.SloClassConfig("gold", ttft_ms=50.0),
            {"name": "silver", "itl_ms": 7.0, "target_percentile": 90.0}]
    got = tslo.objectives_from_configs(rows)
    assert got == {"gold": tslo.SloObjective(ttft_ms=50.0),
                   "silver": tslo.SloObjective(itl_ms=7.0,
                                               target_percentile=90.0)}
    assert tslo.objectives_from_configs(None) == {}
    with pytest.raises(ValueError):
        tslo.SloStats(max_tenants=0)
