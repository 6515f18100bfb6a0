"""The traced slice of a run: ``torch.profiler`` over a steady stretch of
the measured window, held in memory, reduced to kernel intervals, the
host's activity, the device's busy time and the run's ``breakdown``.

CUPTI is turned on and off with the program's CUDA graph launches held
(``runtime_stats.graph_launches_paused``): switching it while another
thread launches a graph can hang the process."""

from __future__ import annotations

import time

from portbench import stats

_GEMM_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
_HIDDEN_HOST = ("ProfilerStep", "[memory]", "PyTorch Profiler")


def kernel_group(name: str) -> str:
    """The group a device operation's time is reported under."""
    low = name.lower()
    if "flash_fwd" in low:
        return "K1 flash_attention"
    if "paged_decode_kernel" in low:
        return "K2 paged_attention"
    if any(mark in low for mark in _GEMM_MARKS):
        return "matmul"
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for cut in ("<", "("):
        name = name.split(cut, 1)[0]
    return name.strip()[:64] or "other"


class Slice:
    """One profiled stretch: ``start()``, then ``stop()``, then ``read()``.
    ``t0``/``t1`` are its edges on the host's ``perf_counter`` (the clock
    of the drivers' request logs)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        try:
            from torch._C._profiler import _ExperimentalConfig

            # the serving threads' host ops, not only this thread's
            config = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            config = None
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             experimental_config=config)
        self.t0 = self.t1 = None
        self._ns = [None, None]

    def start(self) -> None:
        from client_tpu_torch.server.runtime_stats import graph_launches_paused

        with graph_launches_paused():
            self._prof.start()
            self.t0, self._ns[0] = time.perf_counter(), time.time_ns()

    def stop(self) -> None:
        from client_tpu_torch.server.runtime_stats import graph_launches_paused

        with graph_launches_paused():
            self.t1, self._ns[1] = time.perf_counter(), time.time_ns()
            self._prof.stop()

    def read(self) -> dict:
        """{"kernels": [(name, start_ns, end_ns)], "host": [...],
        "start_ns", "end_ns", "t0", "t1"}: every device operation and
        every host event the profiler kept, on its clock (ns since the
        epoch), and the slice's edges on both clocks."""
        from torch.autograd import DeviceType

        kernels, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            dur = e.duration_ns()
            if dur <= 0:
                continue
            row = (e.name(), e.start_ns(), e.start_ns() + dur)
            if e.device_type() == DeviceType.CUDA:
                kernels.append(row)
            elif not row[0].startswith(_HIDDEN_HOST):
                host.append(row)
        return {"kernels": kernels, "host": host, "start_ns": self._ns[0],
                "end_ns": self._ns[1], "t0": self.t0, "t1": self.t1}


def busy_s(trace: dict) -> float:
    """Seconds of the slice in which some device operation ran."""
    lo, hi = trace["start_ns"], trace["end_ns"]
    clipped = [(max(s, lo), min(e, hi)) for _, s, e in trace["kernels"]
               if e > lo and s < hi]
    return stats.union_length(clipped) / 1e9


def window_s(trace: dict) -> float:
    return (trace["end_ns"] - trace["start_ns"]) / 1e9


def kernel_seconds(trace: dict, group: str) -> tuple:
    """(launches, device seconds) of the kernels of one group."""
    rows = [(s, e) for name, s, e in trace["kernels"]
            if kernel_group(name) == group]
    return len(rows), sum(e - s for s, e in rows) / 1e9


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, by group, and the
    longest idle gaps, each named by the host event that overlaps it
    most (the shortest such event on a tie)."""
    by_group: dict = {}
    for name, s, e in trace["kernels"]:
        g = kernel_group(name)
        by_group[g] = by_group.get(g, 0.0) + (e - s) / 1e9
    ops = sorted(by_group.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = trace["start_ns"], trace["end_ns"]
    idle = stats.gaps([(s, e) for _, s, e in trace["kernels"]], lo, hi)[:top]
    host = sorted(trace["host"], key=lambda r: r[1])
    named = []
    for g0, g1 in idle:
        best, best_key = "none", None
        for name, s, e in host:
            if s >= g1:
                break
            over = min(e, g1) - max(s, g0)
            if over > 0:
                key = (over, -(e - s))
                if best_key is None or key > best_key:
                    best, best_key = name, key
        named.append([best, (g1 - g0) / 1e9])
    return {"device_ops": [[g, s] for g, s in ops], "idle_gaps": named}
