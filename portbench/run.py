"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms the cell's served model (set-up), measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, ``breakdown`` on a traced run, and last
``checks``: each number compared beside its limit, which are also the
last lines of standard error.

Without a CUDA card (or with fewer than the cell asks for) it exits with
code 3 and prints no result; so it does when the process holds JAX or
the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# compared by the whole top-level name: the port's name begins with the
# JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "client_tpu")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    return json.loads((base / kind / f"{name}.json").read_text())


def reader(kind: str, name: str, base: Path = HERE):
    """The ``read`` function of ``<kind>/<name>.py`` (names hold dots)."""
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def needed_files(bench: dict, base: Path = HERE) -> set:
    """Every file the manifest's entries resolve to, by name alone: each
    cell's workload file, its configuration and its driver, and each
    metric's reader."""
    out = set()
    for w in bench["workloads"]:
        wl = load_json("workloads", w["name"], base)
        out |= {base / "workloads" / f"{w['name']}.json",
                base / "configs" / f"{wl['config']}.json",
                base / "drivers" / f"{wl['driver']}.py"}
    out |= {base / "e2e" / f"{m['name']}.py" for m in bench["end_to_end"]}
    out |= {base / "metrics" / f"{m['name']}.py" for m in bench["per_layer"]}
    return out


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries the cell reports: per-layer ones on a traced
    run, end-to-end ones otherwise."""
    rows = bench["per_layer" if trace else "end_to_end"]
    return [m for m in rows if cell in m.get("workloads", [cell])]


def judge(checks: dict, limits: dict) -> tuple:
    """(all within limits, {name: {value, limit, rule}}): a number passes
    when ``value <= max`` or ``value >= min``; a limited number the check
    did not produce fails."""
    out, ok = {}, True
    for name, lim in limits.items():
        rule, limit = next(iter(lim.items()))
        value = checks.get(name)
        good = value is not None and (value <= limit if rule == "max"
                                      else value >= limit)
        ok = ok and good
        out[name] = {"value": value, "limit": limit, "rule": rule}
    return ok, out


def power_limit() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload),
                 None)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {cards}", file=sys.stderr)
        return 3
    from portbench import env

    env.contain(ROOT)
    wl = load_json("workloads", args.workload)
    config = load_json("configs", wl["config"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = run_cell(bench, wl, config, args.seed, args.seconds,
                      bool(args.trace), dev)
    found = forbidden_modules()
    if found:
        print("the process holds JAX or the JAX package: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, j in result["checks"].items():
        sign = "<=" if j["rule"] == "max" else ">="
        print(f"check {name} {j['value']} {sign} {j['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run_cell(bench: dict, wl: dict, config: dict, seed: int,
             seconds: float, traced: bool, dev) -> dict:
    """One run of the cell ``wl`` on ``dev``: set-up, the window (traced
    or not), the check once the program's state is freed, and the
    reported metrics. Returns the result line's object. ``main`` calls it
    on the card only; the tests drive it on the CPU at a tiny width."""
    import torch

    from portbench import trace

    driver = importlib.import_module(f"portbench.drivers.{wl['driver']}")
    t_setup = time.perf_counter()
    state = driver.setup(config, wl, seed, dev)
    sl = trace.Slice() if traced else None
    rec = driver.run(state, seconds, sl)
    rec["setup_s"] = rec["window"]["t0"] - T_START
    parts = {"start_s": t_setup - T_START, **state["setup_parts"],
             "warm_s": float(wl["warm_s"])}
    print("setup_s " + " ".join(f"{k} {v:.3f}" for k, v in parts.items()),
          file=sys.stderr)
    if dev.type == "cuda":
        rec["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(dev), "count": 1,
                         "memory_peak_bytes": torch.cuda.max_memory_allocated(
                             dev),
                         "power_limit": power_limit()}
    else:
        rec["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    if sl is not None:
        rec["trace"] = sl.read()
        rec["device"]["busy_s"] = trace.busy_s(rec["trace"])
        rec["device"]["window_s"] = trace.window_s(rec["trace"])
    driver.release(state)
    ok, judged = judge(driver.check(state, rec), wl["limits"])
    metrics = {}
    for m in cell_metrics(bench, wl["name"], traced):
        value = reader("metrics" if traced else "e2e", m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": ok and rec["stragglers"] == 0,
              "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": rec["device"]}
    if sl is not None:
        result["breakdown"] = trace.breakdown(rec["trace"])
    result["checks"] = judged
    return result


if __name__ == "__main__":
    sys.exit(main())
