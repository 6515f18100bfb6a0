"""The readings the limits of ``correct`` are set from, outside the
benchmark's own runs.

    python3 -m portbench.controls --workload <cell> --seeds 1,2,3 --seconds 10

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, then the program's reading of every number the cell
compares (``check``) and the control's (``control``: the reference
computed in fp8 in the program's place, on the same sample). One JSON
line per seed. ``--device cpu`` with ``--tiny`` rehearses it at a width a
test can hold."""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from portbench import env
from portbench.run import ROOT, load_json


def tiny(config: dict, workload: dict) -> tuple:
    """The cell at a width the CPU tests hold: two layers, narrow widths,
    a short context and light traffic; every knob keeps its meaning."""
    config, workload = json.loads(json.dumps(config)), dict(workload)
    if config["structure"]["kind"] == "encoder":
        config.update(hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=128,
                      vocab_size=512, max_position_embeddings=64)
        workload.update(seq=16, bucket=8, concurrency=16,
                        prompt_pool=64, warm_s=0.3, check_every=1,
                        check_max=64, trace_slice_s=0.5)
        workload["limits"] = dict(workload["limits"], compared={"min": 16})
    else:
        config.update(hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=128, vocab_size=512)
        config["serving"].update(max_seq=256, n_slots=4, chunk=4,
                                 kv_pool_blocks=64, kv_max_blocks_per_slot=16,
                                 prefill_chunk=32, prefill_token_budget=64)
        workload.update(clients=4, requests_per_client=4, warm_s=0.5,
                        check_tokens=40, trace_slice_s=0.5,
                        max_total=64,
                        prompt={"dist": "lognormal", "median": 20,
                                "sigma": 1.0, "lo": 8, "hi": 60},
                        output={"dist": "lognormal", "median": 8,
                                "sigma": 1.0, "lo": 4, "hi": 20})
        workload["limits"] = dict(workload["limits"], compared={"min": 20})
    return config, workload


def readings(name: str, seeds: list, seconds: float, device,
             small: bool = False) -> list:
    """Per seed: {"seed", "program": check(...), "control": control(...)}."""
    env.contain(ROOT)
    workload = load_json("workloads", name)
    config = load_json("configs", workload["config"])
    if small:
        config, workload = tiny(config, workload)
    driver = importlib.import_module(f"portbench.drivers.{workload['driver']}")
    out = []
    for seed in seeds:
        state = driver.setup(config, workload, seed, device)
        rec = driver.run(state, seconds)
        driver.release(state)
        out.append({"seed": seed, "program": driver.check(state, rec),
                    "control": driver.control(state, rec)})
        del state, rec
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    for row in readings(args.workload, seeds, args.seconds, device,
                        args.tiny):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
