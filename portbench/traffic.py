"""Seeded traffic: the length draw every mix shares, and the rule that
keeps the work of a run the same from seed to seed.

A mix fixes its sizes with its own ``sizes_seed``: every run draws the
same sequences of (prompt, output) lengths, and the run's ``--seed`` only
deals the sequences to the clients in another order and draws the token
ids."""

from __future__ import annotations

import math

import numpy as np


def draw_length(rng: np.random.Generator, spec: dict) -> int:
    """One length in [lo, hi) from ``spec``: ``{"dist": "uniform", "lo",
    "hi"}``, or ``{"dist": "lognormal", "median", "sigma", "lo", "hi"}``,
    a heavy-tailed draw redrawn until it falls in [lo, hi). The uniform
    draw is a frozen copy of the one in ``ragged_generation_jobs``
    (``client_tpu_torch/perf/bench_harness.py``)."""
    lo, hi = int(spec["lo"]), int(spec["hi"])
    if spec["dist"] == "uniform":
        return int(rng.integers(lo, hi))
    if spec["dist"] == "lognormal":
        mu, sigma = math.log(float(spec["median"])), float(spec["sigma"])
        while True:
            x = int(math.exp(rng.normal(mu, sigma)))
            if lo <= x < hi:
                return x
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def draw_sizes(rng: np.random.Generator, workload: dict) -> tuple:
    """One request's (prompt, output) lengths; a pair whose sum passes the
    mix's ``max_total`` (where it has one) is drawn again."""
    cap = int(workload.get("max_total", 0))
    while True:
        plen = draw_length(rng, workload["prompt"])
        out = draw_length(rng, workload["output"])
        if not cap or plen + out <= cap:
            return plen, out


def deal_requests(workload: dict, seed: int, vocab: int) -> list:
    """Per client, its list of ``(prompt int32 [plen], output budget)``.
    The mix's ``sizes_seed`` draws one sequence of
    ``requests_per_client`` sizes for each client, so every run offers the
    same sizes in the same order on every sequence, whatever its seed: a
    window then holds the same work. ``seed`` deals the sequences to the
    clients in another order and draws the token ids, uniform over the
    vocabulary."""
    n_clients = int(workload["clients"])
    per = int(workload["requests_per_client"])
    sizes_rng = np.random.default_rng(int(workload["sizes_seed"]))
    sequences = [[draw_sizes(sizes_rng, workload) for _ in range(per)]
                 for _ in range(n_clients)]
    rng = np.random.default_rng(int(seed))
    return [[(rng.integers(0, vocab, size=plen, dtype=np.int32), budget)
             for plen, budget in sequences[i]]
            for i in rng.permutation(n_clients)]
