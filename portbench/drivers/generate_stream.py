"""Streamed generation, in a closed loop.

The served model is ``make_continuous_generator`` (the continuous-
batching engine: paged KV, chunked prefill, CUDA-graph chunk steps with
K2 on the card) inside a ``TorchInferenceServer``, driven in process
through ``server.infer`` with a response callback, on the decoupled
path (``scheduler._execute_one``, ``StreamContext``, ``engine.submit``).
``clients`` threads each send one request at a time and send the next
when the last token of the previous one has come; every token's arrival
is logged. Decoding is greedy and runs to the budget (no end token).

Once the window has closed, a sample of the requests it finished, drawn
from the seed with the longest among them, is run through the plain
float32 reference over its prompt and served tokens, and every served
token's gap below the reference's best logit is read."""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.reference import arch_of
from portbench.reference.decoder import logits_at
from portbench.traffic import deal_requests
from portbench.weights import make_params

MODEL = "portbench_generator"


def setup(config: dict, workload: dict, seed: int, device) -> dict:
    """The served generator with the seed's weights, registered with a
    warm-up (which builds the engine's graphs and lane buckets), and the
    seed's requests dealt to the clients."""
    from client_tpu_torch.models.decoder_lm import make_continuous_generator
    from client_tpu_torch.models.transformer import TransformerConfig
    from client_tpu_torch.server import TorchInferenceServer

    arch = arch_of(config)
    s = config["serving"]
    t0 = time.perf_counter()
    params = make_params(arch, seed, device,
                         getattr(torch, config["serving"]["dtype"]))
    t1 = time.perf_counter()
    tcfg = TransformerConfig(
        vocab_size=arch["vocab"], d_model=arch["d"],
        n_layers=arch["layers"], n_heads=arch["heads"],
        head_dim=arch["head_dim"], d_ff=arch["ff"],
        max_seq=int(s["max_seq"]), causal=True,
        dtype=params["embed"].dtype, n_kv_heads=arch["kv_heads"],
        rope=arch["rope"], rope_theta=float(arch["rope_theta"]),
        ffn=arch["ffn"], attn_impl=s["attn_impl"])
    model = make_continuous_generator(
        MODEL, cfg=tcfg, params=params, device=device,
        n_slots=int(s["n_slots"]), chunk_size=int(s["chunk"]),
        kv_layout=s["kv_layout"], kv_block_len=int(s["kv_block_len"]),
        kv_pool_blocks=int(s["kv_pool_blocks"]),
        kv_max_blocks_per_slot=int(s["kv_max_blocks_per_slot"]),
        prefill_mode=s["prefill_mode"], prefill_chunk=int(s["prefill_chunk"]),
        prefill_token_budget=int(s["prefill_token_budget"]),
        eos_id=-1, instance_count=int(workload["clients"]))
    server = TorchInferenceServer()
    server.register_model(model, warmup=True)
    parts = {"weights_s": t1 - t0, "model_s": time.perf_counter() - t1}
    return {"arch": arch, "params": params, "server": server, "model": model,
            "jobs": deal_requests(workload, seed, arch["vocab"]),
            "workload": workload, "seed": int(seed), "setup_parts": parts,
            "device": device}


class _Request:
    __slots__ = ("client", "j", "plen", "budget", "send", "times", "tokens",
                 "error", "done")

    def __init__(self, client, j, plen, budget):
        self.client, self.j, self.plen, self.budget = client, j, plen, budget
        self.send, self.times, self.tokens = 0.0, [], []
        self.error, self.done = None, threading.Event()

    def callback(self, resp, final):
        t = time.perf_counter()
        if resp.error is not None:
            self.error = resp.error
        elif resp.outputs:
            self.tokens.append(int(np.asarray(resp.outputs[0].data)
                                   .reshape(-1)[0]))
            self.times.append(t)
        if final:
            self.done.set()


class _ClosedLoop:
    def __init__(self, state: dict):
        from client_tpu_torch.server.types import InferRequest, InferTensor

        self._req_type, self._tensor = InferRequest, InferTensor
        self.server = state["server"]
        self.jobs = state["jobs"]
        self.t_end = float("inf")
        self.stagger_s = float(state["workload"]["warm_s"]) / len(self.jobs)
        # the sends are wrapped in a profiler range on a traced run only
        self.traced = False
        self.log: list = []
        self.threads = [threading.Thread(target=self._client, args=(c,),
                                         daemon=True)
                        for c in range(len(self.jobs))]

    def _client(self, c: int) -> None:
        # the clients' first requests are spread over the warm-up, so the
        # window does not open on one wave of prompts
        time.sleep(c * self.stagger_s)
        jobs, j = self.jobs[c], 0
        while time.perf_counter() < self.t_end:
            prompt, budget = jobs[j % len(jobs)]
            r = _Request(c, j, len(prompt), budget)
            req = self._req_type(model_name=MODEL, inputs=[
                self._tensor("PROMPT", "INT32", (len(prompt),), data=prompt),
                self._tensor("MAX_TOKENS", "INT32", (1,),
                             data=np.array([budget], np.int32))])
            self.log.append(r)
            r.send = time.perf_counter()
            if self.traced:
                with record_function("portbench.send"):
                    self.server.infer(req, r.callback)
            else:
                self.server.infer(req, r.callback)
            r.done.wait()
            j += 1


def _snap(model) -> dict:
    return {"engine": model.runtime_stats(), "gen": model.generation_stats()}


def _sample_kv(model, stop: threading.Event, out: list,
               every_s: float = 0.5) -> None:
    """The paged pool's blocks held by live streams and its usable blocks,
    every ``every_s`` until ``stop``."""
    while not stop.wait(every_s):
        kv = model.runtime_stats()["kv_paged"]
        out.append((kv["blocks_live"], kv["blocks"]))


def run(state: dict, seconds: float, trace_slice=None) -> dict:
    """Warm the loop for the mix's ``warm_s``, then measure ``seconds``;
    ``trace_slice`` runs over the middle ``trace_slice_s`` of the window;
    the engine's counters are read from the window's start to the slice's
    (the profiler's start and stop hold the engine's graph launches, and a
    short stretch cuts a round between counters it updates at different
    points) and, for the prompt tokens the slice ingests, just inside the
    slice's edges; a traced run also samples the paged pool's occupancy
    over the window. Waits for every request sent in the window to
    finish."""
    from client_tpu_torch.server.stats import LATENCY_BUCKETS_NS

    wl, model = state["workload"], state["model"]
    loop = _ClosedLoop(state)
    loop.traced = trace_slice is not None
    for th in loop.threads:
        th.start()
    time.sleep(float(wl["warm_s"]))
    rec = {}
    t0 = time.perf_counter()
    if trace_slice is not None:
        stop, rec["kv_samples"] = threading.Event(), []
        sampler = threading.Thread(target=_sample_kv, daemon=True,
                                   args=(model, stop, rec["kv_samples"]))
        sampler.start()
        first = _snap(model)
        slice_s = float(wl["trace_slice_s"])
        time.sleep(max(0.0, (seconds - slice_s) / 2))
        rec["counters"] = {"before": first, "after": _snap(model)}
        trace_slice.start()
        before = _snap(model)
        time.sleep(slice_s)
        rec["slice"] = {"before": before, "after": _snap(model)}
        trace_slice.stop()
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    t1 = loop.t_end = time.perf_counter()
    if trace_slice is not None:
        stop.set()
        sampler.join()
    rec["metrics_text"] = state["server"].metrics_text()
    deadline = t1 + 180.0
    for th in loop.threads:
        th.join(timeout=max(0.0, deadline - time.perf_counter()))
    rec["stragglers"] = sum(th.is_alive() for th in loop.threads)
    a = state["arch"]
    rec.update({
        "window": {"t0": t0, "t1": t1, "seconds": t1 - t0},
        "requests": [{"client": r.client, "j": r.j, "plen": r.plen,
                      "budget": r.budget, "send": r.send,
                      "times": list(r.times), "tokens": list(r.tokens),
                      "ok": r.error is None and r.done.is_set()
                      and len(r.tokens) == r.budget}
                     for r in loop.log],
        "shape": {"layers": a["layers"], "d": a["d"], "heads": a["heads"],
                  "kv_heads": a["kv_heads"], "head_dim": a["head_dim"],
                  "ff": a["ff"], "vocab": a["vocab"],
                  "kv_bytes": state["params"]["embed"].element_size()},
        "latency_buckets_ns": list(LATENCY_BUCKETS_NS),
    })
    rec["attempted"] = sum(1 for r in rec["requests"] if r["send"] >= t0)
    rec["failed"] = _failed(rec)
    return rec


def release(state: dict) -> None:
    """Stop the server, its engine, its KV pool and its graphs."""
    state.pop("server").stop()
    state.pop("model", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _sample(state: dict, rec: dict) -> list:
    """Requests sent in the window and finished: the one with the most
    served tokens, then others in an order drawn from the seed, until
    ``check_tokens`` served tokens are in."""
    t0 = rec["window"]["t0"]
    done = sorted((r for r in rec["requests"] if r["send"] >= t0 and r["ok"]),
                  key=lambda r: (r["client"], r["j"]))
    if not done:
        return []
    first = max(done, key=lambda r: (len(r["tokens"]), -r["client"], -r["j"]))
    rest = [r for r in done if r is not first]
    order = np.random.default_rng(state["seed"]).permutation(len(rest))
    picked, total = [first], len(first["tokens"])
    want = int(state["workload"]["check_tokens"])
    for i in order:
        if total >= want:
            break
        picked.append(rest[i])
        total += len(rest[i]["tokens"])
    return picked


def _prompt(state: dict, r: dict) -> np.ndarray:
    jobs = state["jobs"][r["client"]]
    return jobs[r["j"] % len(jobs)][0]


def _logits(state: dict, picked: list, precision: str) -> list:
    dev = state["params"]["embed"].device
    seqs = []
    for r in picked:
        toks = np.concatenate([_prompt(state, r),
                               np.asarray(r["tokens"][:-1], np.int32)])
        pos = np.arange(r["plen"] - 1, r["plen"] - 1 + len(r["tokens"]))
        seqs.append((torch.from_numpy(toks).to(dev),
                     torch.from_numpy(pos).to(dev)))
    return logits_at(state["arch"], state["params"], seqs, precision)


def _widest_gap(ref: list, chosen: list) -> float:
    return max(float((lg.max(dim=-1).values
                      - lg.gather(1, c[:, None])[:, 0]).max())
               for lg, c in zip(ref, chosen))


def _failed(rec: dict) -> int:
    t0 = rec["window"]["t0"]
    return sum(1 for r in rec["requests"] if r["send"] >= t0 and not r["ok"])


def check(state: dict, rec: dict) -> dict:
    """``logit_gap``: over every served token of the sample, the widest
    gap by which its reference logit lies below the reference's best at
    that position; ``failed``: requests sent in the window that failed or
    fell short of their budget."""
    picked = _sample(state, rec)
    out = {"failed": float(_failed(rec)),
           "compared": float(sum(len(r["tokens"]) for r in picked))}
    if not picked:
        return out
    ref = _logits(state, picked, "f32")
    served = [torch.tensor(r["tokens"], device=lg.device)
              for r, lg in zip(picked, ref)]
    out["logit_gap"] = _widest_gap(ref, served)
    return out


def control(state: dict, rec: dict) -> dict:
    """``logit_gap`` of the reference computed in fp8 in the program's
    place: at each served position of the same sample, the gap of the
    token the fp8 pass puts first."""
    picked = _sample(state, rec)
    ref = _logits(state, picked, "f32")
    low = _logits(state, picked, "fp8")
    return {"logit_gap": _widest_gap(ref, [lg.argmax(dim=-1) for lg in low])}
