"""Encoder requests over CUDA shared memory, in a closed loop.

The served model is ``make_encoder_model`` (one static bucket, the
dynamic batcher, the CUDA-graph forward with K1 on the card) inside a
``TorchInferenceServer``, driven in process through ``server.infer``
with a response callback. ``concurrency`` requests are in flight at
all times: each completion's callback logs it and sends that slot's
next request at once, on the server's completion thread, so no request
waits on a load thread of the benchmark's. The time-averaged number of
requests at the server over the window is recorded beside the
concurrency. Every request reads its 128 token ids from a
CUDA shared-memory input region (a pool of distinct prompts, one per
offset) and the server writes its embedding into the slot's offset of a
CUDA shared-memory output region.

A sample of the answers of requests sent in the window, drawn from the
seed, is copied on the card from the output region as the server wrote
it, and compared, once the window has closed and the server is gone,
with the plain float32 reference on the same prompts."""

from __future__ import annotations

import gc
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.reference import arch_of
from portbench.reference.encoder import embeddings
from portbench.weights import make_params

MODEL = "portbench_encoder"
IN_REGION, OUT_REGION = "portbench_in", "portbench_out"


def setup(config: dict, workload: dict, seed: int, device) -> dict:
    """The served encoder with the seed's weights, registered with a
    warm-up, and the two regions holding the seed's prompt pool."""
    from client_tpu_torch.models.transformer import TransformerConfig
    from client_tpu_torch.perf.bench_harness import make_encoder_model
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    arch = arch_of(config)
    serving = config["serving"]
    seq, bucket = int(workload["seq"]), int(workload["bucket"])
    t0 = time.perf_counter()
    params = make_params(arch, seed, device,
                         getattr(torch, config["serving"]["dtype"]))
    t1 = time.perf_counter()
    tcfg = TransformerConfig(
        vocab_size=arch["vocab"], d_model=arch["d"],
        n_layers=arch["layers"], n_heads=arch["heads"],
        head_dim=arch["head_dim"], d_ff=arch["ff"],
        max_seq=arch["positions"], causal=False, dtype=params["embed"].dtype,
        attn_impl=serving["attn_impl"])
    model = make_encoder_model(
        tcfg, params, seq, bucket, name=MODEL,
        pipeline_depth=int(serving["pipeline_depth"]),
        max_queue_delay_us=int(serving["max_queue_delay_us"]), device=device)
    server = TorchInferenceServer()
    server.register_model(model, warmup=True)
    parts = {"weights_s": t1 - t0, "model_s": time.perf_counter() - t1}

    conc = int(workload["concurrency"])
    n_pool = int(workload["prompt_pool"])
    rng = np.random.default_rng(int(seed))
    pool = rng.integers(0, arch["vocab"], size=(n_pool, seq), dtype=np.int32)
    dev_pool = torch.from_numpy(pool).to(device)
    row = seq * 4
    h_in = cudashm.create_shared_memory_region(IN_REGION, n_pool * row,
                                               device=device)
    # one device tensor per offset, so every prompt is read zero-copy
    cudashm.set_shared_memory_region_from_torch(
        h_in, list(dev_pool.split(1)), sync_staging=False)
    out_row = arch["d"] * 4
    h_out = cudashm.create_shared_memory_region(OUT_REGION, conc * out_row,
                                                device=device)
    for h in (h_in, h_out):
        server.cuda_shm.register(h.name, cudashm.get_raw_handle(h),
                                 h.device_id, h.byte_size)
    kept_rows = torch.empty((int(workload["check_max"]), arch["d"]),
                            dtype=torch.float32, device=device)
    return {"arch": arch, "params": params, "server": server, "model": model,
            "kept_rows": kept_rows,
            "pool": pool, "order": rng.permutation(n_pool),
            "regions": (h_in, h_out), "workload": workload, "seed": int(seed),
            "setup_parts": parts, "device": device}


class _ClosedLoop:
    """``concurrency`` slots, each sending its next request from its last
    one's response callback while the loop is open; the main thread sends
    the first of each."""

    def __init__(self, state: dict):
        from client_tpu_torch.server.types import (
            InferRequest,
            InferTensor,
            RequestedOutput,
        )

        wl = state["workload"]
        self.server = state["server"]
        self.out_handle = state["regions"][1]
        self.order = state["order"]
        self.conc = int(wl["concurrency"])
        self.seq = int(wl["seq"])
        self.keep_every = int(wl["check_every"])
        self.seed = state["seed"]
        self.out_row = state["arch"]["d"] * 4
        self.log: list = []           # (send, done, ok)
        # the sampled answers, copied into one buffer made at set-up, so
        # keeping them holds no batch's output and grows no allocation
        self.kept_rows = state["kept_rows"]
        self.kept: list = []          # (pool index, row of kept_rows)
        self.sent = [None] * self.conc   # (send time, pool index, ordinal)
        self.count = [0] * self.conc
        self.t_end = float("inf")
        self.t0 = float("inf")
        # the sends are wrapped in a profiler range on a traced run only
        self.traced = False
        self.live = self.conc
        self.lock = threading.Lock()
        self.finished = threading.Event()
        self.requests, self.callbacks = [], []
        for slot in range(self.conc):
            self.requests.append(InferRequest(
                model_name=MODEL,
                inputs=[InferTensor("input_ids", "INT32", (1, self.seq),
                                    shm_region=IN_REGION,
                                    shm_byte_size=self.seq * 4)],
                outputs=[RequestedOutput(
                    "embedding", shm_region=OUT_REGION,
                    shm_offset=slot * self.out_row,
                    shm_byte_size=self.out_row)]))
            self.callbacks.append(self._callback(slot))

    def start(self) -> None:
        for slot in range(self.conc):
            self._send(slot)

    def _callback(self, slot: int):
        def cb(resp, final):
            if final:
                self._complete(slot, time.perf_counter(), resp.error)
        return cb

    def _send(self, slot: int) -> None:
        j = self.count[slot]
        self.count[slot] = j + 1
        idx = int(self.order[(slot + j * self.conc) % len(self.order)])
        req = self.requests[slot]
        req.inputs[0].shm_offset = idx * self.seq * 4
        self.sent[slot] = (time.perf_counter(), idx, j)
        if self.traced:
            with record_function("portbench.send"):
                self.server.infer(req, self.callbacks[slot])
        else:
            self.server.infer(req, self.callbacks[slot])

    def _keep(self, slot: int, j: int) -> bool:
        return (slot * 1000003 + j * 7919 + self.seed) % self.keep_every == 0

    def _complete(self, slot: int, done: float, err) -> None:
        """Log a slot's completion and send its next request, or retire
        the slot once the loop has closed."""
        send, idx, j = self.sent[slot]
        self.log.append((send, done, err is None))
        if err is None and send >= self.t0 and self._keep(slot, j):
            entry = self.out_handle.device_tensors.get(slot * self.out_row)
            with self.lock:
                row = len(self.kept)
                if row < len(self.kept_rows):
                    self.kept.append((idx, row if entry else None))
            if entry and row < len(self.kept_rows):
                self.kept_rows[row].copy_(entry[0][0])
        if time.perf_counter() < self.t_end:
            self._send(slot)
            return
        with self.lock:
            self.live -= 1
            if not self.live:
                self.finished.set()


def in_flight_mean(rows: list, t0: float, t1: float) -> float:
    """The time-averaged number of requests at the server over
    ``[t0, t1)``: each request's time from send to completion inside the
    window, summed, over the window's length (Little's law)."""
    held = sum(max(0.0, min(d, t1) - max(s, t0)) for s, d, _ in rows)
    return held / (t1 - t0)


def _stats(server) -> dict:
    return server.statistics(MODEL)["model_stats"][0]


def run(state: dict, seconds: float, trace_slice=None) -> dict:
    """Warm the loop for the mix's ``warm_s``, then measure ``seconds``;
    ``trace_slice`` (a ``trace.Slice``) is run over the middle
    ``trace_slice_s`` of the window, and the model's statistics are read
    from the window's start to the slice's (the profiler's start and stop
    hold graph launches). Waits for every request sent in the window to
    complete."""
    wl, server = state["workload"], state["server"]
    loop = _ClosedLoop(state)
    loop.traced = trace_slice is not None
    loop.start()
    time.sleep(float(wl["warm_s"]))
    rec = {}
    t0 = loop.t0 = time.perf_counter()
    if trace_slice is not None:
        before = _stats(server)
        slice_s = float(wl["trace_slice_s"])
        time.sleep(max(0.0, (seconds - slice_s) / 2))
        rec["counters"] = {"before": before, "after": _stats(server)}
        trace_slice.start()
        time.sleep(slice_s)
        trace_slice.stop()
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    t1 = loop.t_end = time.perf_counter()
    rec["metrics_text"] = server.metrics_text()
    loop.finished.wait(timeout=120.0)
    rec["stragglers"] = loop.live
    rows = sorted(loop.log)
    rec.update({
        "window": {"t0": t0, "t1": t1, "seconds": t1 - t0},
        "concurrency": loop.conc,
        "in_flight_mean": in_flight_mean(rows, t0, t1),
        "requests": rows,
        "kept": loop.kept,
        "shape": {"bucket": int(wl["bucket"]), "seq": int(wl["seq"]),
                  "heads": state["arch"]["heads"],
                  "head_dim": state["arch"]["head_dim"],
                  "d": state["arch"]["d"], "ff": state["arch"]["ff"],
                  "layers": state["arch"]["layers"]},
    })
    print(f"loop in_flight_mean {rec['in_flight_mean']:.2f} of "
          f"{loop.conc}", file=sys.stderr)
    sent = [ok for s, _, ok in rows if s >= t0]
    rec["attempted"], rec["failed"] = len(sent), sent.count(False)
    return rec


def release(state: dict) -> None:
    """Stop the server and free its model; the sample of answers stays."""
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    server = state.pop("server")
    server.cuda_shm.unregister_all()
    server.stop()
    state.pop("model", None)
    for h in state.pop("regions"):
        cudashm.destroy_shared_memory_region(h)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _sample(state: dict, rec: dict) -> tuple:
    kept = rec["kept"]
    ids = torch.from_numpy(state["pool"][[i for i, _ in kept]]).to(
        state["params"]["embed"].device)
    return kept, ids


def _embed_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    rms = ref.square().mean(dim=-1).sqrt().clamp(min=1e-30)
    return float(((out - ref).abs().amax(dim=-1) / rms).max())


def check(state: dict, rec: dict) -> dict:
    """``embed_err``: over the sampled answers, the widest gap between an
    answer's entry and the reference's, as a share of the reference
    embedding's RMS; ``missing``: sampled answers the region did not
    hold; ``failed``: requests sent in the window that failed."""
    kept, ids = _sample(state, rec)
    have = [row is not None for _, row in kept]
    out = state["kept_rows"][[row for _, row in kept if row is not None]]
    ref = embeddings(state["arch"], state["params"], ids[have])
    missing = len(kept) - len(out)
    return {"embed_err": _embed_err(out.to(ref.device), ref),
            "compared": float(len(out)), "missing": float(missing),
            "failed": float(rec["failed"])}


def control(state: dict, rec: dict) -> dict:
    """``embed_err`` of the reference computed in fp8 in the program's
    place, on the same sampled prompts."""
    _, ids = _sample(state, rec)
    ref = embeddings(state["arch"], state["params"], ids)
    low = embeddings(state["arch"], state["params"], ids, precision="fp8")
    return {"embed_err": _embed_err(low, ref)}
