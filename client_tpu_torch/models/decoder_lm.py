"""Decoder LM served models: the port's counterpart of the continuous
generator of ``client_tpu/models/decoder_lm.py``.

``make_continuous_generator`` serves autoregressive generation as a
decoupled (streaming) model: PROMPT [-1] in (plus optional MAX_TOKENS,
TEMPERATURE, TOP_K, TOP_P and SEED, each [1]), one TOKEN [1] response per
generated token, every concurrent request multiplexed onto one slot batch
by the continuous-batching engine (``server/generation.py``).
``make_decoder_lm`` serves one decode step per request behind the
sequence scheduler: TOKEN in, the greedy NEXT_TOKEN out, the KV cache of
each correlation id kept on the device. ``make_generator`` (one stream a
request, prompt ingested by one bucketed prefill) and
``make_batch_generator`` (PROMPTS [B, L] advancing together) generate in
chunks of eager steps with one host fetch a chunk.
``make_replica_fleet`` (or ``make_continuous_generator(fleet=...)``)
serves N engines behind the fleet router (``server/fleet.py``).
Speculative decoding
runs through ``speculative_draft``, the SLO scheduler through
``scheduler`` and ``slo_classes``, the host tier through
``host_tier_bytes``, engine supervision through ``supervision`` and the
watchdog through ``watchdog`` (on by default, as in the reference).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from client_tpu_torch.device import canonical_device, resolve_device
from client_tpu_torch.models import transformer as t
from client_tpu_torch.models.sampling import MAX_TOP_K
from client_tpu_torch.server.config import (
    FleetConfig,
    GenerationEngineConfig,
    ModelConfig,
    PrefixCacheConfig,
    SequenceBatchingConfig,
    ShardingSpec,
    SloClassConfig,
    SpeculativeConfig,
    SupervisionConfig,
    TensorSpec,
    config_from_dict,
)
from client_tpu_torch.server.autoscale import (
    FleetController,
    resolve_autoscale,
    resolve_canary,
)
from client_tpu_torch.server.fleet import ReplicaFleet, resolve_fleet
from client_tpu_torch.parallel.spmd import BUILD, FleetChannel, mesh_device
from client_tpu_torch.server.generation import (
    ContinuousBatchingEngine,
    reject_unknown_knobs,
)
from client_tpu_torch.server.model import PyModel, SequenceModel, _to_device
from client_tpu_torch.server.scheduling import resolve_scheduler
from client_tpu_torch.server.speculation import DraftModel, build_draft_model
from client_tpu_torch.server.supervision import EngineSupervisor, RestartPolicy
from client_tpu_torch.server.types import ServerError
from client_tpu_torch.server.watchdog import IncidentStore, merge_watchdog


def _read_sampling(inputs) -> tuple:
    """(temperature, top_k, top_p, seed) from the optional wire inputs;
    the defaults reproduce the greedy decode exactly. A top_k beyond
    ``MAX_TOP_K`` is a 400, not a silent clamp."""
    temp = float(np.asarray(inputs.get("TEMPERATURE", [0.0])).reshape(-1)[0])
    top_k = int(np.asarray(inputs.get("TOP_K", [0])).reshape(-1)[0])
    top_p = float(np.asarray(inputs.get("TOP_P", [0.0])).reshape(-1)[0])
    seed = int(np.asarray(inputs.get("SEED", [0])).reshape(-1)[0])
    if top_k > MAX_TOP_K:
        raise ServerError(
            f"TOP_K={top_k} exceeds this model's sampling width "
            f"({MAX_TOP_K}); nucleus (TOP_P) sampling is also computed "
            f"within the top {MAX_TOP_K} candidates", 400)
    return temp, top_k, top_p, seed


_SAMPLING_SPECS = (
    TensorSpec("TEMPERATURE", "FP32", (1,), optional=True),
    TensorSpec("TOP_K", "INT32", (1,), optional=True),
    TensorSpec("TOP_P", "FP32", (1,), optional=True),
    TensorSpec("SEED", "INT32", (1,), optional=True),
)


def decode_config(vocab_size: int = 1024, d_model: int = 128,
                  n_layers: int = 2, n_heads: int = 4, head_dim: int = 32,
                  d_ff: int = 512, max_seq: int = 128,
                  dtype=torch.bfloat16,
                  attn_impl: str = "flash") -> t.TransformerConfig:
    """The reference's default decode model shape (its ``_decode_config``).
    ``attn_impl`` picks the paged layout's decode attention (``"flash"``,
    the paged decode kernel, by default); the slot layout's is the einsum
    whatever it says, as in the reference."""
    return t.TransformerConfig(
        vocab_size=vocab_size, d_model=d_model, n_layers=n_layers,
        n_heads=n_heads, head_dim=head_dim, d_ff=d_ff, max_seq=max_seq,
        causal=True, dtype=dtype, attn_impl=attn_impl)


class _DecoderLm(SequenceModel):
    """A SequenceModel with a host-side context guard: the decode step
    clamps its writes at ``max_seq``, so a step at ``pos >= max_seq`` is
    refused before it runs, and the sequence's state stays as it was."""

    def __init__(self, config, step_fn, init_state_fn, params, max_seq,
                 device):
        super().__init__(config, step_fn, init_state_fn, params=params,
                         device=device)
        self._max_seq = max_seq

    def step(self, inputs: dict, state):
        # every step pays a host sync for its outputs anyway
        if state is not None and int(state["pos"][0]) >= self._max_seq:
            raise ServerError(
                f"sequence exceeds the model's max context length "
                f"{self._max_seq}; send sequence_start to reset", 400)
        return super().step(inputs, state)


def make_decoder_lm(name: str = "decoder_lm", cfg=None, params=None,
                    seed: int = 0, max_candidate_sequences: int = 64,
                    instance_count: int = 4, device=None) -> SequenceModel:
    """Stateful decode-step model: TOKEN -> NEXT_TOKEN (greedy), the KV
    cache carried per correlation id. Feed the prompt token by token (the
    outputs during it are next-token predictions too), then feed each
    token back. A step is the slot layout's ``transformer.decode_step``
    over a one-slot state (``init_decode_state(cfg, 1)``), on the card
    unless ``device="cpu"`` is asked for; ``decode_step`` writes K/V in
    place, and every START builds a fresh state."""
    dev = resolve_device(device)
    cfg = cfg or decode_config(attn_impl="ref")
    params = _default_params(cfg, params, seed, dev)

    def step_fn(p, inputs, state):
        token = inputs["TOKEN"].reshape(-1)[:1].to(torch.int32)
        logits, new_state = t.decode_step(cfg, p, token, state)
        return {"NEXT_TOKEN": logits.argmax(dim=-1).to(torch.int32)}, \
            new_state

    def init_state_fn():
        return t.init_decode_state(cfg, 1, dev)

    config = ModelConfig(
        name=name,
        inputs=(TensorSpec("TOKEN", "INT32", (1,)),),
        outputs=(TensorSpec("NEXT_TOKEN", "INT32", (1,)),),
        sequence_batching=SequenceBatchingConfig(
            max_candidate_sequences=max_candidate_sequences),
        # distinct correlation ids decode concurrently; each sequence's
        # lock serialises its own steps
        instance_count=instance_count,
    )
    return _DecoderLm(config, step_fn, init_state_fn, params=params,
                      max_seq=cfg.max_seq, device=dev)


def _params_once(host_params, dev, warm=None):
    """A getter of ``host_params`` on ``dev``: moved there at the first
    call, under a lock, after which ``warm(params)`` runs once."""
    box, lock = {}, threading.Lock()

    def get() -> dict:
        with lock:
            if "params" not in box:
                params = _to_device(host_params, dev)
                if warm is not None:
                    warm(params)
                box["params"] = params
            return box["params"]

    return get


def _default_params(cfg, params, seed: int, dev):
    """``params``, or random weights from ``seed`` drawn on ``dev``."""
    if params is not None:
        return params
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return t.init_params(gen, cfg)


def _sampling_tensors(dev, seed, temp: float, top_k: int,
                      top_p: float) -> tuple:
    """One request's sampling knobs as device tensors, made once per
    request by fills (a host scalar copied to the card would wait for
    its queue): ``seed`` a host int (a [1] seed) or an int array (one
    seed per row)."""
    if isinstance(seed, np.ndarray):
        seed_t = torch.from_numpy(seed.astype(np.int64)).to(dev)
    else:
        seed_t = torch.full((1,), int(seed), dtype=torch.int64, device=dev)
    return (seed_t,
            torch.full((), float(temp), dtype=torch.float32, device=dev),
            torch.full((), int(top_k), dtype=torch.int64, device=dev),
            torch.full((), float(top_p), dtype=torch.float32, device=dev))


def make_generator(name: str = "generator_lm", cfg=None, params=None,
                   seed: int = 0, max_new_tokens: int = 32,
                   eos_id: int = -1, chunk_size: int = 8,
                   device=None) -> PyModel:
    """Decoupled single-stream generation (the reference's
    ``make_generator``): PROMPT [-1] (plus optional MAX_TOKENS,
    TEMPERATURE, TOP_K, TOP_P and SEED, each [1]) in, one TOKEN [1]
    response per generated token.

    Each request owns its KV state on the device for its whole life. A
    prompt of more than one token is ingested by one ``prefill`` at its
    power-of-two bucket, whose ``[layers, max_seq, ...]`` state becomes a
    one-slot state by views; a one-token prompt takes one
    ``sample_step`` on a fresh one-slot state. Generation runs in chunks
    of ``chunk_size`` eager ``sample_step``s whose tokens stay on the
    device, one host fetch per chunk (``_chunk_driver``); responses still
    stream one token each. ``decode_step`` writes K/V in place, so every
    request builds its own state and two requests share no tensor.
    ``PREFILL_END`` is stamped on a sampled trace once the prompt is
    ingested. The parameters go to the device once, at the first request,
    with one prefill at the smallest bucket to warm the GEMMs; nothing is
    compiled. On the card unless ``device="cpu"`` is asked for."""
    from client_tpu_torch.models import sampling as sm
    from client_tpu_torch.server import trace as trace_mod

    dev = canonical_device(resolve_device(device))
    cfg = cfg or decode_config(attn_impl="ref")
    bucket = _prefill_bucket(2, cfg.max_seq)
    get_params = _params_once(
        _default_params(cfg, params, seed, dev), dev,
        warm=lambda p: t.prefill(cfg, p, torch.zeros(
            bucket, dtype=torch.int32, device=dev), 1))

    def stream_fn(inputs, context=None):
        p = get_params()
        prompt = np.asarray(inputs["PROMPT"]).reshape(-1).astype(np.int32)
        if prompt.size == 0:
            return
        if len(prompt) >= cfg.max_seq:
            raise ServerError(
                f"prompt of {len(prompt)} tokens leaves no room to "
                f"generate within the model's max context length "
                f"{cfg.max_seq}", 400)
        budget = int(np.asarray(
            inputs.get("MAX_TOKENS", [max_new_tokens])).reshape(-1)[0])
        budget = max(0, min(budget, cfg.max_seq - len(prompt)))
        temp, top_k, top_p, rng_seed = _read_sampling(inputs)
        knobs = _sampling_tensors(dev, rng_seed, temp, top_k, top_p)
        plen = len(prompt)
        if plen > 1:
            padded = np.zeros(_prefill_bucket(plen, cfg.max_seq), np.int32)
            padded[:plen] = prompt
            nxt, state = _prefill_select(
                cfg, p, torch.from_numpy(padded).to(dev), plen, *knobs)
        else:
            state = t.init_decode_state(cfg, 1, dev)
            nxt, state = sm.sample_step(
                cfg, p, torch.from_numpy(prompt).to(dev), state, *knobs)
        trace = context.trace if context is not None else None
        if trace is not None:
            trace.event(trace_mod.PREFILL_END)  # prompt ingestion dispatched
        loop = {"step": lambda tok, st: sm.sample_step(cfg, p, tok, st,
                                                       *knobs),
                "loop": lambda tok, st: sm.sample_loop(cfg, p, tok, st,
                                                       chunk_size, *knobs)}
        for toks in _chunk_driver(loop, nxt, state, budget, chunk_size):
            for tok in toks.reshape(-1):
                tok = int(tok)
                yield {"TOKEN": np.array([tok], np.int32)}
                if tok == eos_id:
                    return

    config = ModelConfig(
        name=name,
        decoupled=True,
        inputs=(TensorSpec("PROMPT", "INT32", (-1,)),
                TensorSpec("MAX_TOKENS", "INT32", (1,), optional=True))
        + _SAMPLING_SPECS,
        outputs=(TensorSpec("TOKEN", "INT32", (1,)),),
    )
    return PyModel(config, fn=None, stream_fn=stream_fn)


def make_batch_generator(name: str = "batch_generator_lm", cfg=None,
                         params=None, seed: int = 0,
                         max_new_tokens: int = 32, max_batch: int = 8,
                         chunk_size: int = 8, device=None) -> PyModel:
    """Batched decoupled generation (the reference's
    ``make_batch_generator``): PROMPTS [B, L] in (equal-length rows), one
    TOKENS [B, 1] response per generation step.

    The B rows are the slots of one ``[B]`` slot-layout state, so B
    sequences advance in one step (the reference's ``vmap``); the prompt
    is ingested one column per ``sample_step``, and generation runs in
    the same chunks as ``make_generator``. Rows run to the shared budget
    (the first MAX_TOKENS value applies to all). SEEDS (one per row)
    wins over a scalar SEED, which seeds every row. On the card unless
    ``device="cpu"`` is asked for."""
    from client_tpu_torch.models import sampling as sm

    dev = canonical_device(resolve_device(device))
    cfg = cfg or decode_config(attn_impl="ref")
    get_params = _params_once(_default_params(cfg, params, seed, dev), dev)

    def stream_fn(inputs):
        p = get_params()
        prompts = np.asarray(inputs["PROMPTS"]).astype(np.int32)
        if prompts.ndim != 2 or prompts.size == 0:
            raise ServerError("PROMPTS must be a [batch, len] tensor", 400)
        b, plen = prompts.shape
        if b > max_batch:
            raise ServerError(
                f"batch {b} exceeds max_batch {max_batch}", 400)
        if plen >= cfg.max_seq:
            raise ServerError(
                f"prompt of {plen} tokens leaves no room to generate "
                f"within the model's max context length {cfg.max_seq}",
                400)
        budget = int(np.asarray(
            inputs.get("MAX_TOKENS", [max_new_tokens])).reshape(-1)[0])
        budget = max(0, min(budget, cfg.max_seq - plen))
        temp, top_k, top_p, shared_seed = _read_sampling(inputs)
        seeds = np.asarray(
            inputs.get("SEEDS",
                       np.full(b, shared_seed, np.int32))).reshape(-1)
        if len(seeds) != b:
            raise ServerError(f"SEEDS must have one entry per row "
                              f"({len(seeds)} != {b})", 400)
        knobs = _sampling_tensors(dev, seeds, temp, top_k, top_p)
        state = t.init_decode_state(cfg, b, dev)
        cols = torch.from_numpy(np.ascontiguousarray(prompts.T)).to(dev)
        nxt = None
        for i in range(plen):  # ingestion: eager steps, no host read
            nxt, state = sm.sample_step(cfg, p, cols[i], state, *knobs)
        loop = {"step": lambda tok, st: sm.sample_step(cfg, p, tok, st,
                                                       *knobs),
                "loop": lambda tok, st: sm.sample_loop(cfg, p, tok, st,
                                                       chunk_size, *knobs)}
        for block in _chunk_driver(loop, nxt, state, budget, chunk_size):
            block = block.reshape(b, -1)
            for j in range(block.shape[1]):
                yield {"TOKENS": block[:, j:j + 1]}  # [B, 1] per step

    config = ModelConfig(
        name=name,
        decoupled=True,
        max_batch_size=max_batch,
        inputs=(TensorSpec("PROMPTS", "INT32", (-1,)),
                TensorSpec("MAX_TOKENS", "INT32", (1,), optional=True),
                # one seed per row, [B, 1] on the wire like MAX_TOKENS
                TensorSpec("SEEDS", "INT32", (1,), optional=True))
        + _SAMPLING_SPECS,
        outputs=(TensorSpec("TOKENS", "INT32", (1,)),),
    )
    return PyModel(config, fn=None, stream_fn=stream_fn)


def _prefill_bucket(plen: int, max_seq: int) -> int:
    """The smallest power-of-two bucket >= plen from 8 (capped at
    max_seq): the reference's prompt buckets."""
    b = 8
    while b < plen:
        b *= 2
    return min(b, max_seq)


def _prefill_select(cfg, params, toks, plen: int, seed, temp, top_k,
                    top_p) -> tuple:
    """Prefill a bucket-padded prompt toks [L] and select its first
    token at position ``plen - 1``: (next [1] int32, a one-slot state).
    The state's K/V are views of prefill's ``[layers, max_seq, ...]``
    tensors (no copy) and its ``pos`` a [1] fill on the device."""
    from client_tpu_torch.models.sampling import select_token

    state, logits = t.prefill(cfg, params, toks, plen)
    nxt = select_token(logits[None], seed, plen - 1, temp, top_k, top_p)
    slot = {name: arr[None] for name, arr in state.items() if name != "pos"}
    slot["pos"] = torch.full((1,), plen, dtype=torch.int32,
                             device=logits.device)
    return nxt, slot


def _greedy_step(cfg, params, tokens, state) -> tuple:
    """One greedy decode step of a slot-layout state: (argmax [S] int32,
    the new state)."""
    logits, new_state = t.decode_step(cfg, params, tokens, state)
    return logits.argmax(dim=-1).to(torch.int32), new_state


def _chunk_driver(loop: dict, nxt, state, budget: int, chunk_size: int):
    """The generators' driver: yields host token blocks [S, n] using one
    ``loop["loop"]`` (``chunk_size`` steps on the device) and one host
    fetch per full chunk, then single ``loop["step"]``s for the tail,
    fetched together, with no dispatch after the final token."""
    remaining = budget
    while remaining > 0:
        if remaining >= chunk_size:
            toks, nxt, state = loop["loop"](nxt, state)
            yield toks.cpu().numpy()  # one fetch per chunk
            remaining -= chunk_size
        else:
            cols = []
            for i in range(remaining):
                cols.append(nxt)
                if i < remaining - 1:
                    nxt, state = loop["step"](nxt, state)
            yield torch.stack(cols, dim=-1).cpu().numpy()
            remaining = 0


class ContinuousModel(PyModel):
    """The served continuous generator. ``engine`` is the live engine:
    under supervision the ``engine_supervisor``'s current one (it swaps in
    a rebuilt engine after a crash), else the model's own. ``unload``
    stops it and stages a fresh one (a stopped engine stays stopped; under
    supervision ``replace_clean`` also resets the failure window and the
    breaker; a mesh model's unload stages nothing); ``shutdown``, the
    server's terminal stop, stops it, stages nothing and cancels a
    pending restart; ``warmup`` drives one short
    stream through it, so the kernels are built and the device state is
    ready before serving. ``engine_healthy`` gates the model's readiness
    on the engine thread (and on the breaker); ``runtime_stats`` (the
    statistics' ``runtime`` block), ``generation_stats`` (the /metrics
    feed), ``runtime_observability``, ``engine_debug``,
    ``incident_snapshot`` and ``timeline_snapshot`` read the live
    engine."""

    def __init__(self, config: ModelConfig, stream_fn, fresh_engine,
                 policy: Optional[RestartPolicy] = None,
                 restage: bool = True):
        super().__init__(config, fn=None, stream_fn=stream_fn)
        self._fresh_engine = fresh_engine
        # an engine over a mesh is built by every rank together: an
        # unload on rank 0 alone ends it (its followers return) and
        # stages nothing, supervised or not
        self._restage = restage
        self.engine_supervisor: Optional[EngineSupervisor] = (
            EngineSupervisor(fresh_engine, policy, name=config.name,
                             collective=not restage)
            if policy is not None else None)
        self._engine = (fresh_engine() if self.engine_supervisor is None
                        else None)

    @property
    def engine(self):
        """The live engine (read anew each time: a supervised restart and
        an unload both swap it)."""
        sup = self.engine_supervisor
        return sup.engine if sup is not None else self._engine

    def warmup(self) -> None:
        list(self.engine.submit(np.zeros(4, np.int32), 2))

    def unload(self) -> None:
        if self.engine_supervisor is not None:
            if self._restage:
                self.engine_supervisor.replace_clean()
            else:
                self.engine_supervisor.shutdown()
        else:
            self._engine.stop()
            if self._restage:
                self._engine = self._fresh_engine()

    def shutdown(self) -> None:
        if self.engine_supervisor is not None:
            self.engine_supervisor.shutdown()
        else:
            self._engine.stop()

    def engine_healthy(self) -> bool:
        """False once the engine thread died on an unexpected error: under
        supervision until the rebuilt engine is live, and for good once
        the breaker trips; unsupervised until an unload stages a fresh
        engine."""
        sup = self.engine_supervisor
        return sup.healthy() if sup is not None else self._engine.healthy()

    def runtime_stats(self) -> dict:
        return self.engine.stats()

    def generation_stats(self) -> dict:
        """The token-level snapshot the /metrics collector reads (with the
        supervisor block the restart families read)."""
        return self.engine.generation_snapshot()

    def slo_snapshot(self) -> dict:
        """Per-(tenant, slo_class) windowed quantiles and burn
        (``core.debug_slo``)."""
        return self.engine.slo_snapshot()

    def scheduler_snapshot(self):
        """The scheduler's state (``core.debug_scheduler``); None without
        a scheduler."""
        return self.engine.scheduler_snapshot()

    def runtime_observability(self) -> dict:
        """The runtime block (compile table, memory ledger, liveness) for
        the ``client_tpu_runtime_*`` families and ``GET
        /v2/debug/runtime``."""
        return self.engine.runtime_snapshot()

    def engine_debug(self) -> dict:
        """Slot tables, queue, pool and flight-recorder tail for
        ``GET /v2/debug/models/{name}/engine``."""
        return self.engine.debug_snapshot()

    def timeline_snapshot(self) -> dict:
        """The engine's whole flight-recorder ring, with the incident
        store (the timeline export's input)."""
        return {
            "replicas": [{"replica": 0, "name": self.config.name,
                          "flight": self.engine.flight.dump()}],
            "fleet": None,
            "incidents": self.incident_snapshot(),
        }

    def incident_snapshot(self):
        """The incident store and watchdog state
        (``core.debug_incidents``); the store is the model's, so a
        crashed engine's death bundle stays after a restart. None with
        the watchdog off."""
        return self.engine.incident_snapshot()


class FleetModel(PyModel):
    """The served replica fleet: every engine-facing hook fans out through
    the ``ReplicaFleet`` (``fleet``). The generation and runtime planes
    are fleet-merged; per-replica routing, health and occupancy are in
    ``fleet_snapshot`` (the ``client_tpu_fleet_*`` families and ``GET
    /v2/debug/fleet``). Readiness holds while any replica is healthy.
    ``unload`` stages a fresh engine on every replica and colds the
    affinity sketch (a fleet under a mesh shuts down instead: its
    followers end with it); ``shutdown`` stops the autoscaler and then
    every replica for good; ``warmup`` drives one short stream through
    each replica outside the router. On a follower rank of a fleet under
    a mesh, ``follow()`` runs the rank's part of every replica until rank
    0 shuts the fleet down."""

    def __init__(self, config: ModelConfig, stream_fn, fleet: ReplicaFleet,
                 incidents: Optional[IncidentStore],
                 autoscaler: Optional[FleetController] = None):
        super().__init__(config, fn=None, stream_fn=stream_fn)
        self.fleet = fleet
        self._incidents = incidents
        # the fleet's controller (``server/autoscale.py``), None without
        # ``autoscale``: ``step()`` runs a round by hand and
        # ``rolling_restart(version)`` opens a judged canary rollout
        self.autoscaler = autoscaler

    def autoscale_snapshot(self) -> Optional[dict]:
        """The controller's state (None without ``autoscale``)."""
        return (self.autoscaler.snapshot()
                if self.autoscaler is not None else None)

    def warmup(self) -> None:
        for rep in self.fleet.replicas:
            list(rep.engine.submit(np.zeros(4, np.int32), 2))

    def follow(self) -> None:
        self.fleet.follow()

    def unload(self) -> None:
        if self.fleet.plans is not None:
            self.shutdown()
            return
        self.fleet.replace_all()

    def shutdown(self) -> None:
        # the control loop first: no actuation on a stopping fleet
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.fleet.shutdown()

    def runtime_stats(self) -> dict:
        return self.fleet.stats()

    def generation_stats(self) -> dict:
        return self.fleet.generation_snapshot()

    def engine_healthy(self) -> bool:
        return self.fleet.healthy()

    def fleet_snapshot(self) -> dict:
        """The fleet's routing state, with the controller's ``autoscale``
        block when it runs."""
        snap = self.fleet.fleet_snapshot()
        if self.autoscaler is not None:
            snap["autoscale"] = self.autoscaler.snapshot()
        return snap

    def runtime_observability(self) -> dict:
        return self.fleet.runtime_snapshot()

    def engine_debug(self) -> dict:
        """The fleet snapshot and every replica's full engine snapshot
        (``GET /v2/debug/models/{name}/engine``)."""
        return {"fleet": self.fleet.fleet_snapshot(),
                "replicas": [{"replica": r.idx,
                              "engine": r.engine.debug_snapshot()}
                             for r in self.fleet.replicas]}

    def timeline_snapshot(self) -> dict:
        """Every replica's flight-recorder ring and the fleet's routing
        state (one timeline process per replica)."""
        return {"replicas": [{"replica": r.idx, "name": r.name,
                              "flight": r.engine.flight.dump()}
                             for r in self.fleet.replicas],
                "fleet": self.fleet.fleet_snapshot(),
                "incidents": self.incident_snapshot()}

    def incident_snapshot(self):
        """The model's one incident store (every replica records into
        it, each bundle named by its engine, ``name/rN``), the merged
        watchdog block and the recent routing decisions; None with the
        watchdog off."""
        if self._incidents is None:
            return None
        snap = self._incidents.snapshot()
        snap["watchdog"] = merge_watchdog(
            [r.engine.watchdog_snapshot() for r in self.fleet.replicas])
        fs = self.fleet.fleet_snapshot()
        snap["fleet"] = {"replicas": fs["replicas"],
                         "healthy_replicas": fs["healthy_replicas"],
                         "recent_decisions": fs["recent_decisions"]}
        return snap


def make_continuous_generator(name: str = "continuous_lm", cfg=None,
                              params=None, seed: int = 0,
                              n_slots: int = 8, chunk_size: int = 8,
                              dispatch_depth: int = 2,
                              fetch_stride: int = 4,
                              overlap: bool = True,
                              ring_entries: int = 0,
                              max_new_tokens: int = 32,
                              eos_id: int = -1,
                              instance_count: int = 64,
                              prefill: bool = False,
                              prefill_mode: Optional[str] = None,
                              prefill_chunk: int = 64,
                              prefill_token_budget: int = 0,
                              prefill_slots: int = 0,
                              prefill_lane_width: int = 0,
                              prefill_lane_batch: int = 0,
                              kv_layout: str = "slot",
                              kv_block_len: int = 16,
                              kv_pool_blocks: int = 0,
                              kv_max_blocks_per_slot: int = 0,
                              prefix_cache: bool = False,
                              prefix_blocks: int = 256,
                              prefix_block_len: int = 16,
                              prefix_commit_policy: str = "all",
                              speculative_draft=None,
                              speculative_gamma: int = 4,
                              speculative_min_acceptance: float = 0.0,
                              speculative_gamma_ladder: bool = False,
                              host_tier_bytes: int = 0,
                              dispatch_duty: float = 1.0,
                              slo_classes=None,
                              slo_window_s: float = 30.0,
                              slo_max_tenants: int = 32,
                              scheduler=None,
                              device_time_sample_every: int = 0,
                              queue_depth: int = 256,
                              shed_on_full: bool = False,
                              supervision=None,
                              watchdog: bool = True,
                              watchdog_interval_s: float = 0.25,
                              watchdog_thresholds=None,
                              incident_file: Optional[str] = None,
                              engine_devices=None, mesh=None,
                              fleet=None, replica_devices=None,
                              autoscale=None, canary=None,
                              device=None, **unknown) -> PyModel:
    """Continuously batched decoupled generation (the reference's
    ``make_continuous_generator``, knob for knob; an unknown knob raises
    ``TypeError``).

    ``cfg`` defaults to the reference's small decode config; ``params``
    default to random weights from ``seed``, drawn on ``device`` (CUDA by
    default, raising without it; the CPU only when asked for). The engine
    knobs and their defaults are the reference's (the slot layout,
    token-level prefill, no dedicated lane, no prefix cache, no
    speculation, no scheduler, no host tier, duty 1; int8 KV with
    ``cfg.kv_quant``). The config's ``generation_engine`` (with the
    dedicated lane's ``prefill_slots``, ``prefill_lane_width`` and
    ``prefill_lane_batch`` and the tier's ``host_tier_bytes``),
    ``prefix_cache``, ``speculative``, ``scheduler`` and ``slo_classes``
    blocks advertise what the engine runs, resolved by the engine's own
    rules, so a bad combination raises here. ``slo_classes`` rows may be
    ``SloClassConfig`` or their dicts. The engine is built now and
    started by the first request.

    ``supervision`` (a ``SupervisionConfig``, its dict form, or True for
    the defaults) rebuilds the engine after its thread dies, with the
    reference's backoff and crash-loop breaker (``server/supervision.py``);
    without it a dead engine stays dead until an unload. ``watchdog`` (on
    by default), ``watchdog_interval_s`` and ``watchdog_thresholds`` set up
    each engine's detectors; one ``IncidentStore`` serves every engine the
    model builds, spilled as JSONL to ``incident_file`` when given (which
    needs the watchdog). The config's ``supervision`` block and the
    ``generation_engine`` block's ``watchdog`` fields advertise them.
    ``device_time_sample_every=N`` makes every Nth dispatch of a kind
    wait for its own work on the card and time it (the goodput plane's
    synchronous sample, ``server/goodput.py``); as in the reference, the
    config advertises no field for it.

    ``speculative_draft`` turns on speculative decoding: a
    ``speculation.DraftModel``, a ``(cfg, params)`` pair, or a
    ``SpeculativeConfig`` (or its dict form, the config JSON block) from
    which the draft is built on ``device``. A config block is
    authoritative: its gamma, floor and ladder override the
    ``speculative_*`` arguments. An engine that never speculates (no
    draft, gamma 0, a disabled block) advertises no ``speculative``
    block.

    ``engine_devices`` pins the engine to one device (a CUDA index or a
    ``torch.device``; ``ContinuousBatchingEngine.resolve_engine_devices``).
    ``fleet`` (a ``FleetConfig``, its dict form or a replica count) builds
    a replica fleet (``server/fleet.py``): N engines of this config behind
    the same wire surface, each with its own device state, prefix pool and
    supervisor, every submit routed by prefix affinity, load and health,
    and every stream pinned to its replica; the model exposes the live
    fleet at ``model.fleet``. ``replica_devices`` pins each replica to a
    device subset (one entry per replica). ``autoscale`` (an
    ``AutoscaleConfig``, its dict form or True; it needs a fleet whose
    replica count lies within its bounds) puts the fleet under a
    ``server/autoscale.FleetController`` at ``model.autoscaler``, and
    ``canary`` (a ``CanaryConfig``, its dict form or True; it needs
    ``autoscale``) makes its ``rolling_restart`` a judged canary rollout.

    ``mesh`` (a dp×tp ``DeviceMesh``), or ``engine_devices`` over k > 1
    devices (a k×1 dp mesh over the ranks of the live group that hold
    them), shards the engine over one process per device
    (``server/generation.py``, ``parallel/spmd.py``): every rank calls
    this with the same arguments; rank 0 registers and serves the model,
    every other rank runs ``model.engine.start()``, which follows rank 0
    until the model is unloaded there (a mesh model stages no fresh
    engine). The config's ``sharding`` block advertises the mesh. Every
    plane of the engine runs under it (speculation, the dedicated lanes,
    the host tier, int8 KV), and so does ``supervision``: each rank's
    supervisor rebuilds the engine with rank 0's after a crash
    (``server/supervision.py``), and an unload shuts the engine down.

    A fleet shards too: under ``mesh`` every replica's engine spans the
    whole mesh (the reference's rule), and a ``replica_devices`` entry of
    k > 1 devices puts that replica on a k×1 dp mesh over the ranks that
    hold them, which need not include rank 0 (device index i names rank
    i's CPU on gloo ranks, card i under NCCL); a replica attached past
    the declared subsets takes the default placement. Rank 0 routes and
    keeps every replica's host state, and one plan channel over the
    world (``spmd.FleetChannel``) carries every replica's plans and the
    fleet's lifecycle (each replica build, drain, attach, detach,
    restart and supervised rebuild), so every rank launches the
    replicas' collectives in one order. Every other rank runs
    ``model.follow()``, which hands each plan to its shard of that
    replica until rank 0 shuts the fleet down (an unload shuts it
    down)."""
    reject_unknown_knobs(unknown)
    cfg = cfg or decode_config()
    eff_fleet = resolve_fleet(fleet)
    if replica_devices is not None:
        if eff_fleet is None:
            raise ValueError(
                "replica_devices requires a fleet (it pins each "
                "replica's engine to a device subset); use "
                "engine_devices for a single engine")
        if engine_devices is not None:
            raise ValueError(
                "engine_devices and replica_devices are mutually "
                "exclusive — per-replica subsets already cover the "
                "single-engine knob")
        if len(replica_devices) != eff_fleet.replicas:
            raise ValueError(
                f"replica_devices has {len(replica_devices)} entries "
                f"for {eff_fleet.replicas} replicas (one device "
                f"subset per replica)")
    # each replica's placement, resolved once (a subset of k > 1 devices
    # is a k x 1 mesh over the ranks that hold it; one device pins)
    places = ([ContinuousBatchingEngine.resolve_engine_devices(devices)
               for devices in replica_devices]
              if replica_devices is not None else None)
    # the controller's knobs by their own rules
    eff_autoscale = resolve_autoscale(autoscale)
    eff_canary = resolve_canary(canary)
    if eff_autoscale is not None and eff_fleet is None:
        raise ValueError(
            "autoscale requires a fleet (the controller actuates the "
            "fleet's attach/drain verbs) — pass fleet=N or a "
            "FleetConfig")
    if eff_canary is not None and eff_autoscale is None:
        raise ValueError(
            "canary requires autoscale (the FleetController owns the "
            "canary judge) — pass autoscale=True or an "
            "AutoscaleConfig; pin min_replicas == max_replicas == "
            "fleet.replicas if you want judged rollouts without "
            "capacity scaling")
    if eff_autoscale is not None and not (
            eff_autoscale.min_replicas <= eff_fleet.replicas
            <= eff_autoscale.max_replicas):
        raise ValueError(
            f"fleet.replicas={eff_fleet.replicas} must start inside "
            f"the autoscale bounds [{eff_autoscale.min_replicas}, "
            f"{eff_autoscale.max_replicas}] — the controller only "
            f"scales within them")
    pinned = ContinuousBatchingEngine.resolve_engine_devices(engine_devices,
                                                             mesh)
    if pinned is not None and not isinstance(pinned, torch.device):
        # a subset of k > 1 devices, resolved once: its k x 1 dp mesh
        mesh, pinned, engine_devices = pinned, None, None
    sharding = None
    if mesh is not None:
        dp, tp = ContinuousBatchingEngine.resolve_mesh(cfg, mesh, n_slots)
        sharding = ShardingSpec(mesh_axes=("dp", "tp"), mesh_shape=(dp, tp),
                                batch_axis="dp")
        pinned = mesh_device(mesh)
    # a fleet whose replicas shard over ranks: one plan channel over the
    # world carries every replica's plans (spmd.FleetChannel)
    plans = None
    if eff_fleet is not None and (mesh is not None or any(
            p is not None and not isinstance(p, torch.device)
            for p in places or ())):
        plans = FleetChannel()
    # an indexed device: a supervised rebuild runs on another thread, whose
    # current card need not be the caller's
    dev = (pinned if pinned is not None
           else canonical_device(resolve_device(device)))
    draft, spec_json = speculative_draft, None
    if isinstance(draft, dict):
        draft = config_from_dict(SpeculativeConfig, draft)
    if isinstance(draft, SpeculativeConfig):
        # the block is authoritative: the engine runs what the config
        # JSON advertises
        spec_json = draft
        speculative_gamma = draft.gamma
        speculative_min_acceptance = draft.min_acceptance
        speculative_gamma_ladder = bool(draft.gamma_ladder)
        draft = (build_draft_model(cfg, spec_json, dev)
                 if spec_json.enabled and spec_json.gamma > 0 else None)
    elif isinstance(draft, tuple):
        draft = DraftModel(*draft)
    if draft is not None and speculative_gamma > 0:
        spec_json = spec_json or SpeculativeConfig(
            enabled=True, gamma=speculative_gamma,
            min_acceptance=speculative_min_acceptance,
            gamma_ladder=speculative_gamma_ladder)
    else:
        draft = spec_json = None
    eng = ContinuousBatchingEngine
    eff_mode = eng.resolve_prefill_mode(prefill, prefill_mode)
    eff_budget = eng.resolve_prefill_budget(eff_mode, prefill_chunk,
                                            prefill_token_budget)
    # the ring is sized with the entries a speculating iteration appends,
    # as the engine sizes it
    eff_ladder = eng.resolve_gamma_ladder(
        speculative_gamma if draft is not None else 0,
        speculative_gamma_ladder)
    eff_stride, eff_entries = eng.ring_shape(
        fetch_stride, overlap, dispatch_depth, ring_entries,
        eng.ring_entries_per_iter(eff_ladder))
    # the dedicated lane by the engine's own rules: a bad combination
    # raises here, and the config advertises the lane the engine runs
    eff_lane_n, eff_lane_width = eng.resolve_disagg(
        cfg, eff_mode, prefill_slots, prefill_lane_width, prefill_chunk,
        kv_layout, prefix_cache, prefix_commit_policy)
    eff_lane_batch = eng.resolve_lane_batch(eff_lane_n, prefill_lane_batch)
    kv = eng.resolve_kv_layout(
        cfg, n_slots, kv_layout, kv_block_len,
        kv_pool_blocks, kv_max_blocks_per_slot, eff_mode, prefix_cache,
        prefix_block_len)
    eng.resolve_prefix(cfg, kv[0], prefix_cache,
                       prefix_block_len, prefix_commit_policy)
    eff_tier = eng.resolve_host_tier(host_tier_bytes, prefix_cache)
    eff_sched = resolve_scheduler(scheduler, prefix_cache,
                                  prefix_commit_policy)
    # one normalisation of the declared classes feeds the engine's
    # objectives and the config block
    slo_cfgs = tuple(SloClassConfig(**c) if isinstance(c, dict) else c
                     for c in (slo_classes or ()))
    if incident_file is not None and not watchdog:
        raise ValueError(
            "incident_file requires watchdog=True — nothing records "
            "incidents with the watchdog off")
    # one incident store per model, handed to every engine it builds, so
    # a crashed engine's bundles stay readable after a restart
    incidents = IncidentStore(spill_path=incident_file) if watchdog else None
    sup_cfg = supervision
    if isinstance(sup_cfg, dict):
        sup_cfg = config_from_dict(SupervisionConfig, sup_cfg,
                                   defaults={"enabled": True})
    elif sup_cfg is True:
        sup_cfg = SupervisionConfig(enabled=True)
    if isinstance(sup_cfg, SupervisionConfig) and not sup_cfg.enabled:
        sup_cfg = None
    policy = None if sup_cfg is None else RestartPolicy(
        backoff_base_s=sup_cfg.backoff_base_s,
        backoff_mult=sup_cfg.backoff_mult,
        backoff_max_s=sup_cfg.backoff_max_s,
        max_failures=sup_cfg.max_failures, window_s=sup_cfg.window_s)
    params = _default_params(cfg, params, seed, dev)

    def fresh_engine(replica=None):
        if dev.type == "cuda":
            # a supervised rebuild runs on the supervisor's thread, whose
            # current card is not this rank's: a mesh places the engine
            # on the current card
            with torch.cuda.device(dev):
                return build_engine(replica)
        return build_engine(replica)

    def replica_engine(replica):
        if plans is not None and plans.is_driver:
            # every rank builds the replica's engine, its process groups
            # in the order of the channel's plans (a follower at the
            # BUILD plan, in ReplicaFleet.follow)
            with plans.lock:
                plans.send(replica, BUILD)
                return fresh_engine(replica)
        return fresh_engine(replica)

    def build_engine(replica=None):
        devices, ename, emesh = engine_devices, name, mesh
        if replica is not None:
            ename = f"{name}/r{replica}"
            if places is not None:
                # replicas attached past the declared subsets take the
                # default placement
                devices = (places[replica] if replica < len(places)
                           else None)
                if devices is not None and not isinstance(devices,
                                                          torch.device):
                    emesh, devices = devices, None
                elif devices is not None:
                    devices = (devices,)
        return ContinuousBatchingEngine(
            cfg, params, n_slots=n_slots, chunk=chunk_size,
            dispatch_depth=dispatch_depth, queue_depth=queue_depth,
            fetch_stride=fetch_stride, overlap=overlap,
            ring_entries=ring_entries, kv_layout=kv_layout,
            prefill=prefill, prefill_mode=prefill_mode,
            prefill_chunk=prefill_chunk,
            prefill_token_budget=prefill_token_budget,
            prefill_slots=prefill_slots,
            prefill_lane_width=prefill_lane_width,
            prefill_lane_batch=prefill_lane_batch,
            kv_block_len=kv_block_len,
            kv_pool_blocks=kv_pool_blocks,
            kv_max_blocks_per_slot=kv_max_blocks_per_slot,
            prefix_cache=prefix_cache, prefix_blocks=prefix_blocks,
            prefix_block_len=prefix_block_len,
            prefix_commit_policy=prefix_commit_policy,
            speculative_draft=draft, speculative_gamma=speculative_gamma,
            speculative_min_acceptance=speculative_min_acceptance,
            speculative_gamma_ladder=speculative_gamma_ladder,
            host_tier_bytes=host_tier_bytes, dispatch_duty=dispatch_duty,
            slo_classes=slo_cfgs, slo_window_s=slo_window_s,
            slo_max_tenants=slo_max_tenants, scheduler=eff_sched,
            shed_on_full=shed_on_full,
            device_time_sample_every=device_time_sample_every,
            watchdog=watchdog,
            watchdog_interval_s=watchdog_interval_s,
            watchdog_thresholds=watchdog_thresholds,
            incident_store=incidents,
            device=dev if emesh is None else None, name=ename,
            engine_devices=devices, mesh=emesh,
            plans=(plans.for_replica(replica)
                   if plans is not None and emesh is not None else None))

    model = None  # bound below; stream_fn reads it live

    def stream_fn(inputs, context=None):
        budget = int(np.asarray(
            inputs.get("MAX_TOKENS", [max_new_tokens])).reshape(-1)[0])
        temp, top_k, top_p, rng_seed = _read_sampling(inputs)
        # prompt validation lives in engine.submit: one definition of
        # the wire contract. The request's deadline (the wire timeout)
        # and the front end's cancel Event bound the stream's lifetime
        # inside the engine; the SLO labels and the sampled trace, which
        # the engine stamps with its spans, ride along.
        submit_kw = {}
        if context is not None:
            submit_kw = {"trace": context.trace,
                         "tenant_id": context.tenant_id,
                         "slo_class": context.slo_class,
                         "deadline_ns": context.deadline_ns,
                         "cancel_event": context.cancel_event}
        # a fleet routes at submit, and the stream stays pinned to the
        # replica whose engine admitted it
        submit = (model.fleet.submit if eff_fleet is not None
                  else model.engine.submit)
        for tok in submit(inputs["PROMPT"], budget, eos_id=eos_id,
                          temperature=temp, top_k=top_k, top_p=top_p,
                          seed=rng_seed, **submit_kw):
            yield {"TOKEN": np.array([tok], np.int32)}

    config = ModelConfig(
        name=name,
        decoupled=True,
        inputs=(TensorSpec("PROMPT", "INT32", (-1,)),
                TensorSpec("MAX_TOKENS", "INT32", (1,), optional=True))
        + _SAMPLING_SPECS,
        outputs=(TensorSpec("TOKEN", "INT32", (1,)),),
        # streams block in the engine, not on device work: admit more of
        # them than there are slots so retiring slots refill at once (a
        # fleet twice more per replica, headroom for attached replicas)
        instance_count=max(instance_count, 2 * n_slots * (
            2 * eff_fleet.replicas if eff_fleet is not None else 1)),
        generation_engine=GenerationEngineConfig(
            n_slots=n_slots, chunk=chunk_size,
            dispatch_depth=dispatch_depth, fetch_stride=eff_stride,
            overlap=overlap, ring_entries=eff_entries,
            prefill_mode=eff_mode, prefill_chunk=prefill_chunk,
            prefill_token_budget=eff_budget, prefill_slots=eff_lane_n,
            prefill_lane_width=eff_lane_width,
            prefill_lane_batch=eff_lane_batch, host_tier_bytes=eff_tier,
            kv_layout=kv[0],
            kv_block_len=kv[1], kv_pool_blocks=kv[2],
            kv_max_blocks_per_slot=kv[3], watchdog=watchdog,
            watchdog_interval_s=watchdog_interval_s),
        prefix_cache=(PrefixCacheConfig(
            enabled=True, pool_blocks=prefix_blocks,
            block_len=prefix_block_len,
            commit_policy=prefix_commit_policy)
            if prefix_cache else None),
        speculative=spec_json,
        supervision=sup_cfg,
        scheduler=eff_sched,
        fleet=eff_fleet,
        sharding=sharding,
        autoscale=eff_autoscale,
        canary=eff_canary,
        slo_classes=slo_cfgs,
    )
    if eff_fleet is not None:
        fleet_obj = ReplicaFleet(
            replica_engine, eff_fleet, supervision=policy, name=name,
            version_factory=lambda i, v: replica_engine(i), plans=plans)
        ctl = None
        if eff_autoscale is not None:
            # an attached or canary replica warms on a short stream
            # before the router sees it; interval_s 0 leaves step() to
            # the caller, > 0 starts the control thread now (on the
            # driver only under a mesh: the followers act on its plans)
            ctl = FleetController(fleet_obj, eff_autoscale,
                                  canary=eff_canary,
                                  warm_prompt=np.zeros(4, dtype=np.int32))
            if plans is None or plans.is_driver:
                ctl.start()
        model = FleetModel(config, stream_fn, fleet_obj, incidents, ctl)
    else:
        model = ContinuousModel(config, stream_fn, fresh_engine, policy,
                                restage=mesh is None)
    return model


def make_replica_fleet(name: str = "fleet_lm", replicas=None, fleet=None,
                       **kw) -> PyModel:
    """N continuous-batching engine replicas of one model config behind
    the /v2 surface (``server/fleet.ReplicaFleet``): the wire contract of
    ``make_continuous_generator``, every submit routed by the prefix
    affinity -> load -> health chain and every stream pinned to its
    replica. ``fleet`` (a ``FleetConfig``, its dict form, or None for the
    defaults at ``replicas``) carries the routing knobs; every other
    keyword is ``make_continuous_generator``'s, applied to each replica.
    ``model.fleet`` is the live fleet (``drain``, ``rolling_restart``,
    ``attach_replica``). ``replicas`` (2 when neither names a count) and
    an explicit ``fleet.replicas`` must agree: a disagreement is a loud
    error, never a silent pick."""
    if fleet is None:
        return make_continuous_generator(
            name=name,
            fleet=FleetConfig(replicas=2 if replicas is None
                              else replicas), **kw)
    # a dict that leaves the count to this function takes ``replicas``;
    # an explicit count must match it
    if isinstance(fleet, dict) and "replicas" not in fleet \
            and replicas is not None:
        fleet = {**fleet, "replicas": replicas}
    fleet = resolve_fleet(fleet)
    if replicas is not None and fleet.replicas != replicas:
        raise ValueError(
            f"replicas={replicas} conflicts with "
            f"fleet.replicas={fleet.replicas} — set one of them")
    return make_continuous_generator(name=name, fleet=fleet, **kw)
