"""Model configuration: the port's counterpart of
``client_tpu/server/config.py``, with the fields an encoder or an image
model served behind the dynamic batcher, a decoupled (streaming)
generator, a stateful sequence model and an ensemble use.

The generator's ``generation_engine``, ``prefix_cache``,
``speculative``, ``scheduler`` and ``slo_classes`` blocks carry the
engine knobs the port runs, a replica fleet's ``fleet`` block its
router's and its ``autoscale`` and ``canary`` blocks the policy of its
controller (``server/autoscale.py``); ``response_cache`` turns on the v2
response cache; ``sequence_batching`` puts a model behind the sequence
scheduler and ``ensemble_steps`` makes it an ensemble of other served
models. The reference's sharding block waits for ROADMAP item 9b (A15),
which shards one engine over several cards. ``platform`` and ``backend`` read ``"pytorch"`` (the reference's
generator says ``"python"``).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Optional


def config_from_dict(cls, fields: dict, defaults: dict | None = None):
    """Config-dataclass construction from a model-config-JSON-style
    dict, validating field names (an unknown key is a loud error, not a
    silently ignored knob)."""
    import dataclasses as _dc

    known = {f.name for f in _dc.fields(cls)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} keys {sorted(unknown)} "
            f"(expected a subset of {sorted(known)})")
    return cls(**{**(defaults or {}), **fields})


@dataclass
class TensorSpec:
    name: str
    datatype: str
    dims: tuple = ()          # without the batch dimension
    is_shape_tensor: bool = False
    optional: bool = False

    def to_json(self):
        return {"name": self.name, "data_type": f"TYPE_{self.datatype}",
                "datatype": self.datatype, "dims": list(self.dims),
                "is_shape_tensor": self.is_shape_tensor,
                "optional": self.optional}


@dataclass
class QueuePolicy:
    """Admission control for a model's request queue (Triton's
    ModelQueuePolicy). ``max_queue_size`` 0 means unbounded; a full queue
    sheds new requests with 503. ``default_timeout_microseconds`` bounds
    the queue wait; expired requests are rejected (REJECT) or served
    anyway (DELAY) at pickup."""

    max_queue_size: int = 0
    default_timeout_microseconds: int = 0
    timeout_action: str = "REJECT"   # REJECT | DELAY

    def to_json(self):
        return {"max_queue_size": self.max_queue_size,
                "default_timeout_microseconds":
                    self.default_timeout_microseconds,
                "timeout_action": self.timeout_action}


@dataclass
class DynamicBatchingConfig:
    preferred_batch_size: tuple = ()
    max_queue_delay_microseconds: int = 100
    preserve_ordering: bool = False
    # how many dispatched batches may be in flight on the device before
    # the dispatcher blocks; completion workers wait on each batch's
    # CUDA event, so a deep window overlaps host work with device work
    pipeline_depth: int = 8
    default_queue_policy: Optional[QueuePolicy] = None

    def to_json(self):
        j = {"preferred_batch_size": list(self.preferred_batch_size),
             "max_queue_delay_microseconds": self.max_queue_delay_microseconds,
             "preserve_ordering": self.preserve_ordering,
             "pipeline_depth": self.pipeline_depth}
        if self.default_queue_policy is not None:
            j["default_queue_policy"] = self.default_queue_policy.to_json()
        return j


@dataclass
class SequenceBatchingConfig:
    max_sequence_idle_microseconds: int = 1_000_000_000
    max_candidate_sequences: int = 1024

    def to_json(self):
        return asdict(self)


@dataclass
class EnsembleStep:
    model_name: str
    model_version: int = -1
    input_map: dict = field(default_factory=dict)   # step input -> ensemble tensor
    output_map: dict = field(default_factory=dict)  # step output -> ensemble tensor

    def to_json(self):
        return {"model_name": self.model_name,
                "model_version": self.model_version,
                "input_map": dict(self.input_map),
                "output_map": dict(self.output_map)}


@dataclass
class PrefixCacheConfig:
    """Prefix-aware KV block reuse of a generation engine
    (``server/kv_cache.py``): prompt prefixes shared across requests at
    ``block_len``-token granularity out of a pool of ``pool_blocks``
    blocks. ``commit_policy``: ``all`` (evict LRU leaves for room),
    ``no-evict`` (free blocks only) or ``none`` (a read-only pool)."""

    enabled: bool = False
    pool_blocks: int = 256
    block_len: int = 16
    commit_policy: str = "all"

    def to_json(self):
        return asdict(self)


@dataclass
class SpeculativeConfig:
    """Speculative decoding of a generation engine
    (``server/speculation.py``): a small draft decoder LM proposes
    ``gamma`` tokens per round and the target scores them in one verify
    forward. ``draft`` holds TransformerConfig overrides of the derived
    draft (its vocab and max_seq stay the target's), ``draft_seed`` its
    weights, ``min_acceptance`` the rolling per-stream acceptance below
    which a stream falls back to plain decode, and ``gamma_ladder`` runs
    each stream at a rung of {1, 2, 4, 8} up to ``gamma`` (plus ``gamma``)
    picked from its acceptance. The reference's block, field for field."""

    enabled: bool = False
    gamma: int = 4
    min_acceptance: float = 0.0
    draft: dict = field(default_factory=dict)
    draft_seed: int = 0
    gamma_ladder: bool = False

    def to_json(self):
        return {"enabled": self.enabled, "gamma": self.gamma,
                "min_acceptance": self.min_acceptance,
                "draft": dict(self.draft),
                "draft_seed": self.draft_seed,
                "gamma_ladder": self.gamma_ladder}


@dataclass
class SloClassConfig:
    """One SLO class's declared latency objectives, the model config's
    ``slo_classes`` block (``server/slo_stats.py``): requests name a class
    with the ``slo_class`` parameter, and a completed request that misses
    any nonzero target burns the class's error budget
    (``1 - target_percentile / 100``). The reference's block, field for
    field."""

    name: str
    ttft_ms: float = 0.0
    itl_ms: float = 0.0
    queue_wait_ms: float = 0.0
    target_percentile: float = 99.0

    def to_json(self):
        return asdict(self)


@dataclass
class SchedulerConfig:
    """Closed-loop SLO scheduling of a generation engine
    (``server/scheduling.py``); disabled keeps the engine's FIFO, with no
    preemption and static knobs. ``class_weights`` maps slo_class names to
    fair-queue weights (others take ``default_weight``; every weight must
    be > 0). ``preemption`` lets a burning higher-weight class reclaim a
    running slot (it needs ``prefix_cache`` with a writable commit
    policy: the resume is a prefix restore); ``preempt_burn_threshold`` is
    the burn at which the fair-order head may preempt (0: on weight alone)
    and ``max_preemptions`` bounds preemptions per stream.
    ``park_bypass_limit`` bounds how often a parked paged reservation may
    be bypassed by other flows. ``controller`` runs the hysteresis
    controller between ``burn_low`` and ``burn_high`` with a dwell of
    ``controller_hold_rounds`` rounds, shrinking the lane budget to
    ``min_prefill_token_budget`` (0: one chunk) in latency mode. The
    reference's block, field for field."""

    enabled: bool = False
    class_weights: dict = field(default_factory=dict)
    default_weight: float = 1.0
    preemption: bool = False
    preempt_burn_threshold: float = 1.0
    max_preemptions: int = 2
    park_bypass_limit: int = 32
    controller: bool = False
    burn_high: float = 1.0
    burn_low: float = 0.25
    controller_hold_rounds: int = 50
    min_prefill_token_budget: int = 0

    def to_json(self):
        j = asdict(self)
        j["class_weights"] = dict(self.class_weights)
        return j


@dataclass
class GenerationEngineConfig:
    """The continuous-batching engine's shape (``server/generation.py``),
    limited to the knobs the port's engine runs: slot count, chunk,
    dispatch depth, the ring fetch cadence (``fetch_stride``, ``overlap``,
    ``ring_entries``), the prompt-ingestion mode and its lane, the
    dedicated prefill lane (``prefill_slots``, ``prefill_lane_width`` and
    ``prefill_lane_batch``, all 0 without it), the host-RAM prefix tier's
    budget (``host_tier_bytes``, 0 = none), the KV layout with its pool
    geometry (0s under ``slot``) and whether the watchdog runs, at what
    sampling interval. Configs built by
    ``make_continuous_generator`` advertise the EFFECTIVE values the
    engine's own resolvers give, so introspection agrees with what the
    engine runs."""

    n_slots: int = 8
    chunk: int = 8
    dispatch_depth: int = 2
    fetch_stride: int = 4
    overlap: bool = True
    ring_entries: int = 0
    prefill_mode: str = "token"
    prefill_chunk: int = 64
    prefill_token_budget: int = 0
    prefill_slots: int = 0
    prefill_lane_width: int = 0
    prefill_lane_batch: int = 0
    host_tier_bytes: int = 0
    kv_layout: str = "slot"
    kv_block_len: int = 0
    kv_pool_blocks: int = 0
    kv_max_blocks_per_slot: int = 0
    watchdog: bool = True
    watchdog_interval_s: float = 0.25

    def to_json(self):
        return asdict(self)


@dataclass
class SupervisionConfig:
    """Engine supervision for generation models
    (``server/supervision.py``): when the continuous-batching engine's
    thread dies, in-flight streams fail with a retryable 503 +
    ``Retry-After`` and the supervisor rebuilds the engine (fresh device
    state) after an exponential backoff — ``backoff_base_s`` growing by
    ``backoff_mult`` per failure up to ``backoff_max_s``.
    ``max_failures`` failures within ``window_s`` seconds trip the
    crash-loop breaker: no further restarts, readiness stays false. The
    reference's block, field for field."""

    enabled: bool = False
    backoff_base_s: float = 0.5
    backoff_mult: float = 2.0
    backoff_max_s: float = 30.0
    max_failures: int = 5
    window_s: float = 300.0

    def to_json(self):
        return asdict(self)


@dataclass
class FleetConfig:
    """The replica fleet router for generation models
    (``server/fleet.py``): ``replicas`` independent continuous-batching
    engines of one model config behind the same /v2 surface, routed by
    the policy chain prefix affinity (a host-side sketch of rolling CRC
    chains at ``affinity_block_len``-token blocks, up to
    ``affinity_max_blocks`` leading blocks, ``affinity_capacity`` LRU
    entries per replica, a tenant hash as tiebreak) -> load (the least
    queue depth plus occupied slots among healthy replicas, the affinity
    winner honoured within ``affinity_tolerance`` of it) -> health
    (dead, crash-looped and draining replicas excluded).
    ``policy="random"`` is a seeded uniform pick, the A/B baseline.
    ``drain_timeout_s`` bounds ``drain(replica)``. The reference's block,
    field for field."""

    replicas: int = 2
    affinity_block_len: int = 16
    affinity_max_blocks: int = 8
    affinity_capacity: int = 4096
    affinity_tolerance: int = 4
    drain_timeout_s: float = 30.0
    policy: str = "affinity"
    random_seed: int = 0

    def to_json(self):
        return asdict(self)


@dataclass
class AutoscaleConfig:
    """The fleet autoscaler (``server/autoscale.py``), the outer control
    loop over a replica fleet. Each ``FleetController.step()`` reads the
    largest windowed per-class error-budget burn across replicas
    (``server/slo_stats.py``) and the mean queue depth of the admitting
    replicas, and walks a ladder: one ``scheduling.EngineController``
    per replica steers its knobs, a burning replica's preempt threshold
    drops to ``pressure_preempt_threshold``, ``attach_replica`` runs
    after ``hold_rounds`` hot rounds in a row (warmed before the router
    sees it) and ``detach_replica`` after ``idle_rounds`` idle rounds in
    a row, within ``min_replicas`` and ``max_replicas`` and at least
    ``cooldown_s`` apart. ``burn_high``/``burn_low`` and
    ``queue_high``/``queue_low`` are the hysteresis bands (hot above the
    highs, idle below the lows). ``interval_s`` 0 means no background
    thread: ``step()`` is called by hand. The reference's block, field
    for field."""

    enabled: bool = False
    burn_high: float = 1.0
    burn_low: float = 0.25
    queue_high: int = 8
    queue_low: int = 1
    min_replicas: int = 1
    max_replicas: int = 4
    hold_rounds: int = 3
    idle_rounds: int = 6
    cooldown_s: float = 5.0
    pressure_preempt_threshold: float = 0.5
    warm_tokens: int = 2
    interval_s: float = 1.0

    def to_json(self):
        return asdict(self)


@dataclass
class CanaryConfig:
    """The canary rollout policy (``server/autoscale.py``): a judged
    ``rolling_restart`` attaches one canary replica at the new version,
    routes ``split_pct`` % of tenants to it by tenant hash, and has the
    ``CanaryJudge`` compare it with the stable set over ``soak_s`` (and
    at least ``min_requests`` canary streams): burn under
    ``burn_abs_max`` and within ``burn_ratio_max`` x the stable set's,
    TTFT p95 within ``ttft_p95_ratio_max`` x, and goodput MFU at least
    ``mfu_ratio_min`` x where both sides measure one. Inside every gate
    the stable set drain-swaps onto the new version (promote); a breached
    gate drains and detaches the canary (rollback). The reference's
    block, field for field."""

    enabled: bool = False
    split_pct: int = 10
    soak_s: float = 5.0
    min_requests: int = 8
    burn_ratio_max: float = 1.5
    burn_abs_max: float = 1.0
    ttft_p95_ratio_max: float = 2.0
    mfu_ratio_min: float = 0.5

    def to_json(self):
        return asdict(self)


@dataclass
class ModelConfig:
    name: str
    platform: str = "pytorch"
    backend: str = "pytorch"
    max_batch_size: int = 0       # 0 => no server-side batching dimension
    inputs: tuple = ()            # [TensorSpec]
    outputs: tuple = ()           # [TensorSpec]
    dynamic_batching: Optional[DynamicBatchingConfig] = None
    sequence_batching: Optional[SequenceBatchingConfig] = None
    ensemble_steps: tuple = ()    # [EnsembleStep]; non-empty => ensemble
    # admission control for non-batched (direct) scheduling; batched
    # models use dynamic_batching.default_queue_policy (this one applies
    # as a fallback there too)
    queue_policy: Optional[QueuePolicy] = None
    instance_count: int = 1
    device_ids: tuple = ()
    parameters: dict = field(default_factory=dict)
    # explicit static batch buckets. Empty => powers of two up to
    # max_batch_size. A single bucket (max_batch_size,) pads every batch
    # to one shape, so each batch runs the same kernels at the same sizes
    batch_buckets_override: tuple = ()
    # decoupled transaction policy: the model streams zero or more
    # responses per request (served only through a response callback)
    decoupled: bool = False
    # the v2 response cache: identical host-resident requests are
    # answered from it (core.infer)
    response_cache: bool = False
    prefix_cache: Optional[PrefixCacheConfig] = None
    speculative: Optional[SpeculativeConfig] = None
    generation_engine: Optional[GenerationEngineConfig] = None
    supervision: Optional[SupervisionConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fleet: Optional[FleetConfig] = None
    autoscale: Optional[AutoscaleConfig] = None
    canary: Optional[CanaryConfig] = None
    slo_classes: tuple = ()   # [SloClassConfig]; advertised objectives

    # ---- derived ----
    def is_ensemble(self) -> bool:
        return len(self.ensemble_steps) > 0

    def input_spec_maps(self) -> tuple:
        """({name: TensorSpec}, frozenset(required names)) — computed once;
        the per-request resolve path is too hot to rebuild these dicts."""
        maps = getattr(self, "_spec_maps", None)
        if maps is None:
            maps = ({s.name: s for s in self.inputs},
                    frozenset(s.name for s in self.inputs if not s.optional))
            self._spec_maps = maps
        return maps

    def batch_buckets(self) -> tuple:
        """Static batch-size buckets (powers of two up to max_batch_size,
        merged with preferred sizes); the batcher pads each batch up to
        the smallest bucket that holds it."""
        if self.max_batch_size <= 0:
            return ()
        if self.batch_buckets_override:
            return tuple(sorted(int(b) for b in self.batch_buckets_override))
        buckets = set()
        b = 1
        while b < self.max_batch_size:
            buckets.add(b)
            b *= 2
        buckets.add(self.max_batch_size)
        if self.dynamic_batching:
            for p in self.dynamic_batching.preferred_batch_size:
                if 0 < p <= self.max_batch_size:
                    buckets.add(int(p))
        return tuple(sorted(buckets))

    def to_json(self) -> dict:
        j = {
            "name": self.name,
            "platform": self.platform,
            "backend": self.backend,
            "max_batch_size": self.max_batch_size,
            "input": [t.to_json() for t in self.inputs],
            "output": [t.to_json() for t in self.outputs],
            "instance_group": [{
                "kind": "KIND_GPU",
                "count": self.instance_count,
                "gpus": list(self.device_ids),
            }],
            "model_transaction_policy": {"decoupled": self.decoupled},
            "parameters": dict(self.parameters),
        }
        if self.dynamic_batching is not None:
            j["dynamic_batching"] = self.dynamic_batching.to_json()
        if self.sequence_batching is not None:
            j["sequence_batching"] = self.sequence_batching.to_json()
        if self.ensemble_steps:
            j["ensemble_scheduling"] = {
                "step": [s.to_json() for s in self.ensemble_steps]}
            j["platform"] = "ensemble"
        if self.response_cache:
            j["response_cache"] = {"enable": True}
        if self.queue_policy is not None:
            j["queue_policy"] = self.queue_policy.to_json()
        if self.prefix_cache is not None:
            j["prefix_cache"] = self.prefix_cache.to_json()
        if self.speculative is not None:
            j["speculative"] = self.speculative.to_json()
        if self.generation_engine is not None:
            j["generation_engine"] = self.generation_engine.to_json()
        if self.supervision is not None:
            j["supervision"] = self.supervision.to_json()
        if self.scheduler is not None:
            j["scheduler"] = self.scheduler.to_json()
        if self.fleet is not None:
            j["fleet"] = self.fleet.to_json()
        if self.autoscale is not None:
            j["autoscale"] = self.autoscale.to_json()
        if self.canary is not None:
            j["canary"] = self.canary.to_json()
        if self.slo_classes:
            j["slo_classes"] = [c.to_json() for c in self.slo_classes]
        return j

    def metadata_json(self, versions) -> dict:
        def shape_of(t: TensorSpec):
            dims = list(t.dims)
            if self.max_batch_size > 0:
                dims = [-1] + dims
            return dims

        return {
            "name": self.name,
            "versions": [str(v) for v in versions],
            "platform": "ensemble" if self.is_ensemble() else self.platform,
            "inputs": [{"name": t.name, "datatype": t.datatype,
                        "shape": shape_of(t)} for t in self.inputs],
            "outputs": [{"name": t.name, "datatype": t.datatype,
                         "shape": shape_of(t)} for t in self.outputs],
        }
