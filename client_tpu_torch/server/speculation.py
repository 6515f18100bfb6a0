"""Speculative decoding, host side: the port of
``client_tpu/server/speculation.py``.

A small draft model proposes ``gamma`` tokens per slot, one target forward
scores all ``gamma + 1`` positions (``transformer.verify_steps``), and
modified rejection sampling (Leviathan et al. 2023) keeps the longest
prefix the target accepts plus one target-distributed token. Greedy
streams stay token-identical: with one-hot p and q the rule is exact
argmax agreement.

This module holds the pieces that are not the round itself:

- ``DraftModel`` and ``build_draft_model``: the draft shares the target's
  vocabulary and covers its ``max_seq``; built from a ``(cfg, params)``
  pair or from a ``SpeculativeConfig`` block, whose weights come from
  ``draft_seed`` through the port's ``init_params``.
- ``spec_select``: the acceptance rule, batched over slots, with its
  uniforms and the residual draw's Gumbel noise as arguments (a test can
  hand it the reference's own draws).
- ``RequestSpeculation`` and ``SpeculationController``: the per-stream
  rolling acceptance that latches a stream to plain decode below the
  floor and picks its gamma-ladder rung, and the engine-wide counters.

The round (draft steps, verify, accept, rollback) is in
``server/generation.py`` beside the chunk kernel it shares the slots with.
The salts and the EWMA constants are the reference's.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch

# salts separating the streams speculation draws at one (seed, position):
# the draft's proposal, the accept uniform and the residual draw (salt 0
# is the plain selection draw)
DRAFT_SALT = 0x5D1
ACCEPT_SALT = 0x5D2
RESIDUAL_SALT = 0x5D3

# rounds a stream completes before its rolling acceptance may latch it to
# plain decode: one cold round must not condemn the draft
FALLBACK_WARMUP_ROUNDS = 4
ACCEPTANCE_EWMA_ALPHA = 0.3


def _ewma(prev: Optional[float], rate: float) -> float:
    """One step of the rolling-acceptance smoothing the per-request
    tracker and the engine-wide controller share."""
    if prev is None:
        return rate
    return (1.0 - ACCEPTANCE_EWMA_ALPHA) * prev \
        + ACCEPTANCE_EWMA_ALPHA * rate


class DraftModel:
    """A small decoder LM proposing tokens for a target model: its config
    and weights (tensors on any device; the engine places them). It must
    share the target's vocabulary and cover its ``max_seq``, so slot
    positions line up row for row."""

    def __init__(self, cfg, params):
        self.cfg = cfg
        self.params = params

    def assert_compatible(self, target_cfg) -> None:
        if self.cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft vocab {self.cfg.vocab_size} != target vocab "
                f"{target_cfg.vocab_size} — speculation requires a "
                f"shared tokenizer")
        if self.cfg.max_seq < target_cfg.max_seq:
            raise ValueError(
                f"draft max_seq {self.cfg.max_seq} < target max_seq "
                f"{target_cfg.max_seq} — the draft KV cache must cover "
                f"every position the target can reach")


def build_draft_model(target_cfg, spec, device=None) -> DraftModel:
    """The draft of a ``SpeculativeConfig`` block: the target's vocab,
    max_seq, dtype and positional scheme with halved compute dims (half
    d_model, d_ff and heads, a quarter of the layers), any field of
    ``spec.draft`` overriding the derived value (an unknown field raises).
    Weights from a ``torch.Generator`` seeded with ``spec.draft_seed`` on
    ``device`` (the card unless the caller names the CPU)."""
    from client_tpu_torch.device import resolve_device
    from client_tpu_torch.models import transformer as t

    derived = {
        "vocab_size": target_cfg.vocab_size,
        "max_seq": target_cfg.max_seq,
        "causal": True,
        "dtype": target_cfg.dtype,
        "attn_impl": "ref",
        "rope": target_cfg.rope,
        "rope_theta": target_cfg.rope_theta,
        "ffn": target_cfg.ffn,
        "d_model": max(32, target_cfg.d_model // 2),
        "d_ff": max(64, target_cfg.d_ff // 2),
        "n_layers": max(1, target_cfg.n_layers // 4),
        "n_heads": max(1, target_cfg.n_heads // 2),
        "head_dim": target_cfg.head_dim,
    }
    overrides = dict(getattr(spec, "draft", None) or {})
    field_names = {f.name for f in dataclasses.fields(t.TransformerConfig)}
    unknown = set(overrides) - field_names
    if unknown:
        raise ValueError(
            f"unknown draft TransformerConfig overrides: {sorted(unknown)}")
    derived.update(overrides)
    # the shared tokenizer is not an override
    derived["vocab_size"] = target_cfg.vocab_size
    derived["max_seq"] = max(int(derived["max_seq"]), target_cfg.max_seq)
    cfg = t.TransformerConfig(**derived)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(getattr(spec, "draft_seed", 0) or 0))
    model = DraftModel(cfg, t.init_params(gen, cfg))
    model.assert_compatible(target_cfg)
    return model


def spec_select(pdist, qdist, proposals, accept_u, residual_gumbel) -> tuple:
    """Modified rejection sampling for a verify round of N slots (the
    reference's ``spec_select`` batched over its leading axis).

    pdist [N, G+1, vocab] target probabilities at each scored position,
    qdist [N, G, vocab] the draft's, both ``sampling.filtered_probs``;
    proposals [N, G] the draft tokens; accept_u [N, G] uniforms in (0, 1);
    residual_gumbel [N, vocab] the Gumbel noise of the residual draw.

    Proposal i is accepted while u_i < min(1, p_i(x_i) / q_i(x_i)); at the
    first rejection the token is drawn from norm(max(p - q, 0)), after G
    acceptances from p_G (a categorical draw is argmax(log p + gumbel), as
    ``jax.random.categorical`` computes it). Returns (n_accepted [N],
    next_token [N] int32). With one-hot p and q this is the longest prefix
    agreeing with the argmax plus the argmax next: greedy identity."""
    n, g = proposals.shape
    props = proposals.long()
    p_at = pdist[:, :g].gather(-1, props[..., None])[..., 0]
    q_at = qdist.gather(-1, props[..., None])[..., 0]
    ratio = p_at / q_at.clamp(min=1e-30)
    accept = accept_u < ratio.clamp(max=1.0)
    n_acc = accept.long().cumprod(dim=-1).sum(dim=-1)
    rows = torch.arange(n, device=pdist.device)
    p_next = pdist[rows, n_acc]
    q_next = torch.where((n_acc < g)[:, None],
                         qdist[rows, n_acc.clamp(max=g - 1)], 0.0)
    residual = (p_next - q_next).clamp(min=0.0)
    total = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(total > 0, residual / total, p_next)
    logp = torch.where(residual > 0, residual.log(),
                       torch.full((), float("-inf"), device=pdist.device))
    nxt = (logp + residual_gumbel).argmax(dim=-1)
    return n_acc, nxt.to(torch.int32)


def expected_accepted(alpha: float, gamma: int) -> float:
    """Expected accepted draft tokens of one verify round at depth
    ``gamma`` when each proposal is accepted with probability ``alpha``
    until the first rejection: alpha (1 - alpha^gamma) / (1 - alpha). The
    bonus token every round emits is not counted: a plain step would make
    that progress too."""
    a = min(max(float(alpha), 0.0), 1.0)
    if a >= 1.0:
        return float(gamma)
    if a <= 0.0:
        return 0.0
    return a * (1.0 - a ** gamma) / (1.0 - a)


def select_gamma(alpha: float, rungs) -> int:
    """The verify depth of a stream's next round from a ladder of rungs:
    the most expected accepted tokens per verify row (a rung-g round
    scores g + 1 rows). A tie in that score goes to the rung with more
    accepted tokens per round; a full tie keeps the shallowest rung."""
    best, best_score, best_e = rungs[0], -1.0, -1.0
    for g in rungs:
        e = expected_accepted(alpha, g)
        score = e / (g + 1)
        if score > best_score + 1e-9 or (
                score > best_score - 1e-9 and e > best_e + 1e-9):
            best, best_score, best_e = g, score, e
    return best


@dataclasses.dataclass
class RequestSpeculation:
    """One stream's rolling acceptance: drives its fallback latch and, on
    a gamma ladder, its rung."""

    rounds: int = 0
    ewma: float = 1.0
    fallback: bool = False

    def record(self, proposed: int, accepted: int,
               min_acceptance: float) -> None:
        if proposed <= 0:
            return
        rate = accepted / proposed
        self.rounds += 1
        self.ewma = _ewma(None if self.rounds == 1 else self.ewma, rate)
        if (min_acceptance > 0.0
                and self.rounds >= FALLBACK_WARMUP_ROUNDS
                and self.ewma < min_acceptance):
            # a one-way latch: a draft that keeps missing makes every
            # round cost more than the plain steps it replaces
            self.fallback = True

    def select_rung(self, ladder, ceiling: int) -> int:
        """This stream's verify depth for its next round: ``select_gamma``
        over the rungs at or below ``ceiling`` (the engine's live gamma
        ceiling), with the rolling acceptance rate standing in for alpha.
        A fresh stream (ewma 1.0) starts at the deepest allowed rung;
        0 when no rung is allowed."""
        allowed = [g for g in ladder if g <= ceiling]
        if not allowed:
            return 0
        if len(allowed) == 1:
            return allowed[0]
        return select_gamma(self.ewma, allowed)


class SpeculationController:
    """Engine-wide speculation counters (proposed, accepted, rejected,
    rounds) and the rolling acceptance rate. Thread-safe: the engine
    thread writes, any thread reads. A fresh engine has a fresh one."""

    def __init__(self, gamma: int, min_acceptance: float = 0.0):
        if gamma < 0:
            raise ValueError(f"speculative_gamma must be >= 0, got {gamma}")
        if not 0.0 <= min_acceptance <= 1.0:
            raise ValueError(
                f"speculative_min_acceptance must be in [0, 1], got "
                f"{min_acceptance}")
        self.gamma = gamma
        self.min_acceptance = min_acceptance
        self._lock = threading.Lock()
        self.proposed = 0
        self.accepted = 0
        self.rejected = 0
        self.rounds = 0
        self._ewma: Optional[float] = None

    def record_round(self, proposed: int, accepted: int) -> None:
        """One retired verify round of one slot: ``proposed`` draft tokens
        scored, ``accepted`` of them kept."""
        with self._lock:
            self.proposed += proposed
            self.accepted += accepted
            self.rejected += proposed - accepted
            self.rounds += 1
            if proposed > 0:
                self._ewma = _ewma(self._ewma, accepted / proposed)

    def acceptance_rate(self) -> float:
        """The rolling (EWMA) acceptance rate; 0 before any round."""
        with self._lock:
            return self._ewma if self._ewma is not None else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "gamma": self.gamma,
                "min_acceptance": self.min_acceptance,
                "proposed": self.proposed,
                "accepted": self.accepted,
                "rejected": self.rejected,
                "rounds": self.rounds,
                "acceptance_rate": (self._ewma
                                    if self._ewma is not None else 0.0),
            }
