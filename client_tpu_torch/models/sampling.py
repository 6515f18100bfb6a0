"""Token selection for the decode paths: the port of
``client_tpu/models/sampling.py``.

The selection rule is the reference's, branch for branch:

    temperature <= 0     -> greedy argmax;
    top_k == top_p == 0  -> full-vocab categorical at ``temperature``;
    top_k >= 1           -> categorical over the top min(top_k, max_top_k)
                            logits;
    top_p in (0, 1]      -> nucleus: the smallest prefix of the sorted
                            candidates (within the top ``max_top_k``) whose
                            mass reaches top_p, evaluated from the tail so a
                            float32 cumsum cannot saturate; the first
                            candidate always survives.

A categorical draw is ``argmax(logits + gumbel_noise)``, exactly what
``jax.random.categorical`` computes. ``sample_next`` therefore takes its
noise as arguments: the reference draws a vocab-wide vector for the
full-vocab branch and a ``max_top_k``-wide one for the truncated branches
from one key, and a test can hand the port those very draws
(``jax.random.gumbel``) and hold the selection rule to exact agreement.

``sample_step`` and ``sample_loop`` decode and select in one step, or
in ``k`` steps kept on the device, for the single-stream and static-batch
generators (``models/decoder_lm.py``).

``select_token`` derives the noise statelessly from (seed, position) with
a counter-based integer hash in torch ops, so one (seed, position) pair
always gives the same draw, on the card or the CPU, with no global RNG
and no host round trip. The draws are not the reference's (its threefry
bits are not reproduced); the distribution is the same. Under an engine's
mesh each dp rank draws the noise of its own slots from their (seed,
position), and every rank of a tp group the same, so a sharded engine's
sampled streams equal the unsharded engine's. A salt separates
the independent streams speculative decoding draws at one position
(``step_noise(..., salt=)``, ``step_uniform``), and ``filtered_probs``
gives the probabilities ``sample_next`` draws from, the basis of its
modified rejection sampling.

Every branch is computed and ``torch.where`` selects, as the reference's
``jnp.where`` does: temperature, top_k and top_p are per-slot data, and
nothing here reads a device value on the host.
"""

from __future__ import annotations

import torch

# requests may ask for any 1 <= top_k <= this
MAX_TOP_K = 64

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser on int64 tensors (every multiplier is
    below 2^31, so no product leaves the int64 range)."""
    x = x & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _M32
    x = ((x ^ (x >> 16)) * 0x297A2D39) & _M32
    return x ^ (x >> 16)


def _salt_key(salt: int) -> int:
    """A salt as the 32-bit word the step key is mixed with (a host
    int; 0 is never used, so salt 0 leaves the key as it was)."""
    x = (int(salt) * 0x9E3779B1 + 0x7F4A7C15) & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def _step_bits(seed, pos, n: int, salt: int = 0) -> torch.Tensor:
    """n 32-bit words of the stream of (seed, pos, salt), [..., n] int64:
    the port's stand-in for ``fold_in(step_key(seed, pos), salt)``. Salt 0
    is the unsalted stream the selection draw uses."""
    seed = torch.as_tensor(seed).long()
    pos = torch.as_tensor(pos, device=seed.device).long()
    key = _mix32(_mix32(seed) ^ ((pos + 0x632BE5AB) & _M32))
    if salt:
        key = _mix32(key ^ _salt_key(salt))
    idx = torch.arange(n, device=seed.device)
    return _mix32(key[..., None] + idx * 0x61C88647)


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    # 23 random bits + 0.5: exact in f32, strictly inside (0, 1)
    return ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))


def step_gumbel(seed, pos, n: int, salt: int = 0) -> torch.Tensor:
    """n Gumbel draws per row of (seed, pos, salt), f32 [..., n]: the
    first n of the stream ``step_noise`` cuts in two."""
    return -torch.log(-torch.log(_uniform(_step_bits(seed, pos, n, salt))))


def step_noise(seed, pos, vocab: int, max_top_k: int = MAX_TOP_K,
               salt: int = 0) -> tuple:
    """The Gumbel noise of one decode step for each row: a pure function of
    (seed, pos, salt). ``seed``/``pos`` are int tensors of one shape [...]
    (or Python ints); ``salt`` (a host int) separates the independent
    streams speculation draws at one position (``server/speculation.py``).
    Returns (gumbel [..., vocab] f32, gumbel_k [..., min(max_top_k,
    vocab)] f32)."""
    g = step_gumbel(seed, pos, vocab + min(max_top_k, vocab), salt)
    return g[..., :vocab], g[..., vocab:]


def step_uniform(seed, pos, salt: int = 0) -> torch.Tensor:
    """One uniform in (0, 1) per row of (seed, pos, salt), f32 [...]: the
    port's stand-in for ``jax.random.uniform(fold_in(step_key(seed, pos),
    salt))``."""
    return _uniform(_step_bits(seed, pos, 1, salt))[..., 0]


def sample_next(logits, gumbel, gumbel_k, temperature, top_k, top_p=0.0,
                max_top_k: int = MAX_TOP_K) -> torch.Tensor:
    """Select the next token of each row of ``logits`` [..., vocab] (f32).

    ``gumbel`` [..., vocab] feeds the full-vocab categorical and
    ``gumbel_k`` [..., min(max_top_k, vocab)] the truncated one;
    ``temperature``/``top_k``/``top_p`` are scalars or [...] tensors on
    the logits' device. Returns int32 [...]."""
    logits = logits.float()
    dev = logits.device
    vocab = logits.shape[-1]
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=dev)[..., None]
    tk = torch.as_tensor(top_k, device=dev).long()[..., None]
    tp = torch.as_tensor(top_p, dtype=torch.float32, device=dev)[..., None]
    neg_inf = torch.full((), float("-inf"), device=dev)
    greedy = logits.argmax(dim=-1)
    scaled = logits / temp.clamp(min=1e-6)
    full = (scaled + gumbel).argmax(dim=-1)
    k = min(max_top_k, vocab)  # tiny-vocab models
    vals, idx = torch.topk(scaled, k, dim=-1)      # sorted descending
    ar = torch.arange(k, device=dev)
    kk = torch.where(tk > 0, tk.clamp(1, k), k)
    keep = ar < kk
    # nucleus from the TAIL: preceding mass < top_p <=> remaining mass >
    # 1 - top_p, which a reverse cumsum cannot saturate
    probs = torch.softmax(torch.where(keep, vals, neg_inf), dim=-1)
    remaining = probs.flip(-1).cumsum(-1).flip(-1)
    keep = keep & torch.where(tp > 0, remaining > 1.0 - tp, True)
    # the first candidate always survives (a top_p below f32 epsilon
    # rounds 1 - top_p up to 1 and would empty the nucleus)
    keep = keep | (ar == 0)
    masked = torch.where(keep, vals, neg_inf)
    choice = (masked + gumbel_k).argmax(dim=-1, keepdim=True)
    trunc = idx.gather(-1, choice)[..., 0]
    sampled = torch.where((tk[..., 0] > 0) | (tp[..., 0] > 0), trunc, full)
    return torch.where(temp[..., 0] > 0, sampled, greedy).to(torch.int32)


def select_token(logits, seed, pos, temperature, top_k, top_p=0.0,
                 max_top_k: int = MAX_TOP_K) -> torch.Tensor:
    """``sample_next`` with the stateless per-step noise of (seed, pos):
    the one definition the engine and ``offline_sample`` use."""
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor(seed, device=logits.device)
    g, gk = step_noise(seed, pos, logits.shape[-1], max_top_k)
    return sample_next(logits, g, gk, temperature, top_k, top_p, max_top_k)


def sample_step(cfg, params, tokens, state, seed, temperature, top_k,
                top_p=0.0, max_top_k: int = MAX_TOP_K) -> tuple:
    """One decode step of every slot of a slot-layout state and the
    selection of each slot's next token: the reference's ``sample_step``
    (and, over ``[S]`` slots, its ``vmap``). tokens [S] int32; ``seed``
    a scalar or [S]; each selection draws at the slot's position BEFORE
    the step. ``decode_step`` writes K/V in place. Returns (next [S]
    int32, the state with ``pos + 1``)."""
    from client_tpu_torch.models import transformer as t

    pos = state["pos"]
    logits, new_state = t.decode_step(cfg, params, tokens, state)
    nxt = select_token(logits, seed, pos, temperature, top_k, top_p,
                       max_top_k)
    return nxt, new_state


def sample_loop(cfg, params, tokens, state, k: int, seed, temperature,
                top_k, top_p=0.0, max_top_k: int = MAX_TOP_K) -> tuple:
    """``k`` eager ``sample_step``s: the reference's ``sample_loop`` (its
    ``lax.scan``) as a Python loop that keeps every token on the device
    and reads nothing back. tokens [S] is the next token to feed (and the
    first one emitted). Returns (toks [S, k] int32, the tokens fed; next
    [S], the successor to feed a following chunk; the state)."""
    toks = []
    for _ in range(k):
        toks.append(tokens)
        tokens, state = sample_step(cfg, params, tokens, state, seed,
                                    temperature, top_k, top_p, max_top_k)
    return torch.stack(toks, dim=1), tokens, state


def filtered_probs(logits, temperature, top_k, top_p=0.0,
                   max_top_k: int = MAX_TOP_K) -> torch.Tensor:
    """The full-vocab probabilities of the distribution ``sample_next``
    draws from, for each row of ``logits`` [..., vocab]: the p and q of
    speculative decoding's modified rejection sampling. Branch for branch
    the reference's ``filtered_probs``: a one-hot at the argmax for
    temperature <= 0; the softmax at the temperature; with top-k or
    nucleus truncation, the softmax over ``sample_next``'s kept candidates
    (the same ``topk`` set, tie order, tail-mass nucleus and
    first-candidate guard), renormalised and scattered back to vocab
    positions. ``temperature``/``top_k``/``top_p`` are scalars or [...]
    tensors. Returns f32 [..., vocab]."""
    logits = logits.float()
    dev = logits.device
    vocab = logits.shape[-1]
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=dev)[..., None]
    tk = torch.as_tensor(top_k, device=dev).long()[..., None]
    tp = torch.as_tensor(top_p, dtype=torch.float32, device=dev)[..., None]
    neg_inf = torch.full((), float("-inf"), device=dev)
    greedy = torch.zeros_like(logits).scatter_(
        -1, logits.argmax(dim=-1, keepdim=True), 1.0)
    scaled = logits / temp.clamp(min=1e-6)
    full = torch.softmax(scaled, dim=-1)
    k = min(max_top_k, vocab)
    vals, idx = torch.topk(scaled, k, dim=-1)      # sorted descending
    ar = torch.arange(k, device=dev)
    kk = torch.where(tk > 0, tk.clamp(1, k), k)
    keep = ar < kk
    probs = torch.softmax(torch.where(keep, vals, neg_inf), dim=-1)
    remaining = probs.flip(-1).cumsum(-1).flip(-1)
    keep = keep & torch.where(tp > 0, remaining > 1.0 - tp, True)
    keep = keep | (ar == 0)
    trunc = torch.softmax(torch.where(keep, vals, neg_inf), dim=-1)
    trunc_full = torch.zeros_like(logits).scatter_(
        -1, idx, torch.where(keep, trunc, 0.0))
    sampled = torch.where((tk > 0) | (tp > 0), trunc_full, full)
    return torch.where(temp > 0, sampled, greedy)


def offline_sample(cfg, params, prompt, n: int, seed: int = 0,
                   temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 0.0, max_top_k: int = MAX_TOP_K,
                   block_len: int = 16, attention=None) -> list:
    """Reference decode for tests: feed ``prompt`` one token at a time,
    then generate ``n`` tokens with the engine's selection rule, through
    ``transformer.paged_decode_steps`` with one slot (S=1) over a pool of
    its own, on the device of ``params``. ``attention`` is handed to
    ``paged_decode_steps`` (None follows ``cfg.attn_impl``)."""
    from client_tpu_torch.models import transformer as t

    dev = params["embed"].device
    n_blocks = -(-cfg.max_seq // block_len)
    shape = (cfg.n_layers, n_blocks + 1, block_len, cfg.kv_heads,
             cfg.head_dim)
    pool = {name: torch.zeros(shape, dtype=cfg.dtype, device=dev)
            for name in ("k", "v")}
    tables = torch.arange(1, n_blocks + 1, dtype=torch.int32,
                          device=dev)[None]
    seed_t = torch.tensor([seed], device=dev)

    def step(tok: int, pos: int) -> int:
        tok_t = torch.tensor([tok], dtype=torch.int32, device=dev)
        pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
        logits, _ = t.paged_decode_steps(cfg, params, tok_t, pos_t, tables,
                                         pool, attention=attention)
        return int(select_token(logits, seed_t, pos_t, temperature, top_k,
                                top_p, max_top_k)[0])

    nxt = None
    for i, tok in enumerate(prompt):
        nxt = step(int(tok), i)
    out = []
    for j in range(n):
        out.append(nxt)
        nxt = step(nxt, len(prompt) + j)
    return out
