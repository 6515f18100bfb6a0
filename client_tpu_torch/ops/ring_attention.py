"""Ring attention, sequence (context) parallelism over the ``sp`` mesh
axis: the port of ``client_tpu/ops/ring_attention.py``.

Q/K/V arrive as this rank's sequence block (one block per rank along
``sp``). Each rank keeps its Q block while the K/V blocks go round the
ring through ``collectives.ring_shift``; the partial softmax results merge
with the online (flash) rescaling rule in f32, so the full L×L score matrix
never exists and each rank holds O(L/n · L/n) scores. The backward comes
from autograd: each shift's gradient shifts the other way.

The reference's shard_map wrapper splits global arrays over dp, sp and tp;
here a rank holds its block already, so ``ring_attention`` takes the
rank's block [B/dp, L/sp, H/tp, D] and runs the per-rank body over the
mesh's sp group.
"""

from __future__ import annotations

import torch

from client_tpu_torch.parallel.collectives import (
    group_rank,
    group_size,
    ring_shift,
)
from client_tpu_torch.parallel.mesh import axis_group

_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)


def ring_attention_local(q, k, v, group, causal: bool = False):
    """The per-rank body. q/k/v: local blocks [B, L_local, H, D]; the
    global sequence is the concatenation of the blocks in the order of
    ``group`` (None: one rank, the whole sequence). Output in q's dtype."""
    n, idx = group_size(group), group_rank(group)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5
    q32 = q.float()
    acc = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), _NEG_BIG, dtype=torch.float32,
                   device=q.device)
    s = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    q_pos = idx * lq + torch.arange(lq, device=q.device)[:, None]
    kb, vb = k, v
    for i in range(n):
        kv_idx = (idx - i) % n
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, kb.float()) * scale
        if causal:
            k_pos = kv_idx * lk + torch.arange(lk, device=q.device)[None, :]
            logits = logits.masked_fill(~(q_pos >= k_pos)[None, None],
                                        _NEG_BIG)
        # the running max is a shift the softmax cancels: no gradient
        new_m = torch.maximum(m, logits.detach().amax(dim=-1))  # [B,H,Lq]
        corr = torch.exp(m - new_m)
        p = torch.exp(logits - new_m[..., None])                 # [B,H,Lq,Lk]
        s = s * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, vb.float())
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = new_m
        if i + 1 < n:  # the reference's last shift feeds nothing
            kb, vb = ring_shift(kb, group), ring_shift(vb, group)
    out = acc / s.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, causal: bool = False):
    """This rank's block [B/dp, L/sp, H/tp, D] of q/k/v attended over the
    whole sequence through the ring of ``mesh``'s sp group."""
    return ring_attention_local(q, k, v, axis_group(mesh, "sp"),
                                causal=causal)
