"""The decoder (Mistral-7B with the configuration's departures) in plain
float32: token embedding; per layer a pre-norm RMSNorm, grouped-query
causal attention with rotary embeddings (the rotate-half form, inverse
frequencies theta^(-2i/head_dim)) scaled by head_dim^-0.5, a pre-norm
RMSNorm and the SwiGLU FFN (silu(x w1) * (x w3)) w2, each with its
residual; a final RMSNorm and the output head, tied to the embedding."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import layer_f32, normed, rounder, tf32_off


def _rope_tables(n: int, head_dim: int, theta: float, device) -> tuple:
    half = head_dim // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=device) / half)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return (torch.cos(ang).float()[:, None, :],
            torch.sin(ang).float()[:, None, :])


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


@torch.no_grad()
def logits_at(arch: dict, params: dict, seqs: list, precision: str = "f32",
              q_block: int = 1024) -> list:
    """``seqs``: ``(tokens [T], positions [n])`` pairs of int tensors on
    the weights' device. Returns, per sequence, the float32 logits
    ``[n, vocab]`` of the next token after each named position, computed
    over the whole sequence layer by layer (causal, so later tokens do not
    change earlier logits), ``q_block`` query rows of attention at a
    time."""
    rnd = rounder(precision)
    d, h, dh = arch["d"], arch["heads"], arch["head_dim"]
    hkv = arch["kv_heads"]
    eps, group = arch["eps"], arch["heads"] // arch["kv_heads"]
    with tf32_off():
        xs = [params["embed"][tok.long()].float() for tok, _ in seqs]
        tables = [_rope_tables(tok.shape[0], dh, arch["rope_theta"],
                               tok.device) for tok, _ in seqs]
        for i in range(arch["layers"]):
            lp = layer_f32(params, i, rnd)
            wq = lp["wq"].reshape(d, h * dh)
            wkv = lp["wkv"].reshape(d, 2 * hkv * dh)
            wo = lp["wo"].reshape(h * dh, d)
            for j, x in enumerate(xs):
                t = x.shape[0]
                cos, sin = tables[j]
                y = normed(x, lp["ln1"], eps, rnd)
                q = _rope((y @ wq).view(t, h, dh), cos, sin)
                kv = (y @ wkv).view(t, 2, hkv, dh)
                k = _rope(kv[:, 0], cos, sin)
                q = rnd(q)
                k = rnd(k.repeat_interleave(group, dim=1))
                v = rnd(kv[:, 1].repeat_interleave(group, dim=1))
                attn = torch.empty((t, h, dh), dtype=torch.float32,
                                   device=x.device)
                for q0 in range(0, t, q_block):
                    q1 = min(t, q0 + q_block)
                    s = torch.einsum("qhd,khd->hqk", q[q0:q1],
                                     k[:q1]) * dh ** -0.5
                    rows = torch.arange(q0, q1, device=x.device)[:, None]
                    cols = torch.arange(q1, device=x.device)[None, :]
                    s.masked_fill_(cols > rows, float("-inf"))
                    p = torch.softmax(s, dim=-1)
                    attn[q0:q1] = torch.einsum("hqk,khd->qhd", rnd(p),
                                               v[:q1])
                x = x + rnd(attn.reshape(t, h * dh)) @ wo
                y = normed(x, lp["ln2"], eps, rnd)
                hid = F.silu(y @ lp["w1"]) * (y @ lp["w3"])
                xs[j] = x + rnd(hid) @ lp["w2"]
        head = rnd(params["embed"].float())
        fnorm = params["final_norm"].float()
        return [normed(x[pos.long()], fnorm, eps, rnd) @ head.T
                for x, (_, pos) in zip(xs, seqs)]
