"""The encoder (BERT-base with the configuration's departures) in plain
float32: learned positions added to the token embedding; per layer a
pre-norm RMSNorm, bidirectional multi-head attention scaled by
head_dim^-0.5 with no biases, a pre-norm RMSNorm and the tanh GELU FFN,
each with its residual; a final RMSNorm and the mean over the sequence."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import (
    layer_f32,
    normed,
    rmsnorm,
    rounder,
    tf32_off,
)


@torch.no_grad()
def embeddings(arch: dict, params: dict, ids: torch.Tensor,
               precision: str = "f32", block: int = 256) -> torch.Tensor:
    """ids [N, L] (on the weights' device) -> [N, d] float32, layer by
    layer, ``block`` rows at a time."""
    rnd = rounder(precision)
    d, h, dh, eps = arch["d"], arch["heads"], arch["head_dim"], arch["eps"]
    n, length = ids.shape
    with tf32_off():
        x = (params["embed"][ids.long()].float()
             + params["pos_embed"][:length].float())
        for i in range(arch["layers"]):
            lp = layer_f32(params, i, rnd)
            wqkv = lp["wqkv"].reshape(d, 3 * h * dh)
            wo = lp["wo"].reshape(h * dh, d)
            for b0 in range(0, n, block):
                xb = x[b0:b0 + block]
                b = xb.shape[0]
                y = normed(xb, lp["ln1"], eps, rnd)
                qkv = (y @ wqkv).view(b, length, 3, h, dh)
                q, k, v = (rnd(qkv[:, :, j]) for j in range(3))
                s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
                p = torch.softmax(s, dim=-1)
                a = torch.einsum("bhqk,bkhd->bqhd", rnd(p), v)
                xb = xb + rnd(a.reshape(b, length, h * dh)) @ wo
                y = normed(xb, lp["ln2"], eps, rnd)
                hid = F.gelu(y @ lp["w1"], approximate="tanh")
                x[b0:b0 + block] = xb + rnd(hid) @ lp["w2"]
        x = rmsnorm(x, params["final_norm"].float(), eps)
        return x.mean(dim=1)
