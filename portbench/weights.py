"""Seeded weights, made on the device in a few large calls, in the type
they are served in and in the program's parameter layout (one stacked
tensor per kind of layer weight). The same tensors go to the program and
to the reference, which upcasts them a layer at a time.

Matrices are normal with the fan-in scaling; norm weights are
1 + 0.1 * normal, so a path that drops them shows."""

from __future__ import annotations

import torch


def _maker(seed: int, device, dtype):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return w.mul_(fan_in ** -0.5)

    def norm(shape):
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return w.mul_(0.1).add_(1.0)

    return dense, norm


def make_params(arch: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of ``arch`` (``reference.arch_of(config)``) from
    ``seed``: ``embed [V, d]``, ``final_norm [d]``, ``pos_embed [P, d]``
    for learned positions, and ``layers`` stacked on a leading layer axis:
    ``ln1``, ``ln2 [d]``, ``wqkv [d, 3, h, dh]`` (or ``wq [d, h, dh]`` and
    ``wkv [d, 2, hkv, dh]`` with fewer KV heads), ``wo [h, dh, d]``,
    ``w1 [d, f]``, ``w2 [f, d]`` and ``w3 [d, f]`` for a gated FFN."""
    dense, norm = _maker(seed, device, dtype)
    n, d, h, dh, f = (arch["layers"], arch["d"], arch["heads"],
                      arch["head_dim"], arch["ff"])
    hkv = arch["kv_heads"]
    layers = {"ln1": norm((n, d)), "ln2": norm((n, d))}
    if hkv != h:
        layers["wq"] = dense((n, d, h, dh), d)
        layers["wkv"] = dense((n, d, 2, hkv, dh), d)
    else:
        layers["wqkv"] = dense((n, d, 3, h, dh), d)
    layers["wo"] = dense((n, h, dh, d), h * dh)
    layers["w1"] = dense((n, d, f), d)
    if arch["ffn"] == "swiglu":
        layers["w3"] = dense((n, d, f), d)
    layers["w2"] = dense((n, f, d), f)
    out = {"embed": dense((arch["vocab"], d), d), "layers": layers,
           "final_norm": norm((d,))}
    if not arch["rope"]:
        out["pos_embed"] = dense((arch["positions"], d), d)
    return out
