"""Plain float32 PyTorch forward passes of the benchmark's architectures,
written from the published descriptions with each departure the
configuration file lists. They import nothing of the program: they take
the benchmark's own weights and inputs, upcast one layer at a time, and
run with TF32 off.

``precision="fp8"`` computes the same passes with every matrix product's
operands rounded to float8 e4m3 (one scale per tensor): the control that
stands one step below the bf16 the configurations serve, which the
comparison that decides ``correct`` has to fail."""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "fp8")
_E4M3_MAX = 448.0


def arch_of(config: dict) -> dict:
    """The shape of a configuration file's model, as the reference and the
    weights read it: the published keys, with the run's value of each key
    the file lists under ``departures``."""
    config = {**config, **{k: v["run"] for k, v in
                           config.get("departures", {}).items()}}
    s = config["structure"]
    heads = config["num_attention_heads"]
    d = config["hidden_size"]
    return {
        "kind": s["kind"],
        "layers": config["num_hidden_layers"],
        "d": d,
        "heads": heads,
        "kv_heads": config.get("num_key_value_heads", heads),
        "head_dim": config.get("head_dim", d // heads),
        "ff": config["intermediate_size"],
        "vocab": config["vocab_size"],
        "positions": config["max_position_embeddings"],
        "rope": s["positions"] == "rope",
        "rope_theta": config.get("rope_theta", 0.0),
        "ffn": s["ffn"],
        "eps": config.get("rms_norm_eps", config.get("layer_norm_eps")),
        "pooling": s.get("pooling"),
    }


@contextlib.contextmanager
def tf32_off():
    """float32 products in float32 (TF32 off) inside the block."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rounder(precision: str):
    """The rounding applied to each operand of a product: none in f32, a
    per-tensor scaled float8 e4m3 round trip in fp8."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    if precision == "f32":
        return lambda x: x

    def fp8(x):
        scale = x.abs().amax().clamp(min=1e-30) / _E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    return fp8


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def normed(x, w, eps: float, rnd):
    """A product's input: the RMSNorm of ``x``, rounded by ``rnd``."""
    return rnd(rmsnorm(x, w, eps))


def layer_f32(params: dict, i: int, rnd) -> dict:
    """Layer ``i``'s weights upcast to float32, each matrix rounded by
    ``rnd`` once (the norms are not products' operands)."""
    out = {}
    for name, w in params["layers"].items():
        w = w[i].float()
        out[name] = w if name.startswith("ln") else rnd(w)
    return out
