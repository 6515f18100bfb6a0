"""The multi-device dry run: the port of ``__graft_entry__.dryrun_multichip``
steps 1-3, one real training step of each on tiny shapes.

1. dp × sp × tp: the transformer's train step with ring attention (when
   sp > 1) and tensor parallelism;
2. dp × ep: the expert-parallel Switch-MoE train step;
3. pp: the GPipe pipeline, gradients back through the ring.

Step 4, the sharded continuous-batching engine, is ROADMAP item 9b and
raises ``NotImplementedError``.

    python -m client_tpu_torch.parallel.dryrun 8 --device cpu   # 8 gloo ranks
    python -m client_tpu_torch.parallel.dryrun 1                # the card
"""

from __future__ import annotations

import argparse
import math

import torch

from client_tpu_torch.device import resolve_device
from client_tpu_torch.parallel.collectives import run_ranks
from client_tpu_torch.parallel.mesh import (
    factor_devices,
    make_mesh,
)
from client_tpu_torch.parallel.pipeline import pipeline_forward

ENGINE_STEP = ("dryrun step 4, the sharded continuous-batching engine, is "
               "not ported yet: ROADMAP item 9b (A15), the engine's mesh")


def _tokens(seed: int, shape: tuple, vocab: int, device):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen).to(device)


def _train_once(cfg, mesh, dp: int, seq: int, seed: int, device) -> float:
    from client_tpu_torch.models.transformer import make_train_step

    init_state, step = make_train_step(cfg, mesh=mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = init_state(gen)
    tokens = _tokens(seed + 1, (2 * dp, seq), cfg.vocab_size, device)
    _, metrics = step(state, tokens)
    return float(metrics["loss"])


def dryrun_steps(n_devices: int, device=None, steps=(1, 2, 3)) -> dict:
    """Steps 1-3 on every rank of a live process group of ``n_devices``
    ranks; returns each step's loss (the same on every rank). Raises
    ``AssertionError`` when a step's loss is not finite."""
    from client_tpu_torch.models.transformer import TransformerConfig

    if 4 in steps:
        raise NotImplementedError(ENGINE_STEP)
    dev = resolve_device(device)
    out = {}
    if 1 in steps:
        sizes = factor_devices(n_devices, ("dp", "sp", "tp"))
        dp, sp, tp = sizes["dp"], sizes["sp"], sizes["tp"]
        mesh = make_mesh({"dp": dp, "sp": sp, "tp": tp, "pp": 1, "ep": 1},
                         n_devices, device=dev)
        seq = 8 * sp + 1  # L - 1 divides sp for the ring blocks
        cfg = TransformerConfig(
            vocab_size=32 * tp, d_model=32, n_layers=2, n_heads=2 * tp,
            head_dim=8, d_ff=16 * tp, max_seq=seq, dtype=torch.float32,
            attn_impl="ring" if sp > 1 else "ref")
        out["dp_sp_tp"] = _train_once(cfg, mesh, dp, seq, 0, dev)
        assert math.isfinite(out["dp_sp_tp"]), "dp/sp/tp step diverged"
    if 2 in steps:
        sizes = factor_devices(n_devices, ("dp", "ep"))
        dp, ep = sizes["dp"], sizes["ep"]
        mesh = make_mesh({"dp": dp, "ep": ep, "pp": 1, "sp": 1, "tp": 1},
                         n_devices, device=dev)
        cfg = TransformerConfig(
            vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=8,
            d_ff=32, max_seq=17, dtype=torch.float32, attn_impl="ref",
            n_experts=2 * ep)
        out["dp_ep"] = _train_once(cfg, mesh, dp, 17, 2, dev)
        assert math.isfinite(out["dp_ep"]), "ep step diverged"
    if 3 in steps:
        pp = 2 if n_devices % 2 == 0 else 1
        mesh = make_mesh({"pp": pp, "ep": 1, "sp": 1, "tp": 1}, n_devices,
                         device=dev)
        out["pp"] = pipeline_step(mesh, dev)
        assert math.isfinite(out["pp"]), "pp step diverged"
    return out


def pipeline_step(mesh, device) -> float:
    """Step 3: one SGD step (lr 0.1) of a tanh stage per pp rank (weights
    0.1, 16 × 16) on 8 rows of ones against zeros, 2 microbatches;
    returns the loss."""
    dim, batch = 16, 8
    w = torch.full((dim, dim), 0.1, device=device, requires_grad=True)
    x = torch.ones((batch, dim), device=device)
    target = torch.zeros((batch, dim), device=device)
    y = pipeline_forward(lambda wl, act: torch.tanh(act @ wl), w, x, mesh,
                         n_microbatches=2)
    loss = ((y - target) ** 2).mean()
    (g,) = torch.autograd.grad(loss, [w])
    with torch.no_grad():
        w -= 0.1 * g
    return float(loss.detach())


def _dryrun_rank(rank: int, world: int, device, steps) -> dict:
    return dryrun_steps(world, device, steps)


def dryrun_multichip(n_devices: int, device=None, steps=(1, 2, 3),
                     timeout_s: float = 600.0) -> dict:
    """Run ``dryrun_steps`` on ``n_devices`` ranks started by
    ``run_ranks``: NCCL over the cards, or gloo on the CPU with
    ``device="cpu"``. Returns rank 0's losses."""
    if 4 in steps:
        raise NotImplementedError(ENGINE_STEP)
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    return run_ranks(_dryrun_rank, n_devices, backend, timeout_s,
                     args=(dev.type, tuple(steps)))[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks on the CPU (default: the card)")
    args = ap.parse_args(argv)
    print(dryrun_multichip(args.n_devices, args.device))
    print(f"dryrun_multichip({args.n_devices}) OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
