"""The multi-device dry run: the port of ``__graft_entry__.dryrun_multichip``,
one real step of each on tiny shapes.

1. dp × sp × tp: the transformer's train step with ring attention (when
   sp > 1) and tensor parallelism;
2. dp × ep: the expert-parallel Switch-MoE train step;
3. pp: the GPipe pipeline, gradients back through the ring;
4. dp × tp: the sharded continuous-batching engine (a llama-family config:
   GQA with one KV head per tp rank, rope, swiglu) streams 5 greedy tokens
   of one prompt, rank 0 driving and the other ranks following.

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


def dryrun_steps(n_devices: int, device=None, steps=(1, 2, 3, 4)) -> dict:
    """``steps`` on every rank of a live process group of ``n_devices``
    ranks; returns each training step's loss and the engine step's
    stream length (the same on every rank). Raises ``AssertionError`` when
    a loss is not finite or the engine's stream falls short."""
    from client_tpu_torch.models.transformer import TransformerConfig

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
    if 4 in steps:
        out["engine"] = engine_step(n_devices, dev)
        assert out["engine"] == 5, "sharded decode engine produced no stream"
    return out


def engine_step(n_devices: int, device) -> int:
    """Step 4: the continuous-batching engine over a dp×tp mesh (n_slots
    2·dp, chunk 4; every rank draws the same weights from seed 4 and keeps
    its shard) streams 5 tokens of the prompt [3, 1, 2] from rank 0;
    returns the stream's length, broadcast to every rank."""
    import torch.distributed as dist

    from client_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from client_tpu_torch.server.generation import ContinuousBatchingEngine

    sizes = factor_devices(n_devices, ("dp", "tp"))
    dp, tp = sizes["dp"], sizes["tp"]
    mesh = make_mesh({"dp": dp, "tp": tp, "pp": 1, "sp": 1, "ep": 1},
                     n_devices, device=device)
    cfg = TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=2 * tp, head_dim=8,
        d_ff=16 * tp, max_seq=16, causal=True, dtype=torch.float32,
        attn_impl="ref", n_kv_heads=tp, rope=True, ffn="swiglu")
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    eng = ContinuousBatchingEngine(cfg, init_params(gen, cfg),
                                   n_slots=2 * dp, chunk=4, mesh=mesh)
    n = torch.zeros((), dtype=torch.int64, device=device)
    if dist.get_rank() == 0:
        eng.start()
        try:
            n += len(list(eng.submit([3, 1, 2], 5)))
        finally:
            eng.stop()
    else:
        eng.start()     # follows rank 0 until it stops
    dist.broadcast(n, src=0)
    return int(n)


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


def dryrun_multichip(n_devices: int, device=None, steps=(1, 2, 3, 4),
                     timeout_s: float = 600.0) -> dict:
    """Run ``dryrun_steps`` on ``n_devices`` ranks started by
    ``run_ranks``: NCCL over the cards, or gloo on the CPU with
    ``device="cpu"``. Returns rank 0's results."""
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
