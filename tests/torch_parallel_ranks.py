"""Rank bodies of tests/test_torch_parallel.py, run by
``client_tpu_torch.parallel.collectives.run_ranks`` in spawned processes.

This module imports torch and the port only (no JAX), so every rank starts
quickly; the test module computes the reference's results and compares.
Each body returns numpy arrays and numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from client_tpu_torch.models import transformer as tt
from client_tpu_torch.ops.ring_attention import ring_attention
from client_tpu_torch.parallel.collectives import all_gather
from client_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    make_mesh,
)
from client_tpu_torch.parallel.pipeline import pipeline_forward


# Adam's first step is g / (|g| + 1e-8): where the first gradient is below
# TINY_GRAD, within a few orders of that eps, the step turns on the
# gradient's last f32 bits, which two frameworks' summation orders do not
# share (a gradient of 3e-8 that reads 2.5e-8 moves the step by 3% of the
# learning rate). Elsewhere parameters are held at PARAM_ATOL; there, by
# the most AdamW can move a parameter in the steps taken (two learning
# rates a step, since each step is at most one learning rate either way),
# and such elements must stay under TINY_SHARE of each leaf.
PARAM_ATOL, TINY_GRAD, TINY_SHARE = 1e-4, 1e-6, 0.01


def close_params(want: dict, got: dict, first_grads: dict, lr: float,
                 steps: int) -> None:
    """Parameters after ``steps`` AdamW steps at ``lr``, leaf by leaf
    (nested dicts of arrays): within PARAM_ATOL where the first step's
    gradient is 0 or at least TINY_GRAD; elsewhere within 2 * lr * steps,
    on under TINY_SHARE of each leaf's elements."""
    if isinstance(want, dict):
        for k in want:
            close_params(want[k], got[k], first_grads[k], lr, steps)
        return
    err = np.abs(np.asarray(want, np.float64) - np.asarray(got, np.float64))
    g = np.abs(np.asarray(first_grads))
    tiny = (g > 0) & (g < TINY_GRAD)  # an exact 0 is exact in both
    assert err[~tiny].max(initial=0.0) <= PARAM_ATOL, err[~tiny].max()
    assert err[tiny].max(initial=0.0) <= 2 * lr * steps, err[tiny].max()
    assert tiny.mean() < TINY_SHARE, tiny.mean()


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _block(x, mesh, dims: dict):
    """This rank's block of ``x``: dim -> mesh axis."""
    for dim, axis in dims.items():
        n = axis_size(mesh, axis)
        w = x.shape[dim] // n
        x = x.narrow(dim, axis_index(mesh, axis) * w, w)
    return x


def _gather(x, mesh, dims: dict):
    for dim, axis in dims.items():
        x = all_gather(x, axis_group(mesh, axis), dim)
    return x


def cfg_of(kw: dict) -> tt.TransformerConfig:
    return tt.TransformerConfig(dtype=torch.float32, **kw)


def dp_sp_tp(rank, world, case: dict) -> dict:
    """dp2 x sp2 x tp2: the ref config's loss and gathered gradients from
    carried weights, then three train steps; the ring config's forward
    logits, gathered; ring attention causal and not, gathered; the dry
    run's steps at this world size."""
    from client_tpu_torch.parallel.dryrun import dryrun_steps

    mesh = make_mesh({"dp": 2, "sp": 2, "tp": 2}, device="cpu")
    out = {}
    cfg = cfg_of(case["ref_cfg"])
    params = tt.params_from_jax(case["params"], "cpu", torch.float32)
    tokens = torch.from_numpy(case["tokens"])
    shard = tt.shard_params(cfg, params, mesh)
    b = tokens.shape[0] // 2
    mine = tokens[axis_index(mesh, "dp") * b:(axis_index(mesh, "dp") + 1) * b]
    loss, grads = tt.value_and_grad(cfg, shard, mine, mesh)
    out["loss"] = float(loss)
    out["grads"] = _np_tree(tt.unshard_params(cfg, grads, mesh))
    _, step = tt.make_train_step(cfg, mesh=mesh, learning_rate=1e-2)
    state = tt.init_state_from_params(cfg, params, mesh)
    losses = []
    for _ in range(3):
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
    out["losses"] = losses
    out["params"] = _np_tree(tt.unshard_params(cfg, state["params"], mesh))

    ring_cfg = cfg_of(case["ring_cfg"])
    ring_params = tt.params_from_jax(case["ring_params"], "cpu",
                                     torch.float32)
    ring_tokens = torch.from_numpy(case["ring_tokens"])
    logits, _ = tt.forward(ring_cfg, tt.shard_params(ring_cfg, ring_params,
                                                     mesh),
                           _block(ring_tokens, mesh, {0: "dp", 1: "sp"}),
                           mesh)
    out["ring_logits"] = _gather(logits, mesh,
                                 {2: "tp", 1: "sp", 0: "dp"}).numpy()

    qkv = [torch.from_numpy(a) for a in case["qkv"]]
    dims = {0: "dp", 1: "sp", 2: "tp"}
    for causal in (False, True):
        att = ring_attention(*[_block(a, mesh, dims) for a in qkv], mesh,
                             causal=causal)
        out[f"ring_attention_{causal}"] = _gather(
            att, mesh, {2: "tp", 1: "sp", 0: "dp"}).numpy()
    out["dryrun"] = dryrun_steps(world, "cpu")
    return out


def dp_ep_and_pp4(rank, world, case: dict) -> dict:
    """dp2 x ep2: the MoE config's loss, aux and gathered gradients from
    carried weights; then pp4: pipeline_forward of a tanh stage per rank,
    gathered."""
    mesh = make_mesh({"dp": 2, "ep": 2}, device="cpu")
    cfg = cfg_of(case["moe_cfg"])
    params = tt.params_from_jax(case["params"], "cpu", torch.float32)
    tokens = torch.from_numpy(case["tokens"])
    shard = tt.shard_params(cfg, params, mesh)
    b = tokens.shape[0] // 2
    mine = tokens[axis_index(mesh, "dp") * b:(axis_index(mesh, "dp") + 1) * b]
    loss, grads = tt.value_and_grad(cfg, shard, mine, mesh)
    _, aux = tt.forward(cfg, shard, mine[:, :-1], mesh)
    out = {"loss": float(loss), "aux": float(aux),
           "grads": _np_tree(tt.unshard_params(cfg, grads, mesh))}

    pp = make_mesh({"pp": 4}, device="cpu", axes=("pp",))
    w = torch.from_numpy(case["pp_w"])[axis_index(pp, "pp")]
    y = pipeline_forward(lambda p, x: torch.tanh(x @ p["w"]), {"w": w},
                         torch.from_numpy(case["pp_x"]), pp,
                         n_microbatches=2)
    out["pp4"] = y.numpy()
    return out


def pp2_grads(rank, world, case: dict) -> dict:
    """pp2: the gradient of sum(y ** 2) with respect to this rank's stage
    weights, through the pipeline."""
    mesh = make_mesh({"pp": 2}, device="cpu", axes=("pp",))
    w = torch.from_numpy(case["w"])[axis_index(mesh, "pp")]
    w.requires_grad_(True)
    y = pipeline_forward(lambda p, x: torch.tanh(x @ p), w,
                         torch.from_numpy(case["x"]), mesh, n_microbatches=2)
    (g,) = torch.autograd.grad((y ** 2).sum(), [w])
    return {"grad": g.numpy(), "y": y.detach().numpy()}


def dies(rank, world):
    """Rank 1 dies; rank 0 waits in a collective that never completes."""
    import os

    import torch.distributed as dist

    if rank == 1:
        os._exit(3)
    dist.barrier()
    return rank
