"""Pipeline parallelism over the ``pp`` mesh axis (GPipe schedule): the
port of ``client_tpu/parallel/pipeline.py``.

Each rank holds its own stage's parameters; microbatch activations go
round the stage ring through ``collectives.ring_shift``. The schedule runs
``n_micro + n_stages - 1`` ticks, the bubble included: at tick t stage 0
feeds microbatch t (clipped), every other stage what it received, and the
last stage keeps its output for microbatch t - (n_stages - 1). The outputs
are then summed over the ring, so every stage holds them. Gradients flow
back through the shifts (each shift's gradient shifts the other way), so
the same call trains: every rank gets its own stage's gradient.

Every stage builds the same graph: the choices between the fed and the
received activation, and between keeping an output or not, are
``torch.where`` selections on the stage index, never a branch, because the
backward shifts run where autograd reaches them and every rank must reach
the same ones in the same order.
"""

from __future__ import annotations

import torch

from client_tpu_torch.parallel import collectives as col
from client_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size


def pipeline_forward(stage_fn, stage_params, x, mesh, n_microbatches: int,
                     pp_axis: str = "pp"):
    """Run ``x`` through the ``pp`` stages of ``mesh``.

    stage_fn(stage_params, act) -> act (shape-preserving). stage_params:
    this rank's stage (the reference's leaves carry a leading stage dim
    sharded over pp; here each rank passes its own slice). x: [batch, ...]
    with batch % n_microbatches == 0, the same on every stage. Returns y,
    shaped like x, on every stage."""
    n_stages = axis_size(mesh, pp_axis)
    group = axis_group(mesh, pp_axis)
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible by "
                         f"{n_microbatches} microbatches")
    mb = batch // n_microbatches
    x_mb = x.reshape((n_microbatches, mb) + tuple(x.shape[1:]))
    stage = axis_index(mesh, pp_axis)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    recv = torch.zeros_like(x_mb[0])
    outputs = [torch.zeros_like(x_mb[0]) for _ in range(n_microbatches)]
    steps = n_microbatches + n_stages - 1
    for t in range(steps):
        first_in = x_mb[min(t, n_microbatches - 1)]
        act_in = torch.where(first, first_in, recv)
        out = stage_fn(stage_params, act_in)
        if t >= n_stages - 1:
            i = t - (n_stages - 1)
            outputs[i] = torch.where(last, out, outputs[i])
        if t + 1 < steps:  # the last tick's shift feeds nothing
            recv = col.ring_shift(out, group)
    y = torch.stack(outputs)
    # only the last stage holds real outputs; the sum replicates them, and
    # each stage's loss of the replicated y sends its gradient back as is
    y = col.reduce_from(torch.where(last, y,
                                    torch.zeros_like(y)), group)
    return y.reshape(x.shape)
