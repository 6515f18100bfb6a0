"""Differentiable collectives for the port's mesh, and ``run_ranks``, which
starts one process per rank.

The reference writes its collectives as ``lax.ppermute`` and ``lax.psum``
inside shard_map, or lets GSPMD insert them; JAX's transpose rules give
their gradients. Here each is an autograd function over a process group,
with the gradient written out:

- ``ring_shift``: rank j's tensor goes to rank j + 1 of the group (the
  ``lax.ppermute`` of the ring); its backward shifts the other way.
- ``copy_to`` / ``reduce_from``: the Megatron pair around a
  tensor-parallel (or expert-parallel) block whose input is replicated
  over the group. ``copy_to`` is the identity forward and sums the
  gradient over the group backward; ``reduce_from`` sums the partial
  outputs forward and passes the gradient through backward, since every
  rank of the group goes on with the same tensor and the same loss.
- ``all_reduce_sum``: a sum whose result each rank consumes on its own,
  towards a loss of its own (ranks that hold different tokens): the
  backward sums the gradient over the group too.
- ``all_gather``: the concatenation of every rank's block along a dim,
  again consumed per rank; the backward sums the gradient over the group
  and keeps this rank's block.

``torch.distributed.nn.functional`` has a differentiable all-reduce with
``all_reduce_sum``'s gradient, but this PyTorch marks it deprecated (it
warns on use) and it has neither of the Megatron halves, so the port keeps
these few functions of its own. Every function is the identity when the
group is None (one rank on the axis).

Backward collectives run in the order autograd reaches them, so every rank
of a group must build the same graph: the callers select with masks and
``torch.where``, never with a branch on the rank.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import signal
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _shift(x, group, offset: int):
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    dst = dist.get_global_rank(group, (idx + offset) % n)
    src = dist.get_global_rank(group, (idx - offset) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return _shift(x, group, offset)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.offset), None, None


def ring_shift(x, group, offset: int = 1):
    """Rank j of ``group`` receives rank (j - offset)'s ``x``."""
    n = group_size(group)
    if n == 1 or offset % n == 0:
        return x
    return _RingShift.apply(x, group, offset)


def _all_reduce(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.idx, ctx.width = dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        full = _all_reduce(grad, ctx.group)
        return full.narrow(ctx.dim, ctx.idx * ctx.width,
                           ctx.width).contiguous(), None, None


def copy_to(x, group):
    """Identity forward; the gradient summed over ``group`` backward."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Sum over ``group`` forward; the gradient passed through backward."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def all_reduce_sum(x, group):
    """Sum over ``group``, forward and backward."""
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def all_gather(x, group, dim: int):
    """Every rank's ``x`` concatenated along ``dim`` in group order."""
    return x if group_size(group) == 1 else _AllGather.apply(x, group, dim)


def all_reduce_max(x, group):
    """Elementwise max over ``group``; no gradient (callers detach)."""
    if group_size(group) == 1:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def average_(tensors: list, groups: list) -> None:
    """Average ``tensors`` IN PLACE over every group of ``groups`` (one
    flat buffer, one all-reduce per group of more than one rank)."""
    groups = [g for g in groups if group_size(g) > 1]
    if not groups or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    n = 1
    for g in groups:
        dist.all_reduce(flat, group=g)
        n *= group_size(g)
    flat /= n
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


# ---------------------------------------------------------------- run_ranks

def _rank_main(fn, rank: int, world: int, backend: str, init: str,
               timeout_s: float, args_path: str, results) -> None:
    torch.set_num_threads(1)
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)  # written by run_ranks, this program
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        value = fn(rank, world, *args)
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent, then exit
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)
    results.put((rank, True, value))
    results.close()
    results.join_thread()


def run_ranks(fn, world: int, backend: str = "gloo",
              timeout_s: float = 300.0, args: tuple = ()) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (spawned)
    joined into one process group over ``backend`` (``"nccl"``: rank r on
    card r % device count; ``"gloo"``: the CPU), and return the values,
    in rank order.

    The rendezvous is a ``file://`` store in a fresh temporary directory,
    so concurrent calls never contend for a port. Every rank calls
    ``torch.set_num_threads(1)``. ``fn`` must be importable by name and
    return a picklable value (numpy arrays and numbers, not tensors).
    When a rank raises or dies, or the ranks have not all returned within
    ``timeout_s``, every rank is killed and ``RuntimeError`` names the
    rank (with its traceback when it raised)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="run-ranks-")
    init = "file://" + os.path.join(tmp, "rendezvous")
    # the arguments go through a file: a start() whose pickle outgrows the
    # pipe waits until that child has imported what it needs, one rank
    # after another
    args_path = os.path.join(tmp, "args.pickle")
    with open(args_path, "wb") as f:
        pickle.dump(tuple(args), f)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, init, timeout_s,
                               args_path, results))
             for r in range(world)]
    values, failure = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(values) < world and failure is None:
            try:
                failure = _take(results.get(timeout=0.2), values)
                continue
            except queue_mod.Empty:
                pass
            if any(r not in values and p.exitcode is not None
                   for r, p in enumerate(procs)):
                failure = _late_report(results, values, procs)
            elif time.monotonic() > deadline:
                missing = sorted(set(range(world)) - set(values))
                failure = (f"ranks {missing} did not finish within "
                           f"{timeout_s} s")
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=30)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        # a rank that died first often shows only as its peers' errors
        died = [f"rank {r} exited with code {p.exitcode}"
                for r, p in enumerate(procs)
                if p.exitcode not in (None, 0, 1, -signal.SIGKILL)]
        raise RuntimeError(f"run_ranks({world} ranks, {backend}): "
                           + "; ".join(died + [failure]))
    return [values[r] for r in range(world)]


def _take(message: tuple, values: dict):
    """Store a rank's value; a rank's traceback is the failure."""
    rank, ok, value = message
    if ok:
        values[rank] = value
        return None
    return f"rank {rank} raised:\n{value}"


def _late_report(results, values: dict, procs: list):
    """Some rank exited before its value arrived. Read what is still in
    flight (values, or a traceback); a rank that exited without either is
    reported with its exit code."""
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        try:
            failure = _take(results.get(timeout=0.1), values)
        except queue_mod.Empty:
            continue
        if failure is not None:
            return failure
    for r, p in enumerate(procs):
        if r not in values and p.exitcode is not None:
            return f"rank {r} exited with code {p.exitcode} before returning"
    return None
