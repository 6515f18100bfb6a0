"""One driver rank, follower ranks: how a sharded model or engine runs on
the port's mesh (``parallel/mesh.py``, one process per device).

The reference is single-controller: one process holds every device, and
GSPMD places the state and inserts the collectives. Here each rank is a
process of its own, so a sharded object runs the way PyTorch serves a
tensor-parallel model:

- every rank builds the same object (a ``TorchModel`` or a
  ``ContinuousBatchingEngine`` with ``mesh=``), holding only its shard;
- rank 0 is the DRIVER: it runs the front end, the batcher, the engine
  thread and every piece of host bookkeeping;
- before each device dispatch the driver broadcasts a small PLAN over the
  object's ``PlanChannel``: the op's name and its host arguments (ints,
  floats and numpy arrays: tokens, positions, block tables, sampling
  parameters, copy lists);
- every rank then runs the same torch ops on its shard, the collectives
  of the op included, and the driver reads the results;
- the other ranks are FOLLOWERS: they loop on the channel, run each plan
  and return at the ``STOP`` plan.

Each object takes a private copy of the mesh's process groups
(``ShardMesh``), so a served model's collectives and an engine's never
interleave on one communicator, and destroys them when it stops. The
compute collectives speak the mesh's backend: NCCL on the card, gloo on
the CPU. The plans always ride a gloo group over the same ranks
(``broadcast_object_list`` of host objects): a follower reads a plan
without waiting for its own queue of kernels, and a plan's wait has the
same timeout behaviour on the card as on the CPU.

Failure is loud. A driver that fails sends a ``FAIL`` plan (the followers
raise ``SpmdError``); under supervision it then sends its supervisor's
verdict on the same channel, ``RESTART`` (every follower builds the same
fresh object and follows it) or ``STOP`` (the crash-loop breaker
tripped: the followers return); a follower waiting longer than the
groups' timeout for a plan raises; an idle driver sends a ``NOOP`` plan every
``HEARTBEAT_S``, so an idle follower never reads as a dead driver. A
compute collective that waits past the timeout raises on the waiting rank
under gloo (the tested path, ``tests/test_torch_mesh_engine.py``). Under
NCCL that wait is caught by NCCL's watchdog instead, which by default
(``TORCH_NCCL_ASYNC_ERROR_HANDLING``) ends the whole process rather than
raising: on the card a follower that wedges inside a collective ends rank
0's process after ``DEFAULT_TIMEOUT_S``, where gloo marks its engine dead.
"""

from __future__ import annotations

import datetime
import time

import torch

# every collective of a ShardMesh's groups raises after this long (the
# plan channel's wait included, which the heartbeat keeps short)
DEFAULT_TIMEOUT_S = 300.0
# the longest the driver leaves the channel silent while it is idle
HEARTBEAT_S = 5.0

STOP = "stop"
NOOP = "noop"
FAIL = "fail"
RESTART = "restart"


class SpmdError(RuntimeError):
    """The driver rank reported its failure over the plan channel."""


class ShardMesh:
    """A private copy of a mesh's process groups: one fresh group
    (``dist.new_group``) per line of every axis of more than one rank,
    one over all of the mesh's ranks, and the plan channel's gloo group
    over them (the same group as the last when the mesh is gloo's). It
    answers what ``parallel.mesh.axis_size`` / ``axis_index`` /
    ``axis_group`` ask of a ``DeviceMesh`` (``mesh_dim_names``, ``shape``,
    ``get_local_rank``, ``get_group``), so the transformer's functions
    take it as a mesh.

    Every rank of the default group must build it, in the same order as
    every other group (``new_group`` is collective over the default
    group). ``destroy`` is each rank's own."""

    def __init__(self, mesh, timeout_s: float = None):
        import torch.distributed as dist

        timeout = datetime.timedelta(
            seconds=DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)
        ranks = torch.as_tensor(mesh.mesh)
        self.mesh_dim_names = tuple(mesh.mesh_dim_names)
        self.shape = tuple(int(n) for n in ranks.shape)
        self.device_type = mesh.device_type
        me = dist.get_rank()
        every = sorted(ranks.flatten().tolist())
        self.all_group = dist.new_group(every, timeout=timeout)
        self.plan_group = (self.all_group if self.device_type == "cpu" else
                           dist.new_group(every, timeout=timeout,
                                          backend="gloo"))
        self._groups, self._local = {}, {}
        for d, name in enumerate(self.mesh_dim_names):
            if self.shape[d] == 1:
                continue
            lines = ranks.movedim(d, -1).reshape(-1, self.shape[d])
            for line in lines.tolist():
                group = dist.new_group(line, timeout=timeout)
                if me in line:
                    self._groups[name] = group
                    self._local[name] = line.index(me)

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def get_group(self, name: str):
        return self._groups[name]

    def get_local_rank(self, name: str) -> int:
        return self._local.get(name, 0)

    def destroy(self) -> None:
        """Destroy this rank's groups, after the object's last collective
        (a card's queued kernels are waited for first). Nothing is left
        to destroy on a second call."""
        import torch.distributed as dist

        if self.all_group is None:
            return
        if self.device_type == "cuda":
            torch.cuda.synchronize()
        groups = [self.all_group, *self._groups.values()]
        if self.plan_group is not self.all_group:
            groups.append(self.plan_group)
        for group in groups:
            dist.destroy_process_group(group)
        self.all_group = self.plan_group = None
        self._groups.clear()


def mesh_device(mesh) -> torch.device:
    """The device this rank's shard lives on: its current card under an
    NCCL mesh, the CPU under a gloo one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class PlanChannel:
    """The driver's plans to its followers, over ``group`` (a
    ``ShardMesh``'s ``plan_group``, gloo): ``send`` on the driver (the
    group's rank 0), ``recv`` on a follower. A plan is ``(op, args)``: a
    name and picklable host values, broadcast with
    ``broadcast_object_list``."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.root = dist.get_global_rank(group, 0)
        self._last_send = time.monotonic()
        self.sent = 0

    @property
    def is_driver(self) -> bool:
        return self.rank == 0

    def send(self, op: str, *args) -> None:
        """Broadcast one plan (the driver only)."""
        import torch.distributed as dist

        dist.broadcast_object_list([(op, args)], src=self.root,
                                   group=self.group)
        self._last_send = time.monotonic()
        self.sent += 1

    def recv(self) -> tuple:
        """The next plan ``(op, args)`` (a follower only). A ``FAIL`` plan
        raises ``SpmdError`` with the driver's message."""
        import torch.distributed as dist

        box = [None]
        # the driver's own pickle, over the object's private process group
        dist.broadcast_object_list(box, src=self.root, group=self.group)
        op, args = box[0]
        if op == FAIL:
            raise SpmdError(f"the driver rank failed: {args[0]}")
        return op, args

    def keepalive(self) -> None:
        """The idle driver's heartbeat: a ``NOOP`` plan once the channel
        has been silent for ``HEARTBEAT_S`` (nothing without followers)."""
        if self.size > 1 and time.monotonic() - self._last_send > HEARTBEAT_S:
            self.send(NOOP)

    def fail(self, err: BaseException) -> None:
        """Tell the followers the driver failed (best effort: the channel
        may be what broke)."""
        try:
            self.send(FAIL, f"{type(err).__name__}: {err}")
        except Exception:  # noqa: BLE001 — the original failure stands
            pass


def follow(channel: PlanChannel, run) -> None:
    """A follower's loop: ``run(op, args)`` for every plan until ``STOP``
    (``NOOP`` is skipped). A failed plan, a ``FAIL`` plan or a broken
    channel raises here, on this rank."""
    while True:
        op, args = channel.recv()
        if op == STOP:
            return
        if op == NOOP:
            continue
        run(op, args)


def await_verdict(channel: PlanChannel) -> bool:
    """A supervised follower after the driver's ``FAIL``: the driver's
    verdict on the same channel, True for ``RESTART`` (the driver's
    supervisor rebuilds the object), False for ``STOP`` (its crash-loop
    breaker tripped)."""
    while True:
        op, _ = channel.recv()
        if op != NOOP:
            return op == RESTART


def broadcast_tensors(tensors: list, mesh: ShardMesh) -> None:
    """Broadcast each tensor of ``tensors`` from the driver over the
    mesh's ``all_group`` (the mesh's backend), IN PLACE (the followers
    pass tensors of the driver's shapes and dtypes to receive into)."""
    import torch.distributed as dist

    root = dist.get_global_rank(mesh.all_group, 0)
    for t in tensors:
        dist.broadcast(t, src=root, group=mesh.all_group)
