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

A mesh may be part of the world (``parallel.mesh.subset_mesh``): the
plans then reach its ranks from rank 0 over a gloo group of rank 0 and
the mesh, and a rank 0 outside the mesh hears what it would read of its
own card from the mesh's first rank over a ``ReplyLink``. A replica fleet
whose replicas shard shares one ``FleetChannel`` over the world among
them: the driver sends each replica's plans and launches its own part
under one lock, and each follower reads every plan in one loop, so the
replicas' collectives run in one order on every rank (two NCCL
communicators used on one card from two threads in different orders on
different ranks can deadlock; gloo never shows it).

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

import collections
import datetime
import pickle
import threading
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
# a fleet's channel: replica r's engine is built (every rank builds it
# from the same factory, in this order)
BUILD = "build"


class SpmdError(RuntimeError):
    """The driver rank reported its failure over the plan channel."""


class ShardMesh:
    """A private copy of a mesh's process groups: one fresh group
    (``dist.new_group``) per line of every axis of more than one rank,
    one over all of the mesh's ranks, and the plan channel's gloo group
    over them and the driver, global rank 0 (the same group as the
    all-ranks one when the mesh is gloo's and holds rank 0). A mesh over
    part of the world (``parallel.mesh.subset_mesh``) that leaves out
    rank 0 adds a gloo pair of rank 0 and the mesh's first rank, the
    ``reporter``, which sends the driver what it reads of the card. It
    answers what ``parallel.mesh.axis_size`` / ``axis_index`` /
    ``axis_group`` ask of a ``DeviceMesh`` (``mesh_dim_names``, ``shape``,
    ``get_local_rank``, ``get_group``), so the transformer's functions
    take it as a mesh.

    Every rank of the default group must build it, in the same order as
    every other group (``new_group`` is collective over the default
    group), a rank outside the mesh too (``member`` False: it holds none
    of the groups). ``destroy`` is each rank's own."""

    def __init__(self, mesh, timeout_s: float = None, plans: bool = True):
        import torch.distributed as dist

        timeout = datetime.timedelta(
            seconds=DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)
        ranks = torch.as_tensor(mesh.mesh)
        self.mesh_dim_names = tuple(mesh.mesh_dim_names)
        self.shape = tuple(int(n) for n in ranks.shape)
        self.device_type = mesh.device_type
        me = dist.get_rank()
        every = sorted(ranks.flatten().tolist())
        self.ranks = every
        self.member = me in every

        def group(members, **kw):
            g = dist.new_group(members, timeout=timeout, **kw)
            return g if me in members else None

        self.all_group = group(every)
        # the plans reach the mesh's ranks from the driver, global rank 0,
        # which need not hold a shard (one fleet channel carries them
        # instead with ``plans`` False)
        planned = sorted({0, *every})
        self.plan_group = None
        if plans:
            self.plan_group = (
                self.all_group
                if self.device_type == "cpu" and planned == every
                else group(planned, backend="gloo"))
        # a driver without a shard hears back from the mesh's first rank
        self.reply_group = (group([0, every[0]], backend="gloo")
                            if 0 not in every else None)
        self.reporter = self.reply_group is not None and me == every[0]
        self._destroyed = False
        self._groups, self._local = {}, {}
        for d, name in enumerate(self.mesh_dim_names):
            if self.shape[d] == 1:
                continue
            lines = ranks.movedim(d, -1).reshape(-1, self.shape[d])
            for line in lines.tolist():
                g = group(line)
                if me in line:
                    self._groups[name] = g
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

        if self._destroyed:
            return
        self._destroyed = True
        if self.device_type == "cuda" and self.member:
            torch.cuda.synchronize()
        groups = {id(g): g for g in (self.all_group, self.plan_group,
                                     self.reply_group,
                                     *self._groups.values())
                  if g is not None}
        for group in groups.values():
            dist.destroy_process_group(group)
        self.all_group = self.plan_group = self.reply_group = None
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
        # held by the driver across a plan's send and its own launch
        # (``ContinuousBatchingEngine._exec``); a fleet's channel shares
        # one among its replicas
        self.lock = threading.RLock()

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


class FleetChannel:
    """One plan channel for every replica of a fleet under a mesh: a gloo
    group over the whole live world (built by every rank, collectively),
    whose plans are ``(replica, op, args)``. The driver (global rank 0)
    sends a plan and launches its own part of it under ``lock``, so every
    rank launches every replica's collectives in one order: two replicas
    sharing a card's communicators can never wait on each other in
    different orders on different ranks. Each follower rank reads the
    plans in one loop (``server/fleet.ReplicaFleet.follow``), hands each
    to its own shard of that replica, and skips a replica it holds no
    shard of. A replica's engine talks through ``for_replica(r)``.

    The fleet's lifecycle rides the same channel: ``(r, BUILD)`` before
    the driver builds replica r's engine, its first replicas' too (every
    rank builds it then, so the process groups are made in one order),
    a replica engine's own ``STOP`` and ``FAIL``, and ``(None, STOP)``
    when the fleet shuts down. ``log``, when a list, records every
    ``(replica, op)`` sent or read on this rank."""

    def __init__(self, timeout_s: float = None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise ValueError(
                "a fleet whose replicas shard over a mesh runs one process "
                "per device and needs a live process group (there is "
                "none); start the ranks with parallel.collectives.run_ranks "
                "or init_process_group")
        timeout = datetime.timedelta(
            seconds=DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)
        self.group = dist.new_group(list(range(dist.get_world_size())),
                                    timeout=timeout, backend="gloo")
        self.size = dist.get_world_size(self.group)
        self.is_driver = dist.get_rank() == 0
        self.lock = threading.RLock()
        self.sent = 0
        self.log = None
        self._last_send = time.monotonic()

    def send(self, replica, op: str, *args) -> None:
        """Broadcast one plan (the driver only)."""
        import torch.distributed as dist

        with self.lock:
            dist.broadcast_object_list([(replica, op, args)], src=0,
                                       group=self.group)
            self._last_send = time.monotonic()
            self.sent += 1
            if self.log is not None:
                self.log.append((replica, op))

    def recv(self) -> tuple:
        """The next plan ``(replica, op, args)`` (a follower only)."""
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        if self.log is not None:
            self.log.append(box[0][:2])
        return box[0]

    def keepalive(self) -> None:
        """The idle driver's heartbeat (``(None, NOOP)``)."""
        if self.size > 1 and time.monotonic() - self._last_send > HEARTBEAT_S:
            self.send(None, NOOP)

    def for_replica(self, replica: int) -> "ReplicaChannel":
        return ReplicaChannel(self, replica)

    def destroy(self) -> None:
        import torch.distributed as dist

        if self.group is not None:
            dist.destroy_process_group(self.group)
            self.group = None


class ReplicaChannel:
    """One replica's view of its fleet's ``FleetChannel``: what an engine
    asks of a ``PlanChannel`` (``send``, ``keepalive``, ``fail``,
    ``is_driver``, ``lock``), its plans tagged with the replica."""

    def __init__(self, fleet: FleetChannel, replica: int):
        self.fleet = fleet
        self.replica = replica
        self.lock = fleet.lock
        self.is_driver = fleet.is_driver

    def send(self, op: str, *args) -> None:
        self.fleet.send(self.replica, op, *args)

    def keepalive(self) -> None:
        self.fleet.keepalive()

    def fail(self, err: BaseException) -> None:
        try:
            self.send(FAIL, f"{type(err).__name__}: {err}")
        except Exception:  # noqa: BLE001 — the original failure stands
            pass


class ReplyLink:
    """The pair of ranks of a ``ShardMesh.reply_group``: the mesh's
    reporter sends the driver (global rank 0, which holds no shard) what
    it reads of the card, one pickled ``(kind, object)`` reply at a time,
    without waiting (``send`` keeps each transfer alive until it
    completes: the reporter goes on reading plans meanwhile). The driver
    asks for the next reply of a kind (``recv``): replies of other kinds
    that arrive first wait in order for their own ``recv`` (a sampled
    dispatch's ``sync`` reply may follow a fetch's ring the driver has
    not drained yet)."""

    def __init__(self, group, reporter: int):
        self.group = group
        self.reporter = reporter
        self._inflight: list = []
        self._early: dict = {}

    def send(self, kind: str, obj) -> None:
        import torch.distributed as dist

        data = torch.frombuffer(bytearray(pickle.dumps((kind, obj))),
                                dtype=torch.uint8)
        size = torch.tensor([data.numel()], dtype=torch.int64)
        self._inflight = [(w, t) for w, t in self._inflight
                          if not w.is_completed()]
        for t in (size, data):
            self._inflight.append((dist.isend(t, 0, group=self.group), t))

    def recv(self, kind: str):
        import torch.distributed as dist

        early = self._early.get(kind)
        if early:
            return early.popleft()
        while True:
            size = torch.zeros(1, dtype=torch.int64)
            dist.recv(size, self.reporter, group=self.group)
            data = torch.empty(int(size[0]), dtype=torch.uint8)
            dist.recv(data, self.reporter, group=self.group)
            got, obj = pickle.loads(data.numpy().tobytes())
            if got == kind:
                return obj
            self._early.setdefault(got, collections.deque()).append(obj)

    def flush(self) -> None:
        """Wait until every reply sent has gone out."""
        for w, _ in self._inflight:
            w.wait()
        self._inflight.clear()


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
