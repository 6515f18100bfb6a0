"""Mesh construction and logical-axis sharding rules: the port of
``client_tpu/parallel/mesh.py``.

Five logical axes, MaxText-style naming:

- ``dp``: data parallel. The batch dim; parameters replicated, gradients
  averaged over the group.
- ``pp``: pipeline parallel. Layer stages; activations circulate with the
  ring shift (``parallel/pipeline.py``).
- ``tp``: tensor parallel. Heads, ffn hidden and vocab; matmul partials
  summed over the group.
- ``sp``: sequence (context) parallel. The sequence dim; ring attention
  moves K/V blocks with the ring shift (``ops/ring_attention.py``).
- ``ep``: expert parallel. MoE experts (``ops/moe.py``).

Physical layout: axes are ordered (dp, pp, ep, sp, tp), so tp, the axis
with collectives in every matmul, is the innermost: its ranks are
neighbours, on one host and one NVLink island.

In the port a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the live process group, one rank per device, NCCL on the card and gloo on
the CPU (``parallel/collectives.run_ranks`` starts such a group). The
reference's ``pvary`` has no counterpart: it marks arrays as varying over
shard_map's manual axes for JAX's type system, and a rank's tensors here
are local already.
"""

from __future__ import annotations

from typing import Optional, Sequence

MESH_AXES = ("dp", "pp", "ep", "sp", "tp")


def _balanced_factor(n: int) -> int:
    """Largest factor of n that is <= sqrt(n)."""
    best = 1
    f = 2
    while f * f <= n:
        if n % f == 0:
            best = f
        f += 1
    return best


def factor_devices(n: int, axes: Sequence[str],
                   sizes: Optional[dict] = None) -> dict:
    """Factor ``n`` devices over ``axes``.

    Explicit ``sizes`` entries are honored. Remaining axes are filled from
    the innermost (last) axis outward with balanced factors; the outermost
    free axis absorbs the remainder. Unlisted defaults: pp/ep/sp get 1 so
    the everyday default is plain dp×tp.
    """
    sizes = dict(sizes or {})
    for a in ("pp", "ep", "sp"):
        if a in axes:
            sizes.setdefault(a, 1)
    free = [a for a in axes if a not in sizes]
    if not free:  # fully specified — just validate
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if prod != n:
            raise ValueError(f"sizes {sizes} do not multiply to {n} devices")
        return {a: sizes[a] for a in axes}

    rest = n
    for a, s in sizes.items():
        if s <= 0 or rest % s:
            raise ValueError(f"axis {a}={s} does not divide {n} devices")
        rest //= s
    out = dict(sizes)
    for a in reversed(free[1:]):  # innermost free axes get balanced factors
        f = _balanced_factor(rest)
        # _balanced_factor(prime) == 1; give the whole prime to the last
        # (innermost) free axis so tp rides the nearest links rather than dp.
        if f == 1 and a == free[-1]:
            f = rest
        out[a] = f
        rest //= f
    out[free[0]] = rest  # outermost free axis absorbs the remainder
    return {a: out[a] for a in axes}


def make_mesh(axis_sizes: Optional[dict] = None,
              n_devices: Optional[int] = None,
              device=None,
              axes: Sequence[str] = MESH_AXES):
    """A ``DeviceMesh`` over ``axes`` spanning every rank of the live
    process group, with ``mesh_dim_names=axes``.

    With no explicit ``axis_sizes`` the rank count is factored as
    ``factor_devices`` does (pp=ep=sp=1, the rest split dp×tp). ``device``
    follows the device rule: the card (the group must be NCCL) unless
    ``device="cpu"`` is passed (the group must be gloo). ``n_devices``,
    when given, must equal the world size: a rank cannot sit out of a
    mesh it constructs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from client_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a live process group: call "
            "torch.distributed.init_process_group, or run the code under "
            "client_tpu_torch.parallel.collectives.run_ranks")
    backend = str(dist.get_backend()).lower()
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(f"a {dev.type} mesh runs over {want}; the process "
                         f"group's backend is {backend}")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh spans every rank: n_devices {n} != world "
                         f"size {world}")
    sizes = factor_devices(n, axes, axis_sizes)
    return init_device_mesh(dev.type, tuple(sizes[a] for a in axes),
                            mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh or for an axis the mesh
    lacks)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``; None when
    the axis has one rank (no communication is needed)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


# Logical tensor-dimension names -> mesh axes. Model code annotates params
# and activations with logical names; this table maps them to the physical
# mesh.
LOGICAL_RULES = {
    "batch": "dp",
    "seq": "sp",
    "seq_kv": None,          # kv sequence stays whole inside ring steps
    "model": None,           # d_model replicated; partials summed over tp
    "heads": "tp",
    "head_dim": None,
    "ff": "tp",
    "vocab": "tp",
    "expert": "ep",
    "stage": "pp",
    "layers": None,
}


def shard_tree(tree, specs, mesh, path: str = ""):
    """This rank's block of every leaf of ``tree`` (nested dicts of
    tensors): ``specs`` has the tree's structure and gives each leaf a
    tuple with the mesh axis (or None) of every dim, as ``param_specs``
    returns them; each dim split over an axis of more than one rank is cut
    to the rank's contiguous block along it. Raises ``ValueError`` when an
    axis does not divide its dim."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, f"{path}{k}.")
                for k, v in tree.items()}
    x = tree
    for dim, axis in enumerate(specs):
        n = axis_size(mesh, axis) if axis else 1
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"{path.rstrip('.')}: dim {dim} of size "
                             f"{x.shape[dim]} does not split over "
                             f"{axis}={n}")
        w = x.shape[dim] // n
        x = x.narrow(dim, axis_index(mesh, axis) * w, w)
    return x.contiguous()


class RankMesh:
    """A mesh over named ranks of the live process group that builds no
    process group of its own: ``mesh`` is the tensor of global ranks (one
    dim per axis of ``mesh_dim_names``), ``device_type`` their devices'
    type. It answers what ``axis_size`` and the engine's ``resolve_mesh``
    read of a ``DeviceMesh``; the object that runs on it builds its groups
    (``parallel.spmd.ShardMesh``). A rank outside ``mesh`` may hold one:
    it takes part in building the groups and holds no shard."""

    def __init__(self, ranks, mesh_dim_names: Sequence[str],
                 device_type: str):
        import torch

        self.mesh = torch.as_tensor(ranks)
        self.mesh_dim_names = tuple(mesh_dim_names)
        self.device_type = device_type
        self.shape = tuple(int(n) for n in self.mesh.shape)


# the device each rank of the live group holds, gathered once per group
_HELD: list = [None, None]


def rank_devices() -> list:
    """The device each rank of the live process group holds, by rank:
    ``cuda:<current card>`` under NCCL, ``cpu:<rank>`` under gloo, with
    or without a card (device index i names rank i there). Collective the
    first time in a process group (every rank calls it); cached after."""
    import torch
    import torch.distributed as dist

    world = dist.group.WORLD
    if _HELD[0] is not world:
        if str(dist.get_backend()).lower() == "nccl":
            mine = f"cuda:{torch.cuda.current_device()}"
        else:
            mine = f"cpu:{dist.get_rank()}"
        held = [None] * dist.get_world_size()
        dist.all_gather_object(held, mine)
        _HELD[0], _HELD[1] = world, held
    return list(_HELD[1])


def subset_mesh(devices: Sequence) -> RankMesh:
    """The reference's ``engine_devices`` rule for a subset of k > 1
    devices: a k x 1 ``("dp", "tp")`` mesh over exactly that subset. A
    process here holds one device, so the mesh is over the ranks that
    hold ``devices`` (``torch.device``s), in the subset's order: the
    whole live group or any part of it (``rank_devices``). A subset with
    a device no rank holds raises ``ValueError`` saying so, and so does a
    call without a live process group. Collective on its first call in
    a process group."""
    import torch.distributed as dist

    k = len(devices)
    if not dist.is_initialized():
        raise ValueError(
            f"engine_devices over {k} devices shards one engine over the "
            f"ranks of a live process group that hold them, one per "
            f"device (there is no live process group); start the ranks "
            f"with parallel.collectives.run_ranks or init_process_group")
    held = rank_devices()
    ranks = []
    for d in devices:
        if str(d) not in held:
            raise ValueError(
                f"engine_devices {[str(d) for d in devices]} names "
                f"{d}, which no rank of the live process group of "
                f"{len(held)} ranks holds (they hold {held})")
        ranks.append(held.index(str(d)))
    return RankMesh([[r] for r in ranks], ("dp", "tp"),
                    devices[0].type)


def logical_to_physical(logical_axes: Sequence[Optional[str]],
                        rules: Optional[dict] = None) -> tuple:
    """Map a tuple of logical dim names to the mesh axis each dim is split
    over, or None (the reference returns a ``PartitionSpec`` of the same
    entries)."""
    rules = {**LOGICAL_RULES, **(rules or {})}
    return tuple(rules.get(a) if a else None for a in logical_axes)
