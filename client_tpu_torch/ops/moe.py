"""Switch-style top-1 mixture-of-experts FFN: the port of
``client_tpu/ops/moe.py``.

Dispatch and combine are one-hot einsums in f32, as in the reference: no
gather or scatter, no data-dependent shapes. Tokens over an expert's
capacity get zero output (the residual stream outside carries them), as
in Switch Transformer.

``moe_ffn`` is the reference's function on one device. ``moe_ffn_sharded``
computes the same function inside a mesh, where every rank holds a dp×sp
block of the tokens (replicated over ep and tp), the router whole, and an
ep×tp block of the experts ([E/ep, d, f/tp] and [E/ep, f/tp, d]). GSPMD
computes the reference on the global view, so the capacity counts the
global T and each token's slot is its rank in the cumsum over global token
order; the sharded form keeps both exact:

1. the router logits [T_local, E] are all-gathered over sp and dp into
   the global [T, E] (T·E·4 bytes received per rank and layer), and every
   rank routes all T tokens (softmax, argmax, the aux loss, the cumsum);
2. each rank dispatches its own tokens to its local experts and the
   buffers [E/ep, C, d] are summed over dp and sp (E/ep·C·d·4 bytes
   all-reduced per layer); each (expert, slot) holds one token, so the sum
   is exact;
3. every rank of the token block runs its local experts on the whole
   buffer (dp·sp-fold redundant work) and picks its tokens' rows; the
   partial rows [T_local, d] are summed over ep and tp (T_local·d·4
   bytes all-reduced per layer, twice when both are split), and the gate
   multiplies the sum.

The backward moves as many bytes again. An all_to_all dispatch that sends
each token only to its expert's rank is later performance work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from client_tpu_torch.parallel import collectives as col
from client_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size


def _route(logits, capacity: int) -> tuple:
    """Top-1 routing of logits [T, E] (f32): (gate [T], slot [T, E] int64,
    keep [T, E] bool, aux): the reference's order of operations."""
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    expert_idx = probs.argmax(dim=-1)                            # [T]
    expert_gate = probs.gather(-1, expert_idx[:, None])[:, 0]    # [T]
    expert_1h = F.one_hot(expert_idx, e).float()                 # [T, E]
    # load-balancing aux loss (Switch eq. 4)
    density = expert_1h.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = e * (density * density_proxy).sum()
    # position of each token within its expert's buffer
    pos = torch.cumsum(expert_1h, dim=0) * expert_1h - 1.0       # [T, E]
    keep = (pos < capacity) & (pos >= 0)
    slot = pos.clamp(0, capacity - 1).long()
    return expert_gate, slot, keep, aux


def _capacity(t: int, e: int, capacity_factor: float) -> int:
    return max(1, int((t / e) * capacity_factor))


def moe_ffn(x, router_w, w1, w2, capacity_factor: float = 1.25) -> tuple:
    """x: [T, d]; router_w: [d, E]; w1: [E, d, f]; w2: [E, f, d].

    Returns (out [T, d] in x's dtype, aux_loss f32 scalar). Tokens over
    capacity contribute zero output."""
    t = x.shape[0]
    e = router_w.shape[1]
    capacity = _capacity(t, e, capacity_factor)
    logits = torch.einsum("td,de->te", x.float(), router_w.float())
    gate, slot, keep, aux = _route(logits, capacity)
    dispatch = F.one_hot(slot, capacity).float() * keep[..., None]  # [T,E,C]
    combine = dispatch * gate[:, None, None]
    xe = torch.einsum("tec,td->ecd", dispatch, x.float())
    h = torch.einsum("ecd,edf->ecf", xe, w1.float())
    h = F.gelu(h, approximate="tanh")
    ye = torch.einsum("ecf,efd->ecd", h, w2.float())
    out = torch.einsum("tec,ecd->td", combine, ye)
    return out.to(x.dtype), aux


def moe_ffn_sharded(x, router_w, w1, w2, capacity_factor: float,
                    mesh) -> tuple:
    """``moe_ffn`` inside ``mesh`` (see the module docstring). x: this
    rank's token block [B/dp, L/sp, d]; router_w [d, E] whole; w1
    [E/ep, d, f/tp]; w2 [E/ep, f/tp, d]. Returns (out [B/dp, L/sp, d] in
    x's dtype, the global aux loss). One rank (no mesh) gives ``moe_ffn``'s
    values bit for bit."""
    b, l, d = x.shape
    dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
    dp_g, sp_g = axis_group(mesh, "dp"), axis_group(mesh, "sp")
    ep_g, tp_g = axis_group(mesh, "ep"), axis_group(mesh, "tp")
    e = router_w.shape[1]
    big_l = l * sp
    t = b * dp * big_l
    capacity = _capacity(t, e, capacity_factor)

    logits = torch.einsum("bld,de->ble", x.float(), router_w.float())
    logits = col.all_gather(col.all_gather(logits, sp_g, 1), dp_g, 0)
    gate, slot, keep, aux = _route(logits.reshape(t, e), capacity)

    # this rank's tokens, in global order, and its experts
    bi = axis_index(mesh, "dp") * b + torch.arange(b, device=x.device)
    li = axis_index(mesh, "sp") * l + torch.arange(l, device=x.device)
    rows = (bi[:, None] * big_l + li[None, :]).reshape(-1)
    e_loc = w1.shape[0]
    e0 = axis_index(mesh, "ep") * e_loc
    slot, keep = slot[rows, e0:e0 + e_loc], keep[rows, e0:e0 + e_loc]
    dispatch = F.one_hot(slot, capacity).float() * keep[..., None]

    xin = col.copy_to(col.copy_to(x.reshape(b * l, d).float(), ep_g), tp_g)
    xe = torch.einsum("tec,td->ecd", dispatch, xin)
    xe = col.all_reduce_sum(col.all_reduce_sum(xe, sp_g), dp_g)
    h = torch.einsum("ecd,edf->ecf", xe, w1.float())
    h = F.gelu(h, approximate="tanh")
    ye = torch.einsum("ecf,efd->ecd", h, w2.float())
    y = torch.einsum("tec,ecd->td", dispatch, ye)
    y = col.reduce_from(col.reduce_from(y, ep_g), tp_g)
    out = y * gate[rows][:, None]
    return out.to(x.dtype).reshape(b, l, d), aux
