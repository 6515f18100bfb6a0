"""Transformer forward pass in PyTorch: the port of the forward half of
``client_tpu/models/transformer.py``.

Decoder-only (causal) or encoder (bidirectional) transformer with the
reference's llama-family knobs (grouped-query attention, rotary position
embeddings, swiglu FFN). Parameters are a plain dict of tensors with the
reference's names and layouts, and the einsums use the reference's index
letters, so the reference's weights and inputs pass through unchanged
(``params_from_jax``):

- ``embed [V, d]``, ``pos_embed [max_seq, d]`` (absent under rope),
  ``final_norm [d]``;
- ``layers``, each stacked on a leading ``n_layers`` axis: ``ln1``,
  ``ln2 [d]``, ``wqkv [d, 3, h, dh]`` (or ``wq [d, h, dh]`` plus
  ``wkv [d, 2, hkv, dh]`` under GQA), ``wo [h, dh, d]``, ``w1 [d, f]``,
  ``w2 [f, d]``, and ``w3 [d, f]`` for swiglu.

Activations run in ``cfg.dtype`` with f32 normalisation and softmax, as
in the reference. Attention goes through the flash kernel
(``attn_impl="flash"``) or the plain reference (``"ref"``). The
reference's ``"auto"`` routing rests on a crossover measured on a TPU and
is not carried over.

Of the decode half, both KV layouts the generation engine runs are here.
The slot layout (``init_decode_state``, ``decode_step`` batched over the
slots, its greedy loop ``decode_loop``, the monolithic ``prefill`` and the
resumable ``prefill_chunk``)
attends each slot's static ``[max_seq]`` rows with the reference's einsum
attention, whatever ``attn_impl`` says, as the reference does. The paged
block-table layout (``paged_decode_steps``, ``paged_prefill_chunk``, with
``emit_into_ring`` and the pool read/write helpers) decodes through the
paged decode kernel (``ops.paged_attention``) under ``attn_impl="flash"``
and through the gathered einsum under ``"ref"``; its prefill chunk always
takes the einsum. The speculative verify passes (``verify_steps``,
``paged_verify_steps``) score T tokens per slot in one forward with the
einsum attention on both layouts, as the reference's do, and the
dedicated prefill lane's batched chunks (``prefill_chunk_batch``,
``paged_prefill_chunk_batch``) ingest B prompts' chunks in one forward
the same way. The reference's per-layer scan body ``_decode_layer`` has
no copy here: ``decode_step`` computes it layer by layer, and
``decode_loop`` steps it.

int8 KV (``kv_quant``): every KV tensor gains an f32 scale table over
(position, KV head); each written row is quantised on write
(``_kv_quantize``: the scale is max(|x| over Dh, 1e-8) / 127, the values
rounded half to even and clipped to +-127) and every read dequantises to
``cfg.dtype`` (``_kv_dequantize``) before the einsum attention, whose
products accumulate in f32. The paged decode kernel reads only
unquantised pools: under ``kv_quant`` the paged decode step takes the
dequantising einsum, as the reference's does.

Switch-MoE (``n_experts`` > 0: ``router``, ``we1``, ``we2`` in place of
``w1``/``w2``) runs in the batch forward only; every decode, prefill and
verify entry raises for it, as the reference's do. ``remat`` recomputes
each layer in the backward (``torch.utils.checkpoint``).

Training (``loss_fn``, ``value_and_grad``, ``make_train_step`` with a
functional AdamW matching ``optax.adamw``'s defaults) runs on one device
or inside a mesh (``parallel/mesh.py``). Under a mesh each rank holds its
dp×sp block of the tokens and its tp (heads, ff, vocab) and ep (experts)
block of the parameters (``shard_params``, by ``param_logical_axes`` and
the mesh's rules), and the forward does by hand what GSPMD inserts for the
reference: the wo and w2 partials are summed over tp, the embedding is
looked up vocab-parallel, the positions are offset by the rank's sp block,
K/V are all-gathered over sp under ``"ref"`` (or go round the ring under
``"ring"``), the MoE layer is ``ops.moe.moe_ffn_sharded``, and the
log-softmax is vocab-parallel. The flash kernel has no backward (nor has
the reference's Pallas kernel), so a train step refuses ``"flash"``.

The decode entries the engine's mesh runs (``init_decode_state``,
``init_paged_state``, ``decode_step``, ``prefill``, ``prefill_chunk``,
``paged_decode_steps``, ``paged_prefill_chunk``) take ``mesh`` too: the
state is the rank's block (slots over dp, KV heads over tp), the heads,
ffn and vocab split over tp with the wo and w2 partials summed over tp,
the embedding vocab-parallel and the logits gathered over tp before
selection. The reference lets GSPMD propagate all this from its state's
sharding constraints; here it is written out, as for ``forward``.

The analytical FLOP and byte model (``layer_flops_per_token`` through
``token_bytes``) is the reference's closed forms, plain integer
arithmetic on the config: the generation engine's goodput plane
(``server/goodput.py``) attributes every dispatch with them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from client_tpu_torch.device import resolve_device
from client_tpu_torch.ops.attention import mha_attention
from client_tpu_torch.ops.flash_attention import flash_attention
from client_tpu_torch.ops.moe import moe_ffn, moe_ffn_sharded
from client_tpu_torch.ops.paged_attention import paged_decode_attention
from client_tpu_torch.ops.ring_attention import ring_attention
from client_tpu_torch.parallel import collectives as col
from client_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    logical_to_physical,
    shard_tree,
)

# "ring" takes ring attention under a mesh and the plain attention without
# one, as in the reference; the reference's "auto" rests on a crossover
# measured on a TPU and is not carried over
ATTN_IMPLS = ("flash", "ref", "ring")
DENSE_ONLY = "KV-cache decode supports dense FFN only"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    max_seq: int = 2048
    causal: bool = True
    dtype: torch.dtype = torch.bfloat16
    # n_kv_heads < n_heads = grouped-query attention; rope = rotary
    # position embeddings instead of learned absolute; ffn = "swiglu"
    # gates the FFN (w3 added). All three compose.
    n_kv_heads: int = 0           # 0 => = n_heads (plain MHA)
    rope: bool = False
    rope_theta: float = 10000.0
    ffn: str = "gelu"             # gelu | swiglu
    attn_impl: str = "flash"      # flash | ref | ring
    kv_quant: bool = False        # int8 KV rows + f32 scales per (pos, head)
    n_experts: int = 0            # 0 => dense FFN; > 0: Switch-MoE
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    remat: bool = False           # recompute each layer in the backward

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def gqa(self) -> bool:
        return self.kv_heads != self.n_heads

    def __post_init__(self):
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} must be a multiple of "
                f"n_kv_heads {self.n_kv_heads}")
        if self.ffn not in ("gelu", "swiglu"):
            raise ValueError(f"unknown ffn '{self.ffn}'")
        if self.ffn == "swiglu" and self.n_experts > 0:
            raise ValueError("swiglu is the dense-FFN gate; Switch-MoE "
                             "experts keep their own gelu FFN")
        if self.rope and self.head_dim % 2:
            raise ValueError("rope needs an even head_dim")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl '{self.attn_impl}' "
                             f"(expected one of {ATTN_IMPLS})")


# ---------------------------------------------------------------- params

def _layer_shapes(cfg: TransformerConfig) -> dict:
    """Per-layer weights: name -> (shape, logical axis names)."""
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    shapes = {
        "ln1": ((d,), ("model",)),
        "wo": ((h, dh, d), ("heads", "head_dim", "model")),
        "ln2": ((d,), ("model",)),
    }
    if cfg.gqa:
        shapes["wq"] = ((d, h, dh), ("model", "heads", "head_dim"))
        shapes["wkv"] = ((d, 2, cfg.kv_heads, dh),
                         ("model", None, "heads", "head_dim"))
    else:
        shapes["wqkv"] = ((d, 3, h, dh),
                          ("model", None, "heads", "head_dim"))
    if cfg.ffn == "swiglu" and not cfg.moe:
        shapes["w3"] = ((d, f), ("model", "ff"))
    if cfg.moe:
        e = cfg.n_experts
        shapes.update({
            "router": ((d, e), ("model", None)),
            "we1": ((e, d, f), ("expert", "model", "ff")),
            "we2": ((e, f, d), ("expert", "ff", "model")),
        })
    else:
        shapes.update({
            "w1": ((d, f), ("model", "ff")),
            "w2": ((f, d), ("ff", "model")),
        })
    return shapes


def param_logical_axes(cfg: TransformerConfig) -> dict:
    """Logical axis names of every parameter, in ``init_params``' tree."""
    layers = {k: ("layers",) + ax for k, (_, ax) in _layer_shapes(cfg).items()}
    out = {
        "embed": ("vocab", "model"),
        "layers": layers,
        "final_norm": ("model",),
    }
    if not cfg.rope:
        out["pos_embed"] = ("seq_kv", "model")
    return out


def param_specs(cfg: TransformerConfig, rules: dict = None) -> dict:
    """The mesh axis each parameter dim is split over (None: whole), in
    ``init_params``' tree: the reference's ``PartitionSpec`` entries."""
    return _tree_map(lambda ax: logical_to_physical(ax, rules),
                     param_logical_axes(cfg))


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure, passed alongside)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


def _tree_unflatten(tree, leaves):
    """Leaves (in ``_tree_leaves`` order) back into ``tree``'s structure."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def init_params(generator: torch.Generator, cfg: TransformerConfig) -> dict:
    """Random weights with the reference's shapes and fan-in scaling,
    drawn from ``generator`` on the generator's device. (The draws differ
    from ``jax.random``'s; tests hand both packages one set of weights
    through ``params_from_jax``.)"""
    device = generator.device

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in ** -0.5).to(cfg.dtype)

    layers = {}
    for name, (shape, _) in _layer_shapes(cfg).items():
        full = (cfg.n_layers,) + shape
        if name.startswith("ln"):
            layers[name] = torch.ones(full, dtype=cfg.dtype, device=device)
        elif name == "router":
            layers[name] = dense(full, shape[0])
        else:
            fan_in = shape[0] if name != "wo" else shape[0] * shape[1]
            if name in ("we1", "we2"):
                fan_in = shape[1]
            layers[name] = dense(full, fan_in)
    out = {
        "embed": dense((cfg.vocab_size, cfg.d_model), cfg.d_model),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                 device=device),
    }
    if not cfg.rope:  # rope configs carry no learned position table
        out["pos_embed"] = dense((cfg.max_seq, cfg.d_model), cfg.d_model)
    return out


def shard_params(cfg: TransformerConfig, params: dict, mesh) -> dict:
    """This rank's block of every parameter of ``params`` (the whole
    tree, as ``init_params`` makes it): each dim that ``param_specs``
    splits over a mesh axis of more than one rank is cut to the rank's
    contiguous block along it (``parallel.mesh.shard_tree``). Raises
    ``ValueError`` when an axis does not divide its dim."""
    return shard_tree(params, param_specs(cfg), mesh)


def unshard_params(cfg: TransformerConfig, shard: dict, mesh) -> dict:
    """The whole parameters from every rank's block (``shard_params``'
    inverse): all-gathers each split dim over its axis, on every rank.
    No gradient."""
    specs = param_specs(cfg)

    def gather(x, spec):
        for dim, axis in enumerate(spec):
            if axis and axis_size(mesh, axis) > 1:
                x = col.all_gather(x.detach(), axis_group(mesh, axis), dim)
        return x

    return _tree_map(gather, shard, specs)


def params_from_jax(tree: dict, device, dtype: torch.dtype) -> dict:
    """The reference's parameter pytree, as numpy arrays, to the port's
    dict of tensors with the same names and layouts. Arrays of any float
    dtype numpy can widen to f32 (bfloat16 included) are accepted; every
    tensor lands on ``device`` in ``dtype``."""
    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        arr = np.asarray(x, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)

    return convert(tree)


# ---------------------------------------------------------------- forward

def _rmsnorm(x, w):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + 1e-6)).to(x.dtype) * w


def _dense_ffn(x, lp, ffn: str = "gelu", tp=None):
    """Residual dense FFN block. ``ffn`` picks gelu (the tanh form, as
    ``jax.nn.gelu`` defaults to) or the swiglu gate (w3). ``tp``: the
    tensor-parallel group under a mesh, over which w1/w3 are split by
    columns and w2 by rows (the partial output is summed over it)."""
    y = col.copy_to(_rmsnorm(x, lp["ln2"]), tp)
    if ffn == "swiglu":
        hmid = (F.silu(torch.einsum("...d,df->...f", y, lp["w1"]))
                * torch.einsum("...d,df->...f", y, lp["w3"]))
    else:
        hmid = F.gelu(torch.einsum("...d,df->...f", y, lp["w1"]),
                      approximate="tanh")
    return x + col.reduce_from(torch.einsum("...f,fd->...d", hmid, lp["w2"]),
                               tp)


def _rope_angles(pos, head_dim: int, theta: float):
    """(cos, sin) tables of shape pos.shape + (head_dim // 2,)."""
    half = head_dim // 2
    pos = torch.as_tensor(pos)
    exponent = -torch.arange(half, dtype=torch.float32,
                             device=pos.device) / half
    # torch.full, not torch.tensor: a fill on the device, where a host
    # scalar would be copied in (and the decode loop would wait on it)
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=pos.device), exponent)
    angles = pos.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope_apply(x, cos, sin):
    """Rotate [..., Dh] by per-position angles (cos/sin broadcast to x's
    leading axes); applied BEFORE GQA head expansion, like the llama
    family."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _qkv_proj(cfg: TransformerConfig, y, lp, prefix: str):
    """Project to (q [..., H, Dh], k, v [..., Hkv, Dh]); ``prefix`` is
    the einsum input spec for y's leading axes ('bl' / 'l' / 'b')."""
    if cfg.gqa:
        q = torch.einsum(f"{prefix}d,dhk->{prefix}hk", y, lp["wq"])
        kv = torch.einsum(f"{prefix}d,dchk->c{prefix}hk", y, lp["wkv"])
        return q, kv[0], kv[1]
    qkv = torch.einsum(f"{prefix}d,dchk->c{prefix}hk", y, lp["wqkv"])
    return qkv[0], qkv[1], qkv[2]


def _expand_kv(cfg: TransformerConfig, x):
    """[..., Hkv, Dh] -> [..., H, Dh] by repeating each KV head over its
    query group (identity for plain MHA)."""
    if not cfg.gqa:
        return x
    return torch.repeat_interleave(x, cfg.n_heads // cfg.kv_heads, dim=-2)


def _attention(cfg: TransformerConfig, q, k, v, mesh=None):
    """q [B, L, H, Dh] against k/v [B, L, Hkv, Dh] (this rank's sequence
    block under a mesh), the KV heads expanded here. Under a mesh
    ``"ring"`` is ring attention over the sp group; ``"ref"`` with sp > 1
    all-gathers K and V over sp (what GSPMD does to the reference's
    einsum) and masks causally from the rank's offset."""
    sp = axis_size(mesh, "sp")
    if cfg.attn_impl == "ring" and mesh is not None:
        return ring_attention(q, _expand_kv(cfg, k), _expand_kv(cfg, v),
                              mesh, causal=cfg.causal)
    if cfg.attn_impl == "flash":
        if sp > 1:
            raise ValueError("attn_impl='flash' attends one sequence block; "
                             "under sp > 1 use 'ref' or 'ring'")
        return flash_attention(q, _expand_kv(cfg, k), _expand_kv(cfg, v),
                               causal=cfg.causal)
    q_offset = 0
    if sp > 1:
        group = axis_group(mesh, "sp")
        k, v = col.all_gather(k, group, 1), col.all_gather(v, group, 1)
        q_offset = axis_index(mesh, "sp") * q.shape[1]
    return mha_attention(q, _expand_kv(cfg, k), _expand_kv(cfg, v),
                         causal=cfg.causal, q_offset=q_offset)


def _layer(cfg: TransformerConfig, x, lp, mesh=None) -> tuple:
    """One transformer block, x: [B, L, d] -> (x, aux loss f32; zero for a
    dense FFN). Under a mesh x is this rank's dp×sp block and ``lp`` its
    tp/ep block of the layer."""
    b, l, d = x.shape
    tp = axis_group(mesh, "tp")
    y = col.copy_to(_rmsnorm(x, lp["ln1"]), tp)
    q, k, v = _qkv_proj(cfg, y, lp, "bl")              # kv: [B, L, Hkv, Dh]
    if cfg.rope:
        pos0 = axis_index(mesh, "sp") * l
        cos, sin = _rope_angles(torch.arange(pos0, pos0 + l, device=x.device),
                                cfg.head_dim, cfg.rope_theta)  # [L, half]
        q = _rope_apply(q, cos[None, :, None], sin[None, :, None])
        k = _rope_apply(k, cos[None, :, None], sin[None, :, None])
    attn = _attention(cfg, q, k, v, mesh)              # [B, L, H, Dh]
    x = x + col.reduce_from(torch.einsum("blhk,hkd->bld", attn, lp["wo"]),
                            tp)
    if not cfg.moe:
        return (_dense_ffn(x, lp, ffn=cfg.ffn, tp=tp),
                torch.zeros((), dtype=torch.float32, device=x.device))
    y = _rmsnorm(x, lp["ln2"])
    if mesh is None:
        out, aux = moe_ffn(y.reshape(b * l, d), lp["router"], lp["we1"],
                           lp["we2"], cfg.capacity_factor)
        return x + out.reshape(b, l, d), aux
    out, aux = moe_ffn_sharded(y, lp["router"], lp["we1"], lp["we2"],
                               cfg.capacity_factor, mesh)
    return x + out, aux


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked per-layer weights."""
    return {name: w[i] for name, w in params["layers"].items()}


def _embed_rows(params: dict, tokens, mesh=None):
    """The embedding rows of ``tokens`` (any shape): under a mesh the
    lookup is vocab-parallel over tp (each rank's rows for its own slice
    of the vocab, zero for the rest, summed over tp)."""
    tokens = tokens.long()
    tp = axis_group(mesh, "tp")
    if tp is None:
        return params["embed"][tokens]
    v_loc = params["embed"].shape[0]
    local = tokens - axis_index(mesh, "tp") * v_loc
    inside = (local >= 0) & (local < v_loc)
    rows = params["embed"][local.clamp(0, v_loc - 1)]
    return col.reduce_from(torch.where(inside[..., None], rows, 0.0), tp)


def _vocab_logits(spec: str, x, params: dict, mesh=None):
    """The f32 logits ``einsum(spec, x, embed)``: under a mesh each tp
    rank projects onto its slice of the vocab, and the slices are
    gathered over tp, so every rank of a tp group holds the whole
    vocabulary before selection."""
    logits = torch.einsum(spec, x, params["embed"]).float()
    return col.all_gather(logits, axis_group(mesh, "tp"), logits.dim() - 1)


def _tp_local(cfg: TransformerConfig, mesh) -> TransformerConfig:
    """The config as one tp rank's shard sees it: ``n_heads`` and the KV
    heads divided by tp (the GQA ratio is kept). Raises ``ValueError``
    when tp does not divide them."""
    tp = axis_size(mesh, "tp")
    if tp == 1:
        return cfg
    if cfg.n_heads % tp or cfg.kv_heads % tp:
        raise ValueError(f"n_heads {cfg.n_heads} and KV heads "
                         f"{cfg.kv_heads} must divide by tp={tp}")
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // tp,
        n_kv_heads=cfg.n_kv_heads // tp if cfg.n_kv_heads else 0)


def embed_tokens(cfg: TransformerConfig, params: dict, tokens, mesh=None):
    """tokens [B, L] -> input activations [B, L, d] in cfg.dtype. Under a
    mesh tokens are the rank's dp×sp block: the lookup is vocab-parallel
    over tp (``_embed_rows``) and the positions start at the block's
    offset."""
    x = _embed_rows(params, tokens, mesh)
    if not cfg.rope:
        l = tokens.shape[1]
        pos0 = axis_index(mesh, "sp") * l
        x = x + params["pos_embed"][pos0:pos0 + l][None]
    return x.to(cfg.dtype)


def forward(cfg: TransformerConfig, params: dict, tokens, mesh=None) -> tuple:
    """tokens: [B, L] int -> (logits [B, L, vocab] f32, aux loss: the sum
    of the layers' MoE load-balancing terms, zero for a dense FFN).

    Under ``mesh`` (``parallel.mesh.make_mesh``), on every rank: params
    are the rank's block (``shard_params``), tokens its dp×sp block
    [B/dp, L/sp], and the logits come back as the rank's block
    [B/dp, L/sp, vocab/tp]; the aux loss is the global one. With
    ``cfg.remat`` each layer is recomputed in the backward."""
    x = embed_tokens(cfg, params, tokens, mesh)
    auxes = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if cfg.remat:
            x, aux = checkpoint(_layer, cfg, x, lp, mesh,
                                use_reentrant=False)
        else:
            x, aux = _layer(cfg, x, lp, mesh)
        auxes.append(aux)
    x = _rmsnorm(x, params["final_norm"])
    x = col.copy_to(x, axis_group(mesh, "tp"))
    logits = torch.einsum("bld,vd->blv", x, params["embed"]).float()
    return logits, torch.stack(auxes).sum()


# ---------------------------------------------------------------- token ring

def emit_into_ring(ring, counts, entry, toks, n_emitted) -> tuple:
    """Write one dispatch's emitted tokens into ring entry ``entry`` of the
    device-resident token ring the generation engine fetches from.

    ring [E, S, W] int32, counts [E, S] int32, toks [S, w] with w <= W
    (zero-padded to W), n_emitted [S]. ``entry`` is a host int or an
    integer index tensor [1] on the ring's device (the engine's CUDA
    graphs take the entry as data, not as a baked-in constant). The
    reference returns new arrays; here the ring is updated IN PLACE and
    returned. A fetch enqueued on the same stream before a later write
    still reads the earlier values: stream order is what keeps the two
    apart (the reference had array immutability for that)."""
    w = toks.shape[-1]
    if isinstance(entry, torch.Tensor):
        # device ops only (a host scalar written through a tensor index
        # is a host copy, which a graph capture refuses)
        idx = entry.long().reshape(1)
        row = torch.nn.functional.pad(toks.to(ring.dtype),
                                      (0, ring.shape[-1] - w))
        ring.index_copy_(0, idx, row[None])
        counts.index_copy_(0, idx, n_emitted.to(counts.dtype)[None])
        return ring, counts
    ring[entry, :, :w] = toks.to(ring.dtype)
    if w < ring.shape[-1]:
        ring[entry, :, w:] = 0
    counts[entry] = n_emitted.to(counts.dtype)
    return ring, counts


def _masked_attention(cfg: TransformerConfig, q, k_read, v_read, qpos):
    """The reference's einsum attention of the decode paths: query rows
    q [N, H, Dh] at positions qpos [N] over K/V rows, either one set per
    query row ([N, K, Hkv, Dh]) or one set all rows share ([K, Hkv, Dh]);
    or, for the verify paths, T query rows per slot, q [N, T, H, Dh] at
    qpos [N, T] over each slot's rows [N, K, Hkv, Dh]. Key j is visible to
    a row at position p when j <= p. Grouped queries fold into the einsum
    (no repeated K/V); logits in f32 scaled by Dh^-0.5, softmax in f32,
    probabilities rounded to v's dtype before the PV product."""
    lead = q.shape[:-2]
    r = cfg.n_heads // cfg.kv_heads
    qg = q.reshape(*lead, cfg.kv_heads, r, cfg.head_dim).float()
    if q.dim() == 4:
        qk, pv = "btgrd,bsgd->btgrs", "btgrs,bsgd->btgrd"
    elif k_read.dim() == 3:
        qk, pv = "tgrd,sgd->tgrs", "tgrs,sgd->tgrd"
    else:
        qk, pv = "bgrd,bsgd->bgrs", "bgrs,bsgd->bgrd"
    logits = torch.einsum(qk, qg, k_read.float()) * cfg.head_dim ** -0.5
    keys = torch.arange(k_read.shape[-3], device=q.device)
    mask = keys <= qpos.long()[..., None]                  # [..., K]
    logits = logits.masked_fill(~mask[..., None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v_read.dtype)
    attn = torch.einsum(pv, probs, v_read)
    return attn.reshape(*lead, cfg.n_heads, cfg.head_dim)




# ---------------------------------------------------------------- int8 KV

def _kv_quantize(x):
    """[..., Dh] -> (int8 values, f32 scale [...] over the last dim): the
    reference's ``_kv_quantize``. The scale is max(|x|, 1e-8) / 127 in
    f32; x / scale is computed in f32, rounded half to even
    (``torch.round``, as ``jnp.round``) and clipped to +-127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _kv_dequantize(q, scale, dtype):
    """The reference's ``_kv_dequantize``: values times scale in f32,
    rounded to ``dtype`` (``cfg.dtype``, so attention sees the same
    rounding step the reference's einsum operands carry)."""
    return (q.float() * scale[..., None]).to(dtype)


def kv_names(cfg: TransformerConfig) -> tuple:
    """The KV tensors of a state or pool: ``k``, ``v`` and, under
    ``kv_quant``, their f32 scale tables ``k_scale``, ``v_scale``."""
    if cfg.kv_quant:
        return ("k", "v", "k_scale", "v_scale")
    return ("k", "v")


def _kv_write(cfg: TransformerConfig, kv: dict, index: tuple, k, v) -> None:
    """Write fed K/V rows into one layer's KV tensors at ``index`` (a
    tuple of index tensors over their leading axes), IN PLACE
    (``index_put_``): quantised with their scales under ``kv_quant``,
    rounded to the tensors' dtype otherwise."""
    if cfg.kv_quant:
        for name, x in (("k", k), ("v", v)):
            q, scale = _kv_quantize(x)
            kv[name].index_put_(index, q)
            kv[f"{name}_scale"].index_put_(index, scale)
        return
    kv["k"].index_put_(index, k.to(kv["k"].dtype))
    kv["v"].index_put_(index, v.to(kv["v"].dtype))


def _kv_read(cfg: TransformerConfig, kv: dict) -> tuple:
    """(K, V) of one layer's KV tensors as attention reads them:
    dequantised to ``cfg.dtype`` under ``kv_quant``."""
    if cfg.kv_quant:
        return (_kv_dequantize(kv["k"], kv["k_scale"], cfg.dtype),
                _kv_dequantize(kv["v"], kv["v_scale"], cfg.dtype))
    return kv["k"], kv["v"]


# ---------------------------------------------------------------- slot KV
#
# The slot layout: every slot owns a static [layers, max_seq, Hkv, Dh] row
# of K and V, position is data, and attention masks the unwritten tail. The
# engine's state holds all S slots in the axis order of the reference's
# vmapped state ([S, layers, max_seq, Hkv, Dh]); a freed slot is recycled
# by resetting its position, and its stale rows are overwritten before
# they are attended.

def init_decode_state(cfg: TransformerConfig, n_slots: int,
                      device=None, mesh=None) -> dict:
    """Zeroed slot-layout state of ``n_slots`` slots: ``k``/``v``
    ``[S, layers, max_seq, Hkv, Dh]`` in ``cfg.dtype`` (only the KV heads
    under GQA), int8 under ``kv_quant`` with f32 ``k_scale``/``v_scale``
    ``[S, layers, max_seq, Hkv]`` beside them, and ``pos [S]`` int32. On
    the card unless ``device`` says otherwise; without CUDA that raises.
    Under ``mesh`` the state is this rank's block: the slots split over dp
    and the KV heads over tp, ``[S/dp, layers, max_seq, Hkv/tp, Dh]``
    (the reference's ``P("dp", None, None, "tp", None)``)."""
    dev = resolve_device(device)
    n_slots //= axis_size(mesh, "dp")
    shape = (n_slots, cfg.n_layers, cfg.max_seq,
             _tp_local(cfg, mesh).kv_heads, cfg.head_dim)
    kv_dtype = torch.int8 if cfg.kv_quant else cfg.dtype
    state = {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
             "v": torch.zeros(shape, dtype=kv_dtype, device=dev)}
    if cfg.kv_quant:
        for name in ("k_scale", "v_scale"):
            state[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=dev)
    state["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
    return state


def decode_step(cfg: TransformerConfig, params: dict, tokens,
                state: dict, rows=None, mesh=None) -> tuple:
    """One autoregressive step of every slot of a slot-layout state: the
    reference's ``decode_step`` under ``jax.vmap``, as one computation
    over ``[S, ...]``. tokens [S] int32 are fed at positions
    ``state["pos"]`` [S]. Per layer each slot's K/V row is written at its
    own position IN PLACE (``index_put_``; quantised under ``kv_quant``),
    then every slot attends its rows [0, pos] (dequantised). Returns
    (logits [S, vocab] f32, the state with ``pos + 1``; the KV tensors
    are the same tensors).

    ``rows`` [N] (int64 slot indices) steps only those slots: tokens [N],
    logits [N, vocab], only their rows written and only their positions
    advanced; every other slot's K/V and position stay bit-unchanged (the
    speculation draft steps the slots of a verify round this way).

    A slot decoding past its budget inside its last chunk reaches
    ``pos >= max_seq``: the write index and the ``pos_embed`` gather clamp
    to ``max_seq - 1``, as the reference's ``dynamic_update_slice`` and
    gather do (an out-of-range ``index_put_`` would be a device-side
    assert on the card).

    Under ``mesh`` (a dp×tp mesh): tokens and the state are this rank's
    block (``init_decode_state(..., mesh=)``), params its tp block
    (``shard_params``); the heads, the ffn and the vocab split over tp
    (the wo and w2 partials summed over tp, the embedding vocab-parallel)
    and the logits are gathered over tp, [S/dp, vocab]."""
    if cfg.moe:
        raise NotImplementedError(DENSE_ONLY)
    tp = axis_group(mesh, "tp")
    lcfg = _tp_local(cfg, mesh)
    pos_all = state["pos"]
    pos = pos_all if rows is None else pos_all[rows]
    wpos = pos.long().clamp(0, cfg.max_seq - 1)
    idx = (torch.arange(tokens.shape[0], device=tokens.device)
           if rows is None else rows)
    x = _embed_rows(params, tokens, mesh)
    if not cfg.rope:
        x = x + params["pos_embed"][wpos]
    x = x.to(cfg.dtype)                                           # [S, d]
    if cfg.rope:
        cos, sin = _rope_angles(pos, cfg.head_dim, cfg.rope_theta)
        cos, sin = cos[:, None], sin[:, None]
    names = kv_names(cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        kv = {name: state[name][:, i] for name in names}  # [S, max_seq, ...]
        y = _rmsnorm(x, lp["ln1"])
        q, k, v = _qkv_proj(lcfg, y, lp, "b")  # q [S,H,Dh], kv [S,Hkv,Dh]
        if cfg.rope:
            q, k = _rope_apply(q, cos, sin), _rope_apply(k, cos, sin)
        _kv_write(cfg, kv, (idx, wpos), k, v)
        if rows is not None:
            kv = {name: arr[rows] for name, arr in kv.items()}
        k_read, v_read = _kv_read(cfg, kv)
        attn = _masked_attention(lcfg, q, k_read, v_read, pos)
        x = x + col.reduce_from(torch.einsum("bhk,hkd->bd", attn, lp["wo"]),
                                tp)
        x = _dense_ffn(x, lp, ffn=cfg.ffn, tp=tp)
    x = _rmsnorm(x, params["final_norm"])
    logits = _vocab_logits("bd,vd->bv", x, params, mesh)
    new_pos = pos + 1 if rows is None else pos_all.index_put((rows,),
                                                             pos + 1)
    return logits, {**state, "pos": new_pos}


def decode_loop(cfg: TransformerConfig, params: dict, tokens, state: dict,
                k: int) -> tuple:
    """``k`` greedy ``decode_step``s of every slot: the reference's
    ``decode_loop`` (its ``lax.scan``) as an eager loop that keeps the
    tokens on the device. tokens [S] int32 is the next token to feed (and
    the first one emitted). Returns (toks [S, k] int32, the tokens fed;
    next [S] int32, the greedy successor; the state, whose K/V tensors
    were written in place)."""
    toks = []
    for _ in range(k):
        toks.append(tokens)
        logits, state = decode_step(cfg, params, tokens, state)
        tokens = logits.argmax(dim=-1).to(torch.int32)
    return torch.stack(toks, dim=1), tokens, state


def _slot_slab(cfg: TransformerConfig, params: dict, tokens, cache: dict,
               pos, rows, mesh=None) -> torch.Tensor:
    """The forward the slot layout's slab passes share (the reference's
    ``verify_steps`` and ``prefill_chunk_batch``, both ``jax.vmap`` over
    rows): tokens [N, T] consumed at positions pos..pos+T-1 (pos [N]
    int64) of the cache rows ``rows`` [N] (int64 row indices; None: all,
    N = S), as T ``decode_step`` calls would consume them. Per layer each
    row's T K/V rows are written IN PLACE as one slab, its start clamped
    so the slab fits in max_seq (as ``dynamic_update_slice`` clamps), and
    each query row attends its cache row under its own causal position.
    Returns the final-normed activations [N, T, d]. Under ``mesh`` as
    ``decode_step``: the cache holds this rank's KV heads, and the heads,
    ffn and vocab split over tp (the rows are this rank's own)."""
    tp = axis_group(mesh, "tp")
    lcfg = _tp_local(cfg, mesh)
    n, t_len = tokens.shape
    idx = (torch.arange(n, device=tokens.device) if rows is None else rows)
    steps = torch.arange(t_len, device=tokens.device)
    start = pos.clamp(0, cfg.max_seq - t_len)
    wpos = start[:, None] + steps                                # [N, T]
    qpos = pos[:, None] + steps
    x = _embed_rows(params, tokens, mesh)
    if not cfg.rope:
        x = x + params["pos_embed"][wpos]
    x = x.to(cfg.dtype)                                          # [N, T, d]
    if cfg.rope:
        cos, sin = _rope_angles(qpos, cfg.head_dim, cfg.rope_theta)
        cos, sin = cos[:, :, None], sin[:, :, None]
    slot_idx = idx[:, None].expand(n, t_len)
    names = kv_names(cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        kv = {name: cache[name][:, i] for name in names}
        y = _rmsnorm(x, lp["ln1"])
        q, k, v = _qkv_proj(lcfg, y, lp, "bt")  # q [N,T,H,Dh], kv [N,T,Hkv,Dh]
        if cfg.rope:
            q, k = _rope_apply(q, cos, sin), _rope_apply(k, cos, sin)
        _kv_write(cfg, kv, (slot_idx, wpos), k, v)
        if rows is not None:
            kv = {name: arr[rows] for name, arr in kv.items()}
        k_read, v_read = _kv_read(cfg, kv)
        attn = _masked_attention(lcfg, q, k_read, v_read, qpos)
        x = x + col.reduce_from(torch.einsum("bthk,hkd->btd", attn, lp["wo"]),
                                tp)
        x = _dense_ffn(x, lp, ffn=cfg.ffn, tp=tp)
    return _rmsnorm(x, params["final_norm"])


def verify_steps(cfg: TransformerConfig, params: dict, tokens, state: dict,
                 rows=None, mesh=None) -> tuple:
    """Score T tokens per slot against a slot-layout state in ONE forward:
    the speculative verify pass, the reference's ``verify_steps`` under
    ``jax.vmap``. tokens [S, T] int32 are consumed at positions
    pos..pos+T-1 of each slot as T ``decode_step`` calls would consume
    them (``_slot_slab``; quantised writes and dequantised reads under
    ``kv_quant``). ``rows`` [N] (int64 slot indices) verifies only those
    slots (tokens [N, T]); every other slot's K/V and position stay
    bit-unchanged. Returns (logits [N, T, vocab] f32, logits[:, i] the
    next-token distribution after tokens[:, :i+1]; the state with the
    verified slots' pos advanced by T). Rollback is the caller's: position
    is data, so rewinding ``pos`` un-attends the rejected rows, and the
    next write overwrites them. Plain torch ops, as the reference's
    einsums are. Under ``mesh`` the state and ``rows`` are this rank's dp
    block, the heads, ffn and vocab split over tp as in ``decode_step``,
    and the logits are gathered over tp."""
    if cfg.moe:
        raise NotImplementedError(DENSE_ONLY)
    t_len = tokens.shape[1]
    pos_all = state["pos"]
    pos = (pos_all if rows is None else pos_all[rows]).long()
    x = _slot_slab(cfg, params, tokens, state, pos, rows, mesh)
    logits = _vocab_logits("btd,vd->btv", x, params, mesh)
    new_pos = pos_all + t_len if rows is None else pos_all.index_put(
        (rows,), pos_all[rows] + t_len)
    return logits, {**state, "pos": new_pos}


def prefill(cfg: TransformerConfig, params: dict, tokens,
            length: int = None, pad_to_max: bool = True, mesh=None) -> tuple:
    """A whole (bucket-padded) prompt tokens [L] in one causal forward
    through ``ops.attention.mha_attention``: returns (state, logits) with
    ``state`` = {``k``, ``v`` [layers, L or max_seq, Hkv, Dh] (int8 with
    ``k_scale``/``v_scale`` [layers, L or max_seq, Hkv] under
    ``kv_quant``), ``pos``} and the f32 logits [vocab] at ``length - 1``
    (a host int), the last real token. Under ``kv_quant`` each layer's
    K/V are quantised and dequantised BEFORE the prompt's own attention,
    so prefill sees the rows decode will read, as in the reference.
    Rows at and past ``length`` hold padding K/V that decode overwrites
    before attending. ``pad_to_max=False`` returns only the bucket's L
    rows (the engine writes them into a slot's rows itself). Under
    ``mesh`` the heads, ffn and vocab split over tp as in ``decode_step``
    (the state holds this rank's KV heads, the logits are whole)."""
    if cfg.moe:
        raise NotImplementedError(DENSE_ONLY)
    tp = axis_group(mesh, "tp")
    lcfg = _tp_local(cfg, mesh)
    l = tokens.shape[0]
    length = l if length is None else length
    x = _embed_rows(params, tokens, mesh)
    if not cfg.rope:
        x = x + params["pos_embed"][:l]
    x = x.to(cfg.dtype)                                           # [L, d]
    if cfg.rope:
        cos, sin = _rope_angles(torch.arange(l, device=x.device),
                                cfg.head_dim, cfg.rope_theta)
        cos, sin = cos[:, None], sin[:, None]
    layers = {name: [] for name in kv_names(cfg)}
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        y = _rmsnorm(x, lp["ln1"])
        q, k, v = _qkv_proj(lcfg, y, lp, "l")  # q [L,H,Dh], kv [L,Hkv,Dh]
        if cfg.rope:
            q, k = _rope_apply(q, cos, sin), _rope_apply(k, cos, sin)
        if cfg.kv_quant:
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            for name, arr in (("k", kq), ("v", vq), ("k_scale", ks),
                              ("v_scale", vs)):
                layers[name].append(arr)
            k = _kv_dequantize(kq, ks, cfg.dtype)
            v = _kv_dequantize(vq, vs, cfg.dtype)
        else:
            layers["k"].append(k.to(cfg.dtype))     # unexpanded KV heads
            layers["v"].append(v.to(cfg.dtype))
        attn = mha_attention(q[None], _expand_kv(lcfg, k)[None],
                             _expand_kv(lcfg, v)[None], causal=True)[0]
        x = x + col.reduce_from(torch.einsum("lhk,hkd->ld", attn, lp["wo"]),
                                tp)
        x = _dense_ffn(x, lp, ffn=cfg.ffn, tp=tp)
    x = _rmsnorm(x, params["final_norm"])
    logits = _vocab_logits("d,vd->v", x[length - 1], params, mesh)
    state = {name: torch.stack(arrs) for name, arrs in layers.items()}
    if pad_to_max:
        # [layers, L, ...] -> [layers, max_seq, ...]
        state = {name: F.pad(arr, (0, 0) * (arr.dim() - 2)
                             + (0, cfg.max_seq - l))
                 for name, arr in state.items()}
    # a fill, not torch.tensor: a host scalar copied to the card would wait
    # for the card's queue
    state["pos"] = torch.full((), length, dtype=torch.int32, device=x.device)
    return state, logits


def prefill_chunk(cfg: TransformerConfig, params: dict, tokens, cache: dict,
                  pos0: int, clen: int = None, mesh=None) -> tuple:
    """Resumable chunked prefill into one slot's rows: tokens [Lc] (bucket
    padded; ``clen`` real, default Lc; both host ints) consumed at positions
    pos0..pos0+Lc-1 as Lc ``decode_step`` calls would, in one batched
    forward. ``cache`` holds the slot's KV tensors (``k``, ``v``
    [layers, max_seq, Hkv, Dh], and the scale tables under ``kv_quant``):
    rows < pos0 are the context already ingested, and the chunk's rows are
    written into it IN PLACE, quantised under ``kv_quant`` (the reference
    returns the slab for its caller to write; the engine passes the slot's
    own rows). The caller keeps pos0 + Lc <= max_seq; beyond it the slab
    start clamps, as ``dynamic_update_slice`` does. Padding rows past
    ``clen`` write K/V that the next chunk overwrites before it is
    attended. Returns (slab {name: [layers, Lc, ...]}, views of the rows
    just written, not copies; logits [vocab] f32 after tokens[clen -
    1]). Under ``mesh`` as ``decode_step``: this rank's KV heads, the
    heads, ffn and vocab over tp, the logits whole."""
    if cfg.moe:
        raise NotImplementedError(DENSE_ONLY)
    tp = axis_group(mesh, "tp")
    lcfg = _tp_local(cfg, mesh)
    lc = tokens.shape[0]
    clen = lc if clen is None else clen
    start = max(0, min(int(pos0), cache["k"].shape[1] - lc))
    pos_t = int(pos0) + torch.arange(lc, device=tokens.device)
    wrows = start + torch.arange(lc, device=tokens.device)
    x = _embed_rows(params, tokens, mesh)
    if not cfg.rope:
        x = x + params["pos_embed"][start:start + lc]
    x = x.to(cfg.dtype)                                          # [Lc, d]
    if cfg.rope:
        cos, sin = _rope_angles(pos_t, cfg.head_dim, cfg.rope_theta)
        cos, sin = cos[:, None], sin[:, None]
    names = kv_names(cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        kv = {name: cache[name][i] for name in names}   # [max_seq, ...]
        y = _rmsnorm(x, lp["ln1"])
        q, k, v = _qkv_proj(lcfg, y, lp, "l")  # q [Lc,H,Dh], kv [Lc,Hkv,Dh]
        if cfg.rope:
            q, k = _rope_apply(q, cos, sin), _rope_apply(k, cos, sin)
        _kv_write(cfg, kv, (wrows,), k, v)
        k_read, v_read = _kv_read(cfg, kv)
        attn = _masked_attention(lcfg, q, k_read, v_read, pos_t)
        x = x + col.reduce_from(torch.einsum("thk,hkd->td", attn, lp["wo"]),
                                tp)
        x = _dense_ffn(x, lp, ffn=cfg.ffn, tp=tp)
    x = _rmsnorm(x, params["final_norm"])
    logits = _vocab_logits("d,vd->v", x[clen - 1], params, mesh)
    return {name: cache[name][:, start:start + lc] for name in names}, \
        logits


def _last_rows(x, clen):
    """Each row's activations after its last real token: x [B, Lc, d] at
    column clen[b] - 1 (clipped into the chunk, as the reference's gathers
    clamp) -> [B, d]."""
    col = (clen.long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), col]


def prefill_chunk_batch(cfg: TransformerConfig, params: dict, tokens,
                        cache: dict, pos0, clen, rows=None, mesh=None):
    """The dedicated prefill lane's batched chunk (the reference's
    ``prefill_chunk_batch``, ``prefill_chunk`` under ``jax.vmap``): B
    independent bucket-padded chunks tokens [B, Lc], row b consumed at
    positions pos0[b]..pos0[b]+Lc-1 of cache row ``rows[b]`` (int64 [B];
    None: rows 0..B-1), with clen[b] real tokens. ``cache`` holds the
    lane state's KV tensors ([N, layers, max_seq, ...] each) and the
    chunks' rows are written into it IN PLACE (the reference returns the
    slabs for its caller to scatter); ``pos0``/``clen`` are [B] integer
    tensors on the cache's device. Padding rows (the caller's bucket
    padding of B) point at a scratch row nobody reads. Per-row numerics
    are ``prefill_chunk``'s einsum shapes with a leading B axis. The
    caller keeps pos0[b] + Lc <= max_seq for every real row. Returns
    logits [B, vocab] f32 after each row's tokens[clen[b] - 1]. Under
    ``mesh`` the cache and rows are this rank's dp block (its lane slots),
    split over tp as ``verify_steps``."""
    if cfg.moe:
        raise NotImplementedError(DENSE_ONLY)
    x = _slot_slab(cfg, params, tokens, cache, pos0.long(), rows, mesh)
    return _vocab_logits("bd,vd->bv", _last_rows(x, clen), params, mesh)


# ---------------------------------------------------------------- paged KV
#
# Block-table (PagedAttention) decode: the reference's paged half of
# transformer.py. KV lives only in a layer-major block pool (``k``, ``v``,
# each [layers, n_blocks, block_len, Hkv, Dh], and under ``kv_quant`` their
# scale tables [layers, n_blocks, block_len, Hkv]; server/kv_cache.py:
# init_paged_pool) and each slot addresses its sequence through a block
# table ([S, B] int32 pool block ids; entry i covers positions
# [i*block_len, (i+1)*block_len)). Block 0 is scratch: table padding and
# inactive slots write there, and nothing ever attends it.

def init_paged_state(n_slots: int, device=None, mesh=None) -> dict:
    """Per-slot device state of a paged engine: the positions only; the KV
    rows live in the pool and the block tables are host cursors. On the
    card unless ``device`` says otherwise; without CUDA that raises.
    Under ``mesh`` this rank's dp block of the slots, [S/dp]."""
    return {"pos": torch.zeros((n_slots // axis_size(mesh, "dp"),),
                               dtype=torch.int32,
                               device=resolve_device(device))}


def _paged_kv_read(cfg: TransformerConfig, pool_l: dict, tables) -> tuple:
    """Gather one layer's K/V rows for every slot through its table:
    [S, B] ids over [N, bl, ...] slabs -> [S, B*bl, Hkv, Dh] in position
    order, dequantised to ``cfg.dtype`` under ``kv_quant``."""
    s, b = tables.shape
    idx = tables.long()

    def gather(arr):
        g = arr[idx]                                   # [S, B, bl, ...]
        return g.reshape(s, b * g.shape[2], *g.shape[3:])

    return _kv_read(cfg, {name: gather(arr) for name, arr in pool_l.items()})


def _paged_write(cfg: TransformerConfig, pool_l: dict, bids, boffs, k,
                 v) -> None:
    """Write the fed tokens' K/V rows into one layer's pool slabs at
    (block id, in-block offset), IN PLACE (``index_put_``; the reference
    returns a new pool), quantised under ``kv_quant``. Inactive slots all
    write row 0 of scratch block 0; which of those duplicate writes lands
    does not matter."""
    _kv_write(cfg, pool_l, (bids, boffs), k, v)


def _paged_attention_ref(cfg: TransformerConfig, q, pool_l, tables, pos):
    """``attn_impl="ref"`` (and every step under ``kv_quant``): gather the
    table's rows, then the grouped einsum attention of the reference's
    paged path."""
    k_read, v_read = _paged_kv_read(cfg, pool_l, tables)
    return _masked_attention(cfg, q, k_read, v_read, pos)


def paged_decode_steps(cfg: TransformerConfig, params: dict, toks, pos,
                       tables, pool: dict, attention=None,
                       mesh=None) -> tuple:
    """One decode step for all S slots against the paged block pool.

    toks/pos: [S] int32 (``pos`` is the position being written); tables:
    [S, B] int32 block tables (positions past B*block_len clamp onto the
    last entry, as in the reference); pool: layer-major KV tensors, written
    IN PLACE. Per layer the fed tokens' K/V rows go into the pool through
    the tables, then attention reads them back: ``attn_impl="flash"``
    through the paged decode kernel (K2), ``"ref"`` through the gathered
    einsum. ``attention`` overrides both with a function of ``(q, k_pool,
    v_pool, tables, pos)`` (the plain K2, for example). Under ``kv_quant``
    the step always takes the dequantising einsum, as the reference's
    ``use_flash = attn_impl == "flash" and not kv_quant`` does: K2 reads
    bf16 or f32 slabs, never int8, and an ``attention`` override raises
    rather than be handed int8 slabs. Returns (logits [S, vocab] f32,
    pool).

    Under ``mesh`` (dp×tp): toks, pos and tables are this rank's dp block
    of the slots, the pool holds this rank's KV heads (Hkv/tp) of every
    block, replicated over dp (``kv_cache.init_paged_pool(..., mesh=)``),
    and params its tp block. The heads, ffn and vocab split over tp as in
    ``decode_step``, so K2 runs at [S/dp, H/tp, Dh]; each step's fed K/V
    rows are all-gathered over dp and written into every replica, which
    keeps the dp replicas equal (a block one dp rank wrote may be
    attended by a slot of another once the prefix cache shares it). The
    logits are gathered over tp, [S/dp, vocab]."""
    if cfg.moe:
        raise NotImplementedError(DENSE_ONLY)
    if cfg.kv_quant:
        if attention is not None:
            raise ValueError(
                "paged_decode_steps: an attention override reads the raw "
                "pool slabs, which are int8 under kv_quant; the int8 pool "
                "is read by the dequantising einsum (attention=None)")
    elif attention is None and cfg.attn_impl == "flash":
        attention = paged_decode_attention
    tp, dp = axis_group(mesh, "tp"), axis_group(mesh, "dp")
    lcfg = _tp_local(cfg, mesh)
    b = tables.shape[1]
    bl = pool["k"].shape[2]
    pos_l = pos.long()
    x = _embed_rows(params, toks, mesh)
    if not cfg.rope:
        # an out-of-range position clamps, as the reference's gather does
        # (a slot decoding past its budget inside its last chunk)
        x = x + params["pos_embed"][pos_l.clamp(max=cfg.max_seq - 1)]
    x = x.to(cfg.dtype)                                           # [S, d]
    bidx = torch.div(pos_l, bl, rounding_mode="floor").clamp(0, b - 1)
    bids = tables.long().gather(1, bidx[:, None])[:, 0]
    boffs = pos_l % bl
    if dp is not None:
        # every replica takes every dp rank's rows (one gather of the
        # addresses per step, one of the rows per layer)
        bids, boffs = col.all_gather(torch.stack([bids, boffs]), dp, 1)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        pool_l = {name: arr[i] for name, arr in pool.items()}
        y = _rmsnorm(x, lp["ln1"])
        q, k, v = _qkv_proj(lcfg, y, lp, "b")  # q [S,H,Dh], kv [S,Hkv,Dh]
        if cfg.rope:
            cos, sin = _rope_angles(pos, cfg.head_dim, cfg.rope_theta)
            q = _rope_apply(q, cos[:, None], sin[:, None])
            k = _rope_apply(k, cos[:, None], sin[:, None])
        if dp is None:
            _paged_write(cfg, pool_l, bids, boffs, k, v)
        else:
            rows = col.all_gather(torch.stack([k, v]), dp, 1)
            _paged_write(cfg, pool_l, bids, boffs, rows[0], rows[1])
        if attention is not None:
            attn = attention(q, pool_l["k"], pool_l["v"], tables, pos)
        else:
            attn = _paged_attention_ref(lcfg, q, pool_l, tables, pos)
        x = x + col.reduce_from(torch.einsum("bhk,hkd->bd", attn, lp["wo"]),
                                tp)
        x = _dense_ffn(x, lp, ffn=cfg.ffn, tp=tp)
    x = _rmsnorm(x, params["final_norm"])
    logits = _vocab_logits("bd,vd->bv", x, params, mesh)
    return logits, pool


def _paged_slab(cfg: TransformerConfig, params: dict, toks, pos0, tables,
                pool: dict, write=None, mesh=None,
                gather_dp: bool = True) -> torch.Tensor:
    """The forward the paged slab passes share (the reference's
    ``paged_verify_steps`` and ``paged_prefill_chunk_batch``): toks [S, T]
    consumed at positions pos0[s]..pos0[s]+T-1, their K/V rows written
    into the pool through each row's table [S, B] IN PLACE, and each
    query row attending its gathered table under its own causal position.
    ``write`` [S] bool (None: all) routes the writes of the other rows to
    scratch block 0. Positions past B*block_len clamp onto the last table
    entry and ``pos_embed`` rows past max_seq onto its last row, as the
    reference's gathers clamp. Returns the final-normed activations
    [S, T, d].

    Under ``mesh`` the heads, ffn and vocab split over tp as in
    ``decode_step`` and the pool holds this rank's KV heads. With
    ``gather_dp`` the rows are this rank's dp block and every write is
    all-gathered over dp into each replica of the pool (as
    ``paged_decode_steps`` writes); without it every dp rank runs the
    same rows, so each replica takes the same writes already."""
    tp = axis_group(mesh, "tp")
    dp = axis_group(mesh, "dp") if gather_dp else None
    lcfg = _tp_local(cfg, mesh)
    t_len = toks.shape[1]
    b = tables.shape[1]
    bl = pool["k"].shape[2]
    pos_t = pos0.long()[:, None] + torch.arange(t_len, device=toks.device)
    x = _embed_rows(params, toks, mesh)
    if not cfg.rope:
        x = x + params["pos_embed"][pos_t.clamp(max=cfg.max_seq - 1)]
    x = x.to(cfg.dtype)                                          # [S, T, d]
    if cfg.rope:
        cos, sin = _rope_angles(pos_t, cfg.head_dim, cfg.rope_theta)
        cos, sin = cos[:, :, None], sin[:, :, None]
    bidx = torch.div(pos_t, bl, rounding_mode="floor").clamp(0, b - 1)
    bids = tables.long().gather(1, bidx)                         # [S, T]
    if write is not None:
        bids = torch.where(write[:, None], bids, 0)              # scratch
    boffs = pos_t % bl
    if dp is not None:
        bids, boffs = col.all_gather(torch.stack([bids, boffs]), dp, 1)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        pool_l = {name: arr[i] for name, arr in pool.items()}
        y = _rmsnorm(x, lp["ln1"])
        q, k, v = _qkv_proj(lcfg, y, lp, "bt")  # q [S,T,H,Dh], kv [S,T,Hkv,Dh]
        if cfg.rope:
            q, k = _rope_apply(q, cos, sin), _rope_apply(k, cos, sin)
        if dp is None:
            _paged_write(cfg, pool_l, bids, boffs, k, v)
        else:
            rows = col.all_gather(torch.stack([k, v]), dp, 1)
            _paged_write(cfg, pool_l, bids, boffs, rows[0], rows[1])
        k_read, v_read = _paged_kv_read(cfg, pool_l, tables)
        attn = _masked_attention(lcfg, q, k_read, v_read, pos_t)
        x = x + col.reduce_from(torch.einsum("bthk,hkd->btd", attn, lp["wo"]),
                                tp)
        x = _dense_ffn(x, lp, ffn=cfg.ffn, tp=tp)
    return _rmsnorm(x, params["final_norm"])


def paged_verify_steps(cfg: TransformerConfig, params: dict, toks, pos0,
                       tables, pool: dict, write=None, mesh=None) -> tuple:
    """Score T tokens per slot against the paged pool in ONE forward: the
    reference's ``paged_verify_steps``, ``verify_steps`` through block
    tables (``_paged_slab``). toks [S, T] int32; pos0 [S] the first
    position of each slot's slab; tables [S, B]; pool written IN PLACE.
    ``write`` [S] bool (None: all) routes the slab writes of slots that
    are not verifying to scratch block 0, so their pool rows hold.
    Attention gathers each slot's table for the einsum attention, never
    the paged decode kernel, as in the reference. Returns (logits
    [S, T, vocab] f32, pool); position rollback is the caller's. Under
    ``mesh`` toks, pos0, tables and ``write`` are this rank's dp block of
    the slots: the gamma + 1 rows each slot writes are all-gathered over
    dp into every replica of the pool, and the logits gathered over
    tp."""
    if cfg.moe:
        raise NotImplementedError(DENSE_ONLY)
    x = _paged_slab(cfg, params, toks, pos0, tables, pool, write, mesh)
    logits = _vocab_logits("btd,vd->btv", x, params, mesh)
    return logits, pool


def paged_prefill_chunk(cfg: TransformerConfig, params: dict, tokens, table,
                        pos0: int, pool: dict, clen: int = None,
                        mesh=None) -> tuple:
    """``prefill_chunk`` through one slot's block table: tokens [Lc]
    consumed at positions pos0..pos0+Lc-1, their K/V rows written into the
    pool through ``table`` IN PLACE (quantised under ``kv_quant``), and
    attention over the gathered table. ``table`` [B] int32 is the slot's
    FULL-width table (B*block_len covers max_seq, so in-prompt positions
    never clamp); padding rows past ``clen`` land on scratch (unallocated
    entries are block 0) or on the slot's own future rows, which are
    written again before they are attended. Always the einsum attention,
    as in the reference. Returns (pool, logits [vocab] f32 after
    tokens[clen - 1]). Under ``mesh`` the heads, ffn and vocab split over
    tp as in ``decode_step`` and the pool holds this rank's KV heads;
    every dp rank runs the same chunk (a slot's table is the same on
    each), so each dp replica of the pool takes the same rows."""
    if cfg.moe:
        raise NotImplementedError(DENSE_ONLY)
    tp = axis_group(mesh, "tp")
    lcfg = _tp_local(cfg, mesh)
    lc = tokens.shape[0]
    b = table.shape[0]
    bl = pool["k"].shape[2]
    clen = lc if clen is None else clen
    start = max(0, min(int(pos0), cfg.max_seq - lc))   # the slice clamps
    pos_t = int(pos0) + torch.arange(lc, device=tokens.device)   # [Lc]
    x = _embed_rows(params, tokens, mesh)
    if not cfg.rope:
        x = x + params["pos_embed"][start:start + lc]
    x = x.to(cfg.dtype)                                          # [Lc, d]
    if cfg.rope:
        cos, sin = _rope_angles(pos_t, cfg.head_dim, cfg.rope_theta)
        cos, sin = cos[:, None], sin[:, None]
    bids = table.long()[torch.div(pos_t, bl, rounding_mode="floor")
                        .clamp(0, b - 1)]
    boffs = pos_t % bl
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        pool_l = {name: arr[i] for name, arr in pool.items()}
        y = _rmsnorm(x, lp["ln1"])
        q, k, v = _qkv_proj(lcfg, y, lp, "l")  # q [Lc,H,Dh], kv [Lc,Hkv,Dh]
        if cfg.rope:
            q, k = _rope_apply(q, cos, sin), _rope_apply(k, cos, sin)
        _paged_write(cfg, pool_l, bids, boffs, k, v)
        k_read, v_read = _paged_kv_read(cfg, pool_l, table[None])
        attn = _masked_attention(lcfg, q, k_read[0], v_read[0], pos_t)
        x = x + col.reduce_from(torch.einsum("thk,hkd->td", attn, lp["wo"]),
                                tp)
        x = _dense_ffn(x, lp, ffn=cfg.ffn, tp=tp)
    x = _rmsnorm(x, params["final_norm"])
    logits = _vocab_logits("d,vd->v", x[clen - 1], params, mesh)
    return pool, logits


def paged_prefill_chunk_batch(cfg: TransformerConfig, params: dict, tokens,
                              tables, pos0, pool: dict, clen,
                              mesh=None) -> tuple:
    """The dedicated prefill lane's batched chunk under the paged layout
    (the reference's ``paged_prefill_chunk_batch``): B rows' chunks tokens
    [B, Lc] consumed at positions pos0[b]..pos0[b]+Lc-1, their K/V rows
    written into the pool through each row's FULL-width table [B, Bf] IN
    PLACE (``_paged_slab``, the ``paged_verify_steps`` execution shape),
    with clen[b] real tokens per row. Rows write disjoint blocks (each lane
    slot owns its table); bucket padding rows carry all-zero tables, so
    their writes go to scratch block 0, which nothing attends. Returns
    (pool, logits [B, vocab] f32 after each row's tokens[clen[b] -
    1]). Under ``mesh`` every dp rank runs the whole batch (the lane
    slots' tables are the same on each), so each replica of the pool
    takes the same rows, as ``paged_prefill_chunk`` does; the heads, ffn
    and vocab split over tp."""
    if cfg.moe:
        raise NotImplementedError(DENSE_ONLY)
    x = _paged_slab(cfg, params, tokens, pos0, tables, pool, mesh=mesh,
                    gather_dp=False)
    logits = _vocab_logits("bd,vd->bv", _last_rows(x, clen), params, mesh)
    return pool, logits


# ------------------------------------------------- analytical FLOP model
#
# The reference's closed forms. A matmul of [m, k] x [k, n] costs 2*m*k*n
# FLOPs; every row of one dispatch runs the same kernel, so per-row FLOPs
# are equal and row-count waste shares (bucket padding, rejected verify
# rows) are exact. ``ctx`` counts attended positions, the token's own
# included.


def layer_flops_per_token(cfg: TransformerConfig) -> int:
    """Context-independent matmul FLOPs one token pays per layer: the QKV
    and output projections and the FFN (swiglu's third matmul, and
    Switch-MoE's router and single routed expert, included)."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    qkv = 2 * d * dh * (h + 2 * cfg.kv_heads)
    out = 2 * h * dh * d
    if cfg.moe:
        ffn = 2 * d * cfg.n_experts + 4 * d * cfg.d_ff  # router + top-1
    elif cfg.ffn == "swiglu":
        ffn = 6 * d * cfg.d_ff
    else:
        ffn = 4 * d * cfg.d_ff
    return qkv + out + ffn


def attn_flops_per_pos(cfg: TransformerConfig) -> int:
    """Attention FLOPs one token pays per layer per attended position: the
    QK^T score and the value reduction."""
    return 4 * cfg.n_heads * cfg.head_dim


def logit_flops(cfg: TransformerConfig) -> int:
    """Vocabulary projection FLOPs for one sampled position."""
    return 2 * cfg.d_model * cfg.vocab_size


def token_flops(cfg: TransformerConfig, ctx: int,
                logits: bool = True) -> int:
    """Forward FLOPs of ONE token attending ``ctx`` positions: a decode
    step, a verify row and a prefill position all cost this, at their
    own ``ctx``."""
    ctx = max(1, int(ctx))
    per_layer = layer_flops_per_token(cfg) + attn_flops_per_pos(cfg) * ctx
    total = cfg.n_layers * per_layer
    if logits:
        total += logit_flops(cfg)
    return total


def span_flops(cfg: TransformerConfig, pos0: int, n: int,
               logits: bool = True) -> int:
    """FLOPs of ``n`` consecutive positions from ``pos0``: the closed form
    of ``sum(token_flops(cfg, p + 1) for p in range(pos0, pos0 + n))``
    (the attention term is linear in the context, so the sum
    telescopes)."""
    n = int(n)
    if n <= 0:
        return 0
    pos0 = max(0, int(pos0))
    ctx_sum = n * pos0 + n * (n + 1) // 2
    total = cfg.n_layers * (layer_flops_per_token(cfg) * n
                            + attn_flops_per_pos(cfg) * ctx_sum)
    if logits:
        total += logit_flops(cfg) * n
    return total


def kv_bytes_per_token(cfg: TransformerConfig) -> int:
    """KV bytes ONE position holds across all layers, K and V: int8 halves
    the payload and adds one f32 scale per (position, KV head)."""
    per_elem = 1 if cfg.kv_quant else 2
    payload = 2 * cfg.n_layers * cfg.kv_heads * cfg.head_dim * per_elem
    scales = 2 * cfg.n_layers * cfg.kv_heads * 4 if cfg.kv_quant else 0
    return payload + scales


def token_bytes(cfg: TransformerConfig, ctx: int) -> int:
    """Memory traffic one decode token pays: every weight read once, the
    KV read over ``ctx`` positions and its own KV write."""
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    w_elems = d * dh * (h + 2 * cfg.kv_heads) + h * dh * d
    if cfg.moe:
        w_elems += d * cfg.n_experts + 2 * d * f
    elif cfg.ffn == "swiglu":
        w_elems += 3 * d * f
    else:
        w_elems += 2 * d * f
    weight_bytes = cfg.n_layers * w_elems * 2 + cfg.vocab_size * d * 2
    kv = kv_bytes_per_token(cfg)
    return weight_bytes + kv * max(1, int(ctx)) + kv


# ---------------------------------------------------------------- training

def _vocab_parallel_nll(logits, targets, mesh):
    """-log softmax(logits)[target] per token. logits: this rank's block
    [..., vocab/tp] (f32) of the tp-split vocabulary; the max and the sum
    of exponentials are reduced over tp and each rank contributes its
    target logit when the target lies in its slice."""
    group = axis_group(mesh, "tp")
    if group is None:
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, targets.long()[..., None])[..., 0]
    v0 = axis_index(mesh, "tp") * logits.shape[-1]
    return _VocabParallelNLL.apply(logits, targets.long() - v0, group)


class _VocabParallelNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, local_targets, group):
        v_loc = logits.shape[-1]
        m = col.all_reduce_max(logits.amax(dim=-1), group)
        shifted = logits - m[..., None]
        ex = shifted.exp()
        total = col.all_reduce_sum(ex.sum(dim=-1), group)
        inside = (local_targets >= 0) & (local_targets < v_loc)
        idx = local_targets.clamp(0, v_loc - 1)
        picked = shifted.gather(-1, idx[..., None])[..., 0]
        picked = col.all_reduce_sum(torch.where(inside, picked, 0.0), group)
        ctx.save_for_backward(ex / total[..., None], idx, inside)
        return torch.log(total) - picked

    @staticmethod
    def backward(ctx, grad):
        probs, idx, inside = ctx.saved_tensors
        g = probs.clone()
        g.scatter_add_(-1, idx[..., None], -inside[..., None].to(g.dtype))
        return g * grad[..., None], None, None


def loss_fn(cfg: TransformerConfig, params: dict, tokens, mesh=None):
    """Next-token cross-entropy over tokens[:, :-1] -> tokens[:, 1:], the
    mean over tokens, plus ``aux_loss_weight`` times the aux loss.

    Under ``mesh``: params are the rank's block, tokens the rank's dp
    block of the batch [B/dp, L+1] (a length like 2^k + 1 need not divide
    sp; each rank takes its sp block of the L inputs and targets). The
    returned value is the global loss on every rank; its gradient is the
    rank's own share (its block's mean plus the aux term), so averaging
    the gradients over dp and sp gives the global loss's gradient."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if mesh is not None:
        sp = axis_size(mesh, "sp")
        if inputs.shape[1] % sp:
            raise ValueError(f"sequence {inputs.shape[1]} does not split "
                             f"over sp={sp}")
        l = inputs.shape[1] // sp
        at = axis_index(mesh, "sp") * l
        inputs, targets = inputs[:, at:at + l], targets[:, at:at + l]
    logits, aux = forward(cfg, params, inputs, mesh=mesh)
    nll = _vocab_parallel_nll(logits, targets, mesh)
    loss = nll.mean() + cfg.aux_loss_weight * aux
    if mesh is None:
        return loss
    groups = [axis_group(mesh, "dp"), axis_group(mesh, "sp")]
    total = loss.detach().clone()
    col.average_([total], groups)
    return loss + (total - loss.detach())


def value_and_grad(cfg: TransformerConfig, params: dict, tokens,
                   mesh=None) -> tuple:
    """(loss, grads): ``loss_fn`` and its gradient with respect to every
    parameter, in ``params``' tree (detached). Under a mesh the gradients
    of the rank's block are averaged over dp and sp."""
    leaves = [p.detach().requires_grad_(True) for p in _tree_leaves(params)]
    loss = loss_fn(cfg, _tree_unflatten(params, leaves), tokens, mesh=mesh)
    grads = list(torch.autograd.grad(loss, leaves))
    if mesh is not None:
        col.average_(grads, [axis_group(mesh, "dp"), axis_group(mesh, "sp")])
    return loss.detach(), _tree_unflatten(params, grads)


class AdamW:
    """Functional AdamW with ``optax.adamw``'s defaults and order of
    operations: Adam's moments (``mu``, ``nu``; b1 0.9, b2 0.999) with
    bias correction and eps 1e-8 (eps_root 0), then decoupled weight decay
    1e-4 on every leaf, then the step scaled by ``-learning_rate``. The
    moments keep each parameter's dtype (optax's ``mu_dtype`` None). Note
    the weight decay: ``torch.optim.AdamW`` takes 0.01."""

    B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4

    def __init__(self, learning_rate: float = 1e-3):
        self.learning_rate = learning_rate

    def init(self, params: dict) -> dict:
        device = _tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": _tree_map(torch.zeros_like, params),
                "nu": _tree_map(torch.zeros_like, params)}

    def update(self, grads: dict, state: dict, params: dict) -> tuple:
        """(updates, new state), as ``optax.GradientTransformation``."""
        b1, b2, eps, wd = self.B1, self.B2, self.EPS, self.WEIGHT_DECAY
        lr = self.learning_rate
        mu = _tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = _tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                       state["nu"])
        count = state["count"] + 1
        c = count.float()
        bc1 = 1 - torch.full_like(c, b1) ** c
        bc2 = 1 - torch.full_like(c, b2) ** c

        def step(m, v, p):
            u = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype)) + eps)
            return -lr * (u + wd * p)

        updates = _tree_map(step, mu, nu, params)
        return updates, {"count": count, "mu": mu, "nu": nu}


def apply_updates(params: dict, updates: dict) -> dict:
    """``optax.apply_updates``: p + u in each parameter's dtype."""
    return _tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def init_state_from_params(cfg: TransformerConfig, params: dict, mesh=None,
                           optimizer=None) -> dict:
    """A train state from whole parameters (carried weights, for example):
    ``{"params", "opt", "step"}``, the params cut to the rank's block under
    ``mesh``. ``optimizer`` as ``make_train_step``'s (AdamW's state does
    not depend on its learning rate)."""
    optimizer = optimizer or AdamW()
    if mesh is not None:
        params = shard_params(cfg, params, mesh)
    params = _tree_map(torch.Tensor.detach, params)
    device = _tree_leaves(params)[0].device
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_train_step(cfg: TransformerConfig, mesh=None, optimizer=None,
                    learning_rate: float = 1e-3):
    """(init_state, train_step), the reference's pair.

    ``init_state(generator)`` draws the whole parameters from the
    ``torch.Generator`` (on its device: the card unless the caller makes
    it on the CPU) and returns ``{"params", "opt", "step"}``; under
    ``mesh`` every rank draws the same whole parameters and keeps its
    block. ``train_step(state, tokens)`` takes the global batch [B, L+1]
    (each rank of a mesh takes its dp block) and returns (new state,
    ``{"loss"}``). ``optimizer``: an object with ``init(params)`` and
    ``update(grads, state, params) -> (updates, state)`` (default
    ``AdamW(learning_rate)``).

    ``attn_impl="flash"`` raises ``ValueError``: the flash kernel has no
    backward, on the card as in the reference."""
    if cfg.attn_impl == "flash":
        raise ValueError(
            "attn_impl='flash' cannot train: the flash attention kernel "
            "(ops/flash_attention.py, as the reference's Pallas kernel) has "
            "no backward; use 'ref' or 'ring'")
    if optimizer is None:
        optimizer = AdamW(learning_rate)
    dp, dp_idx = axis_size(mesh, "dp"), axis_index(mesh, "dp")

    def init_state(generator: torch.Generator) -> dict:
        return init_state_from_params(cfg, init_params(generator, cfg), mesh,
                                      optimizer)

    def train_step(state: dict, tokens) -> tuple:
        if mesh is not None:
            if tokens.shape[0] % dp:
                raise ValueError(f"batch {tokens.shape[0]} does not split "
                                 f"over dp={dp}")
            b = tokens.shape[0] // dp
            tokens = tokens[dp_idx * b:(dp_idx + 1) * b]
        loss, grads = value_and_grad(cfg, state["params"], tokens, mesh)
        updates, opt = optimizer.update(grads, state["opt"], state["params"])
        return ({"params": apply_updates(state["params"], updates),
                 "opt": opt, "step": state["step"] + 1},
                {"loss": loss})

    return init_state, train_step
