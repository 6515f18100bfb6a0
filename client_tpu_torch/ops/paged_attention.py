"""Paged (block-table) decode attention on Hopper: the port of the Pallas
TPU kernel ``client_tpu/ops/paged_attention.py``
(``paged_decode_attention`` -> ``_kernel``).

``paged_decode_attention`` launches the CUDA kernel in
``ops/csrc/paged_attention.cu`` for CUDA tensors and takes the plain
version, ``paged_decode_attention_reference``, only for tensors that lie
on the CPU. Anything else raises: there is no fallback on the card.

Each slot's single query row attends the K/V rows its block table names,
read straight out of one layer's pool slabs (``[N, bl, Hkv, Dh]``, which
may be strided views of the layer-major pool), with an online softmax in
f32 over the slot's live blocks. The kernel takes f32 and bf16, grouped
queries (``H`` a multiple of ``Hkv``) and ``Dh <= 128``. One launch splits
each slot's table over a thread-block cluster and merges the partial
softmax states in distributed shared memory. Pools whose base pointers,
strides or ``Dh`` do not allow 16-byte copies take a scalar-load
instantiation of the same kernel. Its design and its bound on the card are
noted at the top of the CUDA source.

Under an engine's tp×dp mesh it runs at the rank's block: q [S/dp, H/tp,
Dh] against pools of Hkv/tp heads, any H a multiple of Hkv.

``launches`` counts the kernel's launches (and only those), so a run can
show that its main path went through the kernel. A launch recorded into a
CUDA graph capture is not one: each replay of the graph adds the launches
its capture recorded (``_build.LaunchCounter``).
"""

from __future__ import annotations

import ctypes

import torch

from client_tpu_torch.ops import _build

KERNEL = "paged_attention"
MAX_HEAD_DIM = 128
MASK_VALUE = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_launches = _build.LaunchCounter(__name__)


def _bind(lib) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.paged_decode_attention_fwd.argtypes = (
        [i32] + [ptr] * 6 + [i32] * 7 + [i64] * 11 + [ctypes.c_float, ptr])
    lib.paged_decode_attention_fwd.restype = i32
    lib.paged_attention_error_string.argtypes = [i32]
    lib.paged_attention_error_string.restype = ctypes.c_char_p


def _check(q, k_pool, v_pool, tables, pos) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be [S, H, Dh], got shape {tuple(q.shape)}")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            "k_pool and v_pool must share one [N, block_len, Hkv, Dh] shape, "
            f"got {tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    s, h, dh = q.shape
    if k_pool.shape[3] != dh:
        raise ValueError(f"pool head_dim {k_pool.shape[3]} != q head_dim {dh}")
    hkv = k_pool.shape[2]
    if h % hkv:
        raise ValueError(f"n_heads {h} must be a multiple of kv heads {hkv}")
    if tables.dim() != 2 or tables.shape[0] != s or tables.shape[1] < 1:
        raise ValueError(f"tables must be [S={s}, B>=1], got "
                         f"{tuple(tables.shape)}")
    if pos.shape != (s,):
        raise ValueError(f"pos must be [S={s}], got {tuple(pos.shape)}")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"tables and pos must be int32, got {tables.dtype} "
                        f"and {pos.dtype}")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(
            "paged_decode_attention takes float32 or bfloat16 q and pools of "
            f"one dtype, got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} is outside 1..{MAX_HEAD_DIM}")
    if any(t.device != q.device for t in (k_pool, v_pool, tables, pos)):
        raise ValueError("q, the pools, tables and pos must lie on one device")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """q [S, H, Dh]; k_pool/v_pool one layer's pool slabs
    [N, block_len, Hkv, Dh]; tables [S, B] int32 pool block ids; pos [S]
    int32, the position each slot attends up to (rows past it are
    masked). Returns [S, H, Dh] in q's dtype: the CUDA kernel on the card,
    the plain version on the CPU."""
    _check(q, k_pool, v_pool, tables, pos)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pool, v_pool, tables,
                                                pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables)):
        if t.stride(-1) != 1:
            raise ValueError(f"the last dim of {name} must be contiguous")
    pos = pos.contiguous()
    lib = _build.load(KERNEL, _bind)
    s, h, dh = q.shape
    n, bl, hkv, _ = k_pool.shape
    o = torch.empty((s, h, dh), dtype=q.dtype, device=q.device)
    strides = (q.stride(0), q.stride(1), *k_pool.stride()[:3],
               *v_pool.stride()[:3], tables.stride(0), o.stride(0),
               o.stride(1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), pos.data_ptr(),
            o.data_ptr(), s, h, hkv, dh, n, bl, tables.shape[1], *strides,
            dh ** -0.5, stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {err} ({msg})")
    _launches.count()
    return o


def paged_decode_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     tables: torch.Tensor,
                                     pos: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: the Pallas kernel's sweep over
    the table's blocks in order, with its rounding points.

    q, k and v are upcast to f32 and the logits scaled by Dh^-0.5; rows at
    positions past ``pos`` are masked to -1e30 and the running max starts
    at -1e30; the probabilities stay f32 for the PV product; the sums
    accumulate in f32 with one division at the end and one cast. A block
    at or past ``pos // block_len + 1`` leaves a slot's state untouched,
    as the Pallas kernel skips it."""
    s, h, dh = q.shape
    bl, hkv = k_pool.shape[1], k_pool.shape[2]
    r = h // hkv
    scale = dh ** -0.5
    dev = q.device
    qg = q.float().reshape(s, hkv, r, dh)
    tab = tables.long()
    p = pos.long()
    live = torch.div(p, bl, rounding_mode="floor") + 1         # [S]
    acc = torch.zeros((s, hkv, r, dh), dtype=torch.float32, device=dev)
    m = torch.full((s, hkv, r), MASK_VALUE, dtype=torch.float32, device=dev)
    ssum = torch.zeros((s, hkv, r), dtype=torch.float32, device=dev)
    offs = torch.arange(bl, device=dev)
    for b in range(tab.shape[1]):
        k = k_pool[tab[:, b]].float()                           # [S, bl, g, d]
        v = v_pool[tab[:, b]].float()
        logits = torch.einsum("sgrd,stgd->sgrt", qg, k) * scale
        t_pos = b * bl + offs
        keep = (t_pos[None, :] <= p[:, None])[:, None, None, :]
        logits = torch.where(keep, logits, torch.full_like(logits,
                                                           MASK_VALUE))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        prob = torch.exp(logits - m_new[..., None])
        new_s = ssum * corr + prob.sum(dim=-1)
        new_acc = acc * corr[..., None] + torch.einsum("sgrt,stgd->sgrd",
                                                       prob, v)
        on = (b < live)[:, None, None]
        m = torch.where(on, m_new, m)
        ssum = torch.where(on, new_s, ssum)
        acc = torch.where(on[..., None], new_acc, acc)
    out = acc / ssum[..., None]
    return out.reshape(s, h, dh).to(q.dtype)
