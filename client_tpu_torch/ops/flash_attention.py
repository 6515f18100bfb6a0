"""Flash attention on Hopper: the port of the Pallas TPU kernel
``client_tpu/ops/flash_attention.py`` (``flash_attention`` -> ``_kernel``).

``flash_attention`` launches the CUDA kernel in
``ops/csrc/flash_attention.cu`` for a CUDA tensor and takes the plain
version, ``flash_attention_reference``, only for a tensor that lies on the
CPU. Anything else raises: there is no fallback on the card.

The kernel reads q, k and v in their ``[B, L, H, D]`` layout through
strides, takes f32 and bf16, ``causal`` on or off, any L (the ragged edge
is masked in the kernel) and D <= 128. bf16 runs on the tensor cores and
stages its tiles with 16-byte copies where every base pointer and stride
allows them; a view that does not (an odd offset, a stride or D that is
not a multiple of 8) takes a scalar-load instantiation of the same kernel
and gets the same result. f32 runs on the CUDA cores. The design and the
bound on the card are noted at the top of the CUDA source.

``launches`` counts the kernel's launches (and only those), so a run can
show that its main path went through the kernel. A launch recorded into a
CUDA graph capture is not one: each replay of the graph adds the launches
its capture recorded (``_build.LaunchCounter``).
"""

from __future__ import annotations

import ctypes

import torch

from client_tpu_torch.ops import _build

KERNEL = "flash_attention"
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_launches = _build.LaunchCounter(__name__)


def _bind(lib) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = (
        [i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32] + [i64] * 12
        + [i32, ctypes.c_float, ptr])
    lib.flash_attention_fwd.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, L, H, D], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "self-attention: q, k and v must share one [B, L, H, D] shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(
            "flash_attention takes float32 or bfloat16 q, k, v of one "
            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {q.shape[-1]} is outside 1..{MAX_HEAD_DIM}")
    if q.numel() == 0:
        raise ValueError(f"empty input of shape {tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the last (head_dim) dim of q, k, v must be "
                         "contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """q/k/v: [B, L, H, D] (self-attention). Returns [B, L, H, D] in q's
    dtype: the CUDA kernel on the card, the plain version on the CPU."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    lib = _build.load(KERNEL, _bind)
    b, l, h, d = q.shape
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), b, l, h, d, *strides, int(causal), d ** -0.5,
            stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} ({msg})")
    _launches.count()
    return o


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              block: int = 128) -> torch.Tensor:
    """The kernel's plain PyTorch version: the reference's tiled online
    softmax, one K/V block of ``block`` keys at a time over all queries.

    Same rounding points as the kernel: logits in f32 (the inputs are
    upcast, which is exact for bf16 products) scaled by D^-0.5, masked
    with -1e30, probabilities summed in f32 and rounded to v's dtype
    before the PV product, PV accumulated in f32, one division by the row
    sum at the end. Masked keys contribute exactly zero, so visiting the
    blocks past the causal diagonal changes nothing; any L works."""
    b, l, h, d = q.shape
    scale = d ** -0.5
    qf = q.float()
    acc = torch.zeros((b, h, l, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, l), -1e30, dtype=torch.float32, device=q.device)
    s = torch.zeros((b, h, l), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(l, device=q.device)[:, None]
    for k0 in range(0, k.shape[1], block):
        kb = k[:, k0:k0 + block]
        vb = v[:, k0:k0 + block]
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        if causal:
            k_pos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            logits = logits.masked_fill(~(q_pos >= k_pos), -1e30)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - new_m)
        p = torch.exp(logits - new_m[..., None])
        s = s * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype).float(), vb.float())
        m = new_m
    out = (acc / s[..., None]).to(q.dtype)
    return out.permute(0, 2, 1, 3).contiguous()
