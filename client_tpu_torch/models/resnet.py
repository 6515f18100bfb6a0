"""ResNet-50 v1.5, the image-classification serving family: the port's
counterpart of ``client_tpu/models/resnet.py``.

The weights are drawn from ``numpy.random.default_rng(seed)`` in the
reference's order, so ``init_params(seed)`` gives the reference's values;
``params_from_jax`` carries any reference tree across. Convolution
kernels go from the reference's HWIO to OIHW, and batch norm stays the
inference-mode per-channel affine.

``forward`` takes NHWC images, as they come on the wire, and computes in
NCHW tensors laid out ``torch.channels_last`` (the NHWC bytes, no copy),
where cuDNN's bf16 convolutions run fastest on Hopper. The rounding
points are the reference's: each convolution rounds its f32 accumulation
to the activations' dtype once, the stem's 3x3/2 max pool pads with
-inf, the global mean is taken in f32 and the classifier runs in f32.
The convolutions are plain ``F.conv2d``, as the reference's are plain
XLA convolutions outside any Pallas kernel.

``make_resnet50`` serves it behind the dynamic batcher (preferred batch
8, a 2000 us window), ``make_preprocess`` decodes encoded images on the
host (Pillow, imported when a request runs) and ``make_image_ensemble``
chains the two.
"""

from __future__ import annotations

import io

import numpy as np
import torch
import torch.nn.functional as F

from client_tpu_torch.device import resolve_device
from client_tpu_torch.server.config import (
    DynamicBatchingConfig,
    EnsembleStep,
    ModelConfig,
    TensorSpec,
)
from client_tpu_torch.server.model import PyModel, ServedModel, TorchModel

STAGES = (3, 4, 6, 3)  # ResNet-50
STAGE_CHANNELS = (256, 512, 1024, 2048)


# ---------------------------------------------------------------- params

def init_params(seed: int = 0, num_classes: int = 1000,
                dtype: torch.dtype = torch.bfloat16,
                device="cpu") -> dict:
    """He-initialised weights from the reference's numpy draws, in the
    reference's tree (``stem``, ``stage0``..``stage3`` lists of blocks,
    ``fc``), convolution kernels OIHW, on ``device`` in ``dtype``."""
    rng = np.random.default_rng(seed)

    def tensor(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=dtype)

    def conv(kh, kw, cin, cout):
        fan_in = kh * kw * cin
        w = rng.standard_normal((kh, kw, cin, cout)) * np.sqrt(2.0 / fan_in)
        return tensor(w.transpose(3, 2, 0, 1))

    def bn(c):
        return {"scale": torch.ones((c,), dtype=dtype, device=device),
                "bias": torch.zeros((c,), dtype=dtype, device=device)}

    params = {"stem": {"conv": conv(7, 7, 3, 64), "bn": bn(64)}}
    cin = 64
    for si, (n_blocks, cout) in enumerate(zip(STAGES, STAGE_CHANNELS)):
        mid = cout // 4
        blocks = []
        for bi in range(n_blocks):
            block = {
                "conv1": conv(1, 1, cin, mid), "bn1": bn(mid),
                "conv2": conv(3, 3, mid, mid), "bn2": bn(mid),
                "conv3": conv(1, 1, mid, cout), "bn3": bn(cout),
            }
            if bi == 0:
                block["proj"] = conv(1, 1, cin, cout)
                block["proj_bn"] = bn(cout)
            blocks.append(block)
            cin = cout
        params[f"stage{si}"] = blocks
    params["fc"] = {
        "w": tensor(rng.standard_normal((2048, num_classes))
                    * (2048 ** -0.5)),
        "b": torch.zeros((num_classes,), dtype=dtype, device=device),
    }
    return params


def params_from_jax(tree, device, dtype: torch.dtype = None):
    """The reference's ResNet tree (numpy or jax arrays) as the port's:
    4-d kernels HWIO -> OIHW, every other leaf as it is; each leaf in
    ``dtype`` (default: its own, bf16 kept) on ``device``, which the
    caller names (``transformer.params_from_jax``'s rule)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    arr = np.asarray(tree)
    want = dtype
    if want is None:
        want = (torch.bfloat16 if arr.dtype.name == "bfloat16"
                else torch.from_numpy(np.zeros(0, arr.dtype)).dtype)
    t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
    if t.dim() == 4:
        t = t.permute(3, 2, 0, 1).contiguous()
    return t.to(device=device, dtype=want)


def to_channels_last(params):
    """Every 4-d kernel of a tree in ``torch.channels_last`` (the layout
    cuDNN's NHWC convolutions read without a transpose)."""
    if isinstance(params, dict):
        return {k: to_channels_last(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [to_channels_last(v) for v in params]
    if params.dim() == 4:
        return params.contiguous(memory_format=torch.channels_last)
    return params


# ---------------------------------------------------------------- forward

def _conv(x, w, stride=1):
    """One convolution, padded by half the kernel as the reference pads,
    accumulated in f32 and rounded once to ``x``'s dtype: cuDNN
    accumulates half-precision convolutions in f32; on the CPU the
    operands are widened to f32 (their products are exact there)."""
    pad = (w.shape[2] // 2, w.shape[3] // 2)
    if x.is_cuda:
        return F.conv2d(x, w, stride=stride, padding=pad)
    return F.conv2d(x.float(), w.float(), stride=stride,
                    padding=pad).to(x.dtype)


def _bn_relu(x, bn, relu=True):
    y = x * bn["scale"][:, None, None] + bn["bias"][:, None, None]
    return torch.clamp_min(y, 0) if relu else y


def _bottleneck(x, p, stride):
    y = _bn_relu(_conv(x, p["conv1"]), p["bn1"])
    y = _bn_relu(_conv(y, p["conv2"], stride), p["bn2"])
    y = _bn_relu(_conv(y, p["conv3"]), p["bn3"], relu=False)
    if "proj" in p:
        x = _bn_relu(_conv(x, p["proj"], stride), p["proj_bn"], relu=False)
    return torch.clamp_min(x + y, 0)


def forward(params: dict, images) -> torch.Tensor:
    """images [B, H, W, 3] NHWC (any float dtype, any H x W) -> logits
    [B, classes] f32."""
    x = images.to(params["stem"]["conv"].dtype).permute(0, 3, 1, 2)
    x = x.contiguous(memory_format=torch.channels_last)
    x = _bn_relu(_conv(x, params["stem"]["conv"], stride=2),
                 params["stem"]["bn"])
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)  # -inf padded
    for si, n_blocks in enumerate(STAGES):
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            x = _bottleneck(x, params[f"stage{si}"][bi], stride)
    x = x.float().mean(dim=(2, 3))                     # global average pool
    return x @ params["fc"]["w"].float() + params["fc"]["b"].float()


# ------------------------------------------------------------- factories

def make_resnet50(name: str = "resnet50", max_batch_size: int = 8,
                  num_classes: int = 1000, seed: int = 0,
                  dynamic_batching: bool = True,
                  device=None) -> TorchModel:
    """ResNet-50 in bf16 behind the dynamic batcher: image FP32
    [224, 224, 3] -> logits FP32 [classes]; on the card unless
    ``device="cpu"`` is asked for."""
    device = resolve_device(device)
    params = to_channels_last(init_params(seed, num_classes))

    def apply_fn(params, inputs):
        return {"logits": forward(params, inputs["image"])}

    config = ModelConfig(
        name=name,
        max_batch_size=max_batch_size,
        inputs=(TensorSpec("image", "FP32", (224, 224, 3)),),
        outputs=(TensorSpec("logits", "FP32", (num_classes,)),),
        dynamic_batching=(DynamicBatchingConfig(
            preferred_batch_size=(max_batch_size,),
            max_queue_delay_microseconds=2000)
            if dynamic_batching else None),
    )
    return TorchModel(config, apply_fn, params=params, device=device)


def make_preprocess(name: str = "preprocess",
                    max_batch_size: int = 8) -> ServedModel:
    """Decode + resize + scale on the host: BYTES (an encoded image) ->
    FP32 [224, 224, 3] in [-1, 1]. Image decoding is not a device op;
    Pillow is imported when a request runs."""

    def fn(inputs):
        from PIL import Image

        flat = inputs["raw_image"].reshape(-1)
        out = np.zeros((len(flat), 224, 224, 3), np.float32)
        for i, item in enumerate(flat):
            data = item if isinstance(item, (bytes, bytearray)) \
                else bytes(item)
            img = Image.open(io.BytesIO(data)).convert("RGB")
            img = img.resize((224, 224))
            # Inception-style scaling to [-1, 1]
            out[i] = (np.asarray(img, np.float32) / 127.5) - 1.0
        return {"image": out}

    config = ModelConfig(
        name=name,
        max_batch_size=max_batch_size,
        inputs=(TensorSpec("raw_image", "BYTES", (1,)),),
        outputs=(TensorSpec("image", "FP32", (224, 224, 3)),),
    )
    return PyModel(config, fn)


def make_image_ensemble(name: str = "preprocess_resnet50",
                        preprocess_name: str = "preprocess",
                        resnet_name: str = "resnet50",
                        max_batch_size: int = 8,
                        num_classes: int = 1000) -> ServedModel:
    """Ensemble: an encoded image -> preprocess -> resnet -> logits."""
    config = ModelConfig(
        name=name,
        max_batch_size=max_batch_size,
        inputs=(TensorSpec("raw_image", "BYTES", (1,)),),
        outputs=(TensorSpec("logits", "FP32", (num_classes,)),),
        ensemble_steps=(
            EnsembleStep(preprocess_name,
                         input_map={"raw_image": "raw_image"},
                         output_map={"image": "_preprocessed"}),
            EnsembleStep(resnet_name,
                         input_map={"image": "_preprocessed"},
                         output_map={"logits": "logits"}),
        ),
    )
    return ServedModel(config)
