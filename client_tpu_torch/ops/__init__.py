"""Device ops: the plain attention (``ops.attention``); the kernels
written by hand for Hopper, flash attention (``ops.flash_attention``) and
paged decode attention (``ops.paged_attention``), CUDA sources in
``csrc/``; and the training path's plain PyTorch ops, the Switch-MoE FFN
(``ops.moe``) and ring attention (``ops.ring_attention``), which run no
kernel of their own.

Only the two kernel-free ops are re-exported here, so each kernel's
module stays the one whose ``launches`` counter a run reads.
"""

from client_tpu_torch.ops.moe import moe_ffn, moe_ffn_sharded
from client_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_attention_local,
)

__all__ = ["moe_ffn", "moe_ffn_sharded", "ring_attention",
           "ring_attention_local"]
