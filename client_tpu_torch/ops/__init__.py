"""Attention ops: the plain reference (``ops.attention``) and the kernels
written by hand for Hopper, flash attention (``ops.flash_attention``) and
paged decode attention (``ops.paged_attention``), CUDA sources in
``csrc/``.

Nothing is re-exported here, so each kernel's module stays the one whose
``launches`` counter a run reads.
"""
