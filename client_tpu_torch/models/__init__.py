"""Served models on PyTorch: the transformer (``transformer``), token
selection (``sampling``), the continuous generator (``decoder_lm``) and
the add_sub / identity protocol-test models (``add_sub``)."""

from client_tpu_torch.models.add_sub import (  # noqa: F401
    make_add_sub,
    make_identity,
)
