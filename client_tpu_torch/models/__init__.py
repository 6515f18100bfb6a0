"""Served models on PyTorch: the transformer (``transformer``), token
selection (``sampling``), the sequence decoder, the single-stream,
static-batch and continuous generators and the replica fleet
(``decoder_lm``), ResNet-50 with its preprocess step and image
ensemble (``resnet``), the decoupled and stateful demo models
(``streaming``) and the add_sub / identity protocol-test models
(``add_sub``)."""

from client_tpu_torch.models.add_sub import (  # noqa: F401
    make_add_sub,
    make_add_sub_string,
    make_identity,
)
from client_tpu_torch.models.resnet import (  # noqa: F401
    make_image_ensemble,
    make_preprocess,
    make_resnet50,
)
from client_tpu_torch.models.streaming import (  # noqa: F401
    make_accumulator,
    make_repeat,
)
from client_tpu_torch.models.decoder_lm import (  # noqa: F401
    make_batch_generator,
    make_continuous_generator,
    make_decoder_lm,
    make_generator,
    make_replica_fleet,
)
