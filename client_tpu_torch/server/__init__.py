"""The serving runtime on PyTorch: the port's counterpart of
``client_tpu.server``.

Models run on the card with device-resident weights, behind the dynamic
batcher (static-bucket padding, an in-flight pipeline completed on CUDA
events) and the v2 HTTP and gRPC front ends (``http_server``,
``grpc_server``; the latter needs grpcio and is imported on its own);
decoupled models stream their responses through
``TorchInferenceServer.infer(request, response_callback)``, which gRPC's
``ModelStreamInfer`` calls, the continuous-batching engine
(``server/generation.py``) behind them.
"""

from client_tpu_torch.server.config import (  # noqa: F401
    DynamicBatchingConfig,
    ModelConfig,
    TensorSpec,
)
from client_tpu_torch.server.core import TorchInferenceServer  # noqa: F401
from client_tpu_torch.server.model import (  # noqa: F401
    PyModel,
    ServedModel,
    TorchModel,
)
