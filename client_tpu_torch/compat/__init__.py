"""Compatibility names for code written against ``tritonclient``: the
port's copy of ``client_tpu/compat``, so a ``tritonclient`` user can
switch imports one for one:

    from client_tpu_torch.compat import httpclient      # tritonclient.http
    from client_tpu_torch.compat import grpcclient      # tritonclient.grpc
    from client_tpu_torch.compat import utils           # tritonclient.utils
    from client_tpu_torch.compat import shared_memory   # ...utils.shared_memory
    from client_tpu_torch.compat import cuda_shared_memory

The method surfaces match (InferenceServerClient / InferInput /
InferRequestedOutput / InferResult with the same verbs). ``grpcclient``
is imported on first use (the module ``__getattr__`` below), so the
other names work where grpcio is not installed.
"""

from client_tpu_torch import utils  # noqa: F401
from client_tpu_torch.client import http as httpclient  # noqa: F401
from client_tpu_torch.utils import cuda_shared_memory  # noqa: F401
from client_tpu_torch.utils import shared_memory  # noqa: F401

InferenceServerException = utils.InferenceServerException
np_to_triton_dtype = utils.np_to_wire_dtype
triton_to_np_dtype = utils.wire_to_np_dtype
serialize_byte_tensor = utils.serialize_byte_tensor
deserialize_bytes_tensor = utils.deserialize_bytes_tensor


def __getattr__(name):
    if name == "grpcclient":
        from client_tpu_torch.client import grpc as grpcclient

        return grpcclient
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
