"""KServe "v2" inference protocol core: dtypes, binary framing, REST JSON.

Pure-logic layer (L2 in SURVEY.md §1): no sockets, no devices. Everything
here is unit-testable hermetically.

The port's own copy of ``client_tpu/protocol/__init__.py``. The gRPC
messages and stubs (``kserve_pb2``, ``grpc_defs``, ``grpc_tensors``) are
imported on their own: they need grpcio and protobuf.
"""

from client_tpu_torch.protocol.dtypes import (  # noqa: F401
    DataType,
    np_to_wire_dtype,
    wire_to_np_dtype,
    dtype_byte_size,
    element_count,
    tensor_byte_size,
)
from client_tpu_torch.protocol.binary import (  # noqa: F401
    serialize_byte_tensor,
    deserialize_bytes_tensor,
    serialized_byte_size,
    tensor_to_bytes,
    bytes_to_tensor,
)
from client_tpu_torch.protocol.rest import (  # noqa: F401
    INFERENCE_HEADER_CONTENT_LENGTH,
    build_infer_request_body,
    parse_infer_request_body,
    build_infer_response_body,
    parse_infer_response_body,
)
