"""gRPC service binding for inference.GRPCInferenceService.

The port's counterpart of ``client_tpu/protocol/grpc_defs.py``. The
service stubs are defined by hand on the message classes of
``kserve_pb2`` (no protoc gRPC plugin is needed), through the same
``channel.unary_unary`` / ``method_handlers_generic_handler`` machinery
generated code uses. The reference's ``TpuSharedMemory*`` rows are
``CudaSharedMemory*`` here.

``METHODS`` is the one table the server (``server/grpc_server.py``) and
a client of the port read.
"""

from __future__ import annotations

from client_tpu_torch.protocol import kserve_pb2 as pb

SERVICE = "inference.GRPCInferenceService"

# name -> (kind, request message, response message)
#   kind: "unary" | "stream" (bidirectional streaming)
METHODS = {
    "ServerLive": ("unary", pb.ServerLiveRequest, pb.ServerLiveResponse),
    "ServerReady": ("unary", pb.ServerReadyRequest, pb.ServerReadyResponse),
    "ModelReady": ("unary", pb.ModelReadyRequest, pb.ModelReadyResponse),
    "ServerMetadata": ("unary", pb.ServerMetadataRequest, pb.ServerMetadataResponse),
    "ModelMetadata": ("unary", pb.ModelMetadataRequest, pb.ModelMetadataResponse),
    "ModelInfer": ("unary", pb.ModelInferRequest, pb.ModelInferResponse),
    "ModelStreamInfer": ("stream", pb.ModelInferRequest, pb.ModelStreamInferResponse),
    "ModelConfig": ("unary", pb.ModelConfigRequest, pb.ModelConfigResponse),
    "ModelStatistics": ("unary", pb.ModelStatisticsRequest, pb.ModelStatisticsResponse),
    "RepositoryIndex": ("unary", pb.RepositoryIndexRequest, pb.RepositoryIndexResponse),
    "RepositoryModelLoad": ("unary", pb.RepositoryModelLoadRequest, pb.RepositoryModelLoadResponse),
    "RepositoryModelUnload": ("unary", pb.RepositoryModelUnloadRequest, pb.RepositoryModelUnloadResponse),
    "SystemSharedMemoryStatus": ("unary", pb.SystemSharedMemoryStatusRequest, pb.SystemSharedMemoryStatusResponse),
    "SystemSharedMemoryRegister": ("unary", pb.SystemSharedMemoryRegisterRequest, pb.SystemSharedMemoryRegisterResponse),
    "SystemSharedMemoryUnregister": ("unary", pb.SystemSharedMemoryUnregisterRequest, pb.SystemSharedMemoryUnregisterResponse),
    "CudaSharedMemoryStatus": ("unary", pb.CudaSharedMemoryStatusRequest, pb.CudaSharedMemoryStatusResponse),
    "CudaSharedMemoryRegister": ("unary", pb.CudaSharedMemoryRegisterRequest, pb.CudaSharedMemoryRegisterResponse),
    "CudaSharedMemoryUnregister": ("unary", pb.CudaSharedMemoryUnregisterRequest, pb.CudaSharedMemoryUnregisterResponse),
    "TraceSetting": ("unary", pb.TraceSettingRequest, pb.TraceSettingResponse),
}


def method_path(name: str) -> str:
    return f"/{SERVICE}/{name}"


# gRPC channel options used by both sides: unbounded message sizes
# (INT32_MAX, as the reference sets them).
INT32_MAX = 2**31 - 1
DEFAULT_CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", INT32_MAX),
    ("grpc.max_receive_message_length", INT32_MAX),
]

# Client-channel-only additions, as the reference's: a large metadata
# limit for the trailers a server may send. Not in the shared list:
# raising the SERVER's limit would let any client send 16MB of request
# metadata per RPC.
CLIENT_CHANNEL_OPTIONS = DEFAULT_CHANNEL_OPTIONS + [
    ("grpc.max_metadata_size", 16 * 1024 * 1024),
]
