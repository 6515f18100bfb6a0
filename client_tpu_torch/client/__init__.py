"""Client-side API: the HTTP and gRPC InferenceServerClients of the port
(its copy of ``client_tpu/client``).

Import the transport you need:

    from client_tpu_torch.client import http as httpclient
    from client_tpu_torch.client import grpc as grpcclient

mirroring ``tritonclient.http`` / ``tritonclient.grpc``. The gRPC client
needs ``grpcio`` and ``protobuf``; the HTTP client needs neither.
"""
