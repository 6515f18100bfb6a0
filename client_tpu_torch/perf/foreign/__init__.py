"""Foreign-protocol perf backends: the port's ``client_tpu/perf/foreign``.

The perf analyzer's client-backend seam is service-agnostic; these
backends drive services that speak neither the v2 REST nor the v2 gRPC
protocol:

- ``tfserve``: TF-Serving ``PredictionService.Predict`` over gRPC (no
  streaming, no shared memory, no server-side statistics; the batch rides
  the leading tensor dimension). It needs grpcio and protobuf.
- ``torchserve``: the TorchServe inference API over HTTP, a multipart
  file upload to ``/predictions/{model}`` (Infer and client stats only;
  the single input holds a file path). The standard library only.

The reference's package imports both backends eagerly. This one exports
them lazily, on first access, so that ``torchserve`` loads on a host
without grpcio and protobuf.
"""

__all__ = ["TfServeBackend", "TorchServeBackend"]


def __getattr__(name):
    if name == "TfServeBackend":
        from client_tpu_torch.perf.foreign.tfserve import TfServeBackend

        return TfServeBackend
    if name == "TorchServeBackend":
        from client_tpu_torch.perf.foreign.torchserve import (
            TorchServeBackend,
        )

        return TorchServeBackend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
