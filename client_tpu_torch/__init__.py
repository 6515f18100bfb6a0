"""client_tpu_torch — the PyTorch/CUDA port of ``client_tpu``.

The same KServe v2 serving stack as the JAX package, written on PyTorch
for an NVIDIA H100. Plain tensor code is PyTorch; each Pallas kernel of
the reference becomes a kernel written by hand for Hopper (CUDA C++
built with ``nvcc`` for ``sm_90a``, under ``ops/csrc/``).

The package imports ``torch``, numpy and the standard library only. It
never imports ``jax`` nor anything from ``client_tpu``: where it needs a
framework-free piece of the reference (the wire protocol, the request
types), it keeps its own copy.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU with ``device="cpu"``; without CUDA they raise instead of
moving to the CPU (``client_tpu_torch.device.resolve_device``).

Ported so far: the encoder serving slice (the protocol codec, the
dynamic batcher, the serving core and its HTTP front end, the forward
half of the transformer, the flash-attention kernel) and the core of the
generation slice (the continuous-batching engine over the paged KV pool,
token sampling, the decoupled serving path, the paged decode attention
kernel), the prefix cache, the shared-memory data planes, and the gRPC
front end with the streaming context (deadline, cancel Event, SLO labels).
The gRPC modules (``protocol.kserve_pb2``, ``protocol.grpc_defs``,
``protocol.grpc_tensors``, ``server.grpc_server``) also need ``grpcio``
and ``protobuf``; nothing else imports them.
"""

__version__ = "0.1.0"
