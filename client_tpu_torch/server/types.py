"""Internal request/response messages shared by the server's front ends.

The port's counterpart of ``client_tpu/server/types.py``: transports
convert wire formats to these; the core and the schedulers only ever see
these types. The front ends parse the multi-tenant SLO labels
(``tenant_id``, ``slo_class``) as the reference does, and the scheduler
hands them, the wire ``timeout`` as a deadline and the ``cancel_event``
to a decoupled model's stream (``server/model.py:StreamContext``); the
SLO scheduler reads the labels. A request carries the caller's
propagated trace id, the core's sampled trace, the stateful-sequence
controls (the sequence scheduler reads them) and, for an ensemble's
step, its parent's trace.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

# tenant / SLO-class wire identifiers: label-safe and bounded, starting
# with an alphanumeric ("__other__" and the like stay the server's own);
# the reference's ``TENANT_ID_RE``, ``DEFAULT_TENANT`` and
# ``DEFAULT_SLO_CLASS``
TENANT_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._:-]{0,63}$")
DEFAULT_TENANT = "default"
DEFAULT_SLO_CLASS = "best_effort"


def now_ns() -> int:
    return time.monotonic_ns()


def parse_int_param(params: dict, key: str, default: int = 0,
                    minimum: int = 0) -> int:
    """Pop an integer request parameter (``priority``/``timeout``),
    accepting int or decimal-string forms. A malformed value is a clear
    400, never an unhandled ValueError surfacing as a 500."""
    raw = params.pop(key, None)
    if raw is None or raw == "":
        return default
    if isinstance(raw, bool) or not isinstance(raw, (int, str)):
        raise ServerError(
            f"request parameter '{key}' must be an integer, got "
            f"{type(raw).__name__} {raw!r}", 400)
    try:
        value = int(raw)
    except ValueError:
        raise ServerError(
            f"request parameter '{key}' must be an integer, got "
            f"{raw!r}", 400) from None
    if value < minimum:
        raise ServerError(
            f"request parameter '{key}' must be >= {minimum}, got "
            f"{value}", 400)
    return value


def parse_label_param(params: dict, key: str, default: str) -> str:
    """Pop a ``tenant_id`` / ``slo_class`` request parameter: a string
    matching ``TENANT_ID_RE`` (1-64 characters of [A-Za-z0-9._:-],
    starting with an alphanumeric). A malformed value is a clear 400."""
    raw = params.pop(key, None)
    if raw is None or raw == "":
        return default
    if not isinstance(raw, str) or not TENANT_ID_RE.match(raw):
        raise ServerError(
            f"request parameter '{key}' must be 1-64 characters of "
            f"[A-Za-z0-9._:-] starting with an alphanumeric, got "
            f"{raw!r}", 400)
    return raw


@dataclass
class InferTensor:
    """One named tensor: host data, a shm reference, or a device tensor."""

    name: str
    datatype: str = ""
    shape: tuple = ()
    data: Optional[np.ndarray] = None      # host-resident payload
    device_array: Any = None               # torch.Tensor (in-process callers)
    shm_region: Optional[str] = None
    shm_offset: int = 0
    shm_byte_size: int = 0
    parameters: dict = field(default_factory=dict)

    def batch_size(self) -> int:
        return int(self.shape[0]) if self.shape else 1


@dataclass
class RequestedOutput:
    name: str
    binary_data: bool = True
    classification_count: int = 0
    shm_region: Optional[str] = None
    shm_offset: int = 0
    shm_byte_size: int = 0
    parameters: dict = field(default_factory=dict)


@dataclass
class InferRequest:
    model_name: str
    model_version: str = ""
    id: str = ""
    inputs: list = field(default_factory=list)          # [InferTensor]
    outputs: list = field(default_factory=list)         # [RequestedOutput]
    parameters: dict = field(default_factory=dict)
    priority: int = 0
    timeout_us: int = 0
    # multi-tenant SLO attribution, validated by the front ends
    tenant_id: str = DEFAULT_TENANT
    slo_class: str = DEFAULT_SLO_CLASS
    # stateful-sequence controls: an int or str correlation id (0 or ""
    # for none) and the START / END flags
    sequence_id: Any = 0
    sequence_start: bool = False
    sequence_end: bool = False
    # bookkeeping (filled by the core)
    arrival_ns: int = 0
    # tracing: trace_id is the caller's propagated id (the HTTP
    # triton-trace-id header, the gRPC triton_trace_id parameter);
    # trace_parent links an ensemble's step to its parent's trace; trace
    # is the sampled Trace the core set (the front ends echo its id)
    trace_id: str = ""
    trace_parent: Any = None
    trace: Any = None
    # client-cancellation signal (a threading.Event or None): a front end
    # that sees the caller go away (the gRPC context callback) sets it, so
    # a decoupled stream frees its engine slot and prefix pins instead of
    # decoding to its budget for nobody
    cancel_event: Any = None

    def has_sequence(self) -> bool:
        return bool(self.sequence_id)


@dataclass
class InferResponse:
    model_name: str = ""
    model_version: str = ""
    id: str = ""
    outputs: list = field(default_factory=list)         # [InferTensor]
    parameters: dict = field(default_factory=dict)
    error: Optional[str] = None
    error_status: int = 400
    # retryable-error hint (seconds): set on 503 sheds so the front end
    # can surface Retry-After
    retry_after_s: Optional[float] = None

    def output(self, name: str) -> Optional[InferTensor]:
        for t in self.outputs:
            if t.name == name:
                return t
        return None


class ServerError(Exception):
    """Server-side error with an HTTP-ish status code; ``retry_after``
    (seconds) marks a retryable failure (admission-control sheds)."""

    def __init__(self, msg: str, status: int = 400,
                 retry_after: Optional[float] = None):
        super().__init__(msg)
        self.status = status
        self.retry_after = retry_after
