"""Shared client/server utilities: the exception clients raise and the
dtype and serialization helpers, under the reference's names
(``np_to_triton_dtype``, ``triton_to_np_dtype``,
``serialize_byte_tensor``, ``deserialize_bytes_tensor``) and the
package's own.

The port's own copy of ``client_tpu/utils/__init__.py``, on the port's
``protocol`` copies.
"""

from __future__ import annotations

from client_tpu_torch.protocol.binary import (  # noqa: F401
    deserialize_bytes_tensor,
    serialize_byte_tensor,
    serialized_byte_size,
)
from client_tpu_torch.protocol.dtypes import (  # noqa: F401
    DataType,
    np_to_wire_dtype,
    wire_to_np_dtype,
)

# the tritonclient.utils names
np_to_triton_dtype = np_to_wire_dtype
triton_to_np_dtype = wire_to_np_dtype


class InferenceServerException(Exception):
    """Error raised by clients; carries optional status and debug details."""

    def __init__(self, msg, status=None, debug_details=None):
        self._msg = msg
        self._status = status
        self._debug_details = debug_details
        super().__init__(msg)

    def __str__(self):
        msg = super().__str__() if self._msg is None else str(self._msg)
        if self._status is not None:
            return f"[{self._status}] {msg}"
        return msg

    def message(self):
        return self._msg

    def status(self):
        return self._status

    def debug_details(self):
        return self._debug_details


def raise_error(msg):
    raise InferenceServerException(msg=msg) from None
