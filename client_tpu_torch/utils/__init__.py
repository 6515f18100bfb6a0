"""Shared client/server utilities: the exception clients raise.

The port's own copy of ``client_tpu/utils/__init__.py``'s
``InferenceServerException``, the name the perf analyzer imports.
"""

from __future__ import annotations


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
