"""Shared perf-harness utilities: the port's copy of
``client_tpu/perf/perf_utils.py``.

The process-wide ``early_exit`` flag that SIGINT sets, so a run in
progress can drain live sequences and still report the data it
collected, and the classifier of admission-control sheds.
"""

from __future__ import annotations

import signal
import threading

# Set by the first Ctrl-C. Worker loops stop issuing, drain live
# sequences, and the profiler returns what it has measured so far.
early_exit = threading.Event()


def install_sigint_handler():
    """First SIGINT: graceful drain + partial report. Second: default
    (immediate exit) — same escalation as the reference CLI. A no-op when
    called from a non-main thread (embedded use), where Python forbids
    installing signal handlers. Returns a zero-arg restore function so an
    embedding caller gets its own handler back after the run."""

    def handler(signum, frame):  # noqa: ARG001
        early_exit.set()
        print("\n[perf] SIGINT — draining in-flight work; "
              "Ctrl-C again to abort without a report", flush=True)
        signal.signal(signal.SIGINT, signal.default_int_handler)

    try:
        previous = signal.signal(signal.SIGINT, handler)
    except ValueError:  # not the main thread
        return lambda: None

    def restore():
        try:
            if signal.getsignal(signal.SIGINT) is handler:
                signal.signal(signal.SIGINT, previous)
        except ValueError:
            pass

    return restore


def is_admission_rejection(error) -> bool:
    """True when ``error`` is a server admission-control shed (503 /
    UNAVAILABLE / queue rejection) rather than a real failure.

    Sheds are an intended response to overload — the load generator
    must count them and keep driving, not kill its worker: past the
    saturation knee the whole point of the measurement is how the
    server holds up WHILE shedding (the rejected count rides the
    server's v2 statistics).
    """
    # match ONLY the server's explicit shed messages (scheduler._shed /
    # queue-timeout wording, preserved verbatim over both the HTTP 503
    # and the gRPC UNAVAILABLE mappings). Matching on the bare status
    # code would also swallow fatal conditions that reuse it —
    # connection-refused UNAVAILABLE, a stopped generation engine's
    # 503 — and the load workers would then drive a dead server
    # forever instead of surfacing the failure.
    text = str(error)
    return ("request was rejected" in text
            or "exceeds maximum queue size" in text
            or "timed out in queue" in text)
