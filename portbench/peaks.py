"""Published peaks of the cards the benchmark reports against.

Frozen copy of ``CARD_PEAKS`` from ``client_tpu_torch/perf/bench_harness.py``
(NVIDIA data sheets, SXM parts: memory bytes/s, dense bf16 tensor-core
FLOP/s, by a substring of the card's name). Rooflines and MFU are taken
against these, with the card's power limit reported beside them.
"""

from __future__ import annotations

CARD_PEAKS = (
    ("H200", 4.8e12, 989e12),
    ("H100", 3.35e12, 989e12),
)


def card_peaks(name: str):
    """(memory bytes/s, dense bf16 FLOP/s) of a card by its name, or None
    for a card without published peaks here."""
    for key, bw, bf16 in CARD_PEAKS:
        if key in name:
            return bw, bf16
    return None
