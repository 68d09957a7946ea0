"""Seeded Silesia-like test corpus: a third mutated text, a third
repetitive JSON records, a sixth low-entropy bytes and a sixth noise.
Deterministic for a given (total, seed)."""

from __future__ import annotations

import pathlib

import numpy as np

ALICE = pathlib.Path(__file__).resolve().parents[2] / "tests" / "data" / "alice29.txt"


def build_corpus(total: int = 16 << 20, seed: int = 1234) -> bytes:
    """``total`` bytes of text, structured records and binary data."""
    rng = np.random.default_rng(seed)
    pieces = []
    size = 0
    text = ALICE.read_bytes()
    # text with small mutations (so blocks differ)
    while size < total // 3:
        t = bytearray(text)
        for _ in range(32):
            t[int(rng.integers(0, len(t)))] = int(rng.integers(32, 127))
        pieces.append(bytes(t))
        size += len(t)
    # structured: repetitive records with counters
    rec = b"".join(
        b'{"id": %08d, "name": "item-%d", "flags": [1,2,3]}\n' % (i, i % 977)
        for i in range(20000)
    )
    while size < 2 * total // 3:
        pieces.append(rec)
        size += len(rec)
    # binary: low-entropy bytes + some noise
    pieces.append(rng.integers(0, 16, total // 6, dtype=np.uint8).tobytes())
    pieces.append(rng.integers(0, 256, total // 6, dtype=np.uint8).tobytes())
    return b"".join(pieces)[:total]
