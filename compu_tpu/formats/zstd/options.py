"""zstd option surface, mirroring the reference's option structs
(encoder: src/encoder/zstd.rs:35-133; decoder: src/decoder/zstd.rs:22-74).
"""

from __future__ import annotations

import dataclasses
import enum


class ZstdStrategy(enum.Enum):
    """Compression strategy ladder (reference: src/encoder/zstd.rs:35-56).

    A non-default strategy *overrides* the parse effort the level implies
    (libzstd's ``ZSTD_c_strategy`` semantics, applied by the reference at
    src/encoder/zstd.rs:121): Fast/DFast/Greedy select the greedy chain
    walk at increasing depth, Lazy/Lazy2 the lazy heuristic, BtLazy2 a deep
    lazy walk, and BtOpt/BtUltra/BtUltra2 the cost-model optimal parse at
    increasing depth/candidate budgets. The level keeps governing entropy
    and window behavior."""

    Default = 0
    Fast = 1
    DFast = 2
    Greedy = 3
    Lazy = 4
    Lazy2 = 5
    BtLazy2 = 6
    BtOpt = 7
    BtUltra = 8
    BtUltra2 = 9


@dataclasses.dataclass(frozen=True)
class ZstdOptions:
    """Encoder options (reference: ZstdOptions, src/encoder/zstd.rs:62-133).

    ``level`` follows zstd's ladder: 1..22 standard levels, 0 means the
    default (3), and negative levels down to -131072 select the fast path
    (greedy block-local parse — all negative levels share our fastest
    ladder rung; the reference forwards the raw value to libzstd,
    src/encoder/zstd.rs:81-93).
    ``window_log`` bounds match distances (10..31);
    ``checksum`` controls the xxhash64 content checksum (the reference
    relies on libzstd's default off; ours defaults on — flip for byte
    parity scenarios).
    """

    level: int = 3
    strategy: ZstdStrategy = ZstdStrategy.Default
    window_log: int = 17
    checksum: bool = True
    #: Run the LZ match+parse stage on the device (shared v2 kernel),
    #: keeping FSE/Huffman entropy coding on the host.
    device_lz: bool = False
    #: Encode the 4-stream Huffman literals section on the device
    #: (byte-identical output; kernels/zstd_literals_jax.py).
    device_literals: bool = False
    #: Encode the FSE sequence bitstream on the device (byte-identical
    #: output; kernels/zstd_seq_jax.py) — with device_lz and
    #: device_literals this completes the device zstd block-entropy path.
    device_sequences: bool = False

    def __post_init__(self) -> None:
        if not -131072 <= self.level <= 22:  # ZSTD_minCLevel()..ZSTD_maxCLevel()
            raise ValueError("zstd level must be in -131072..22")
        if not 10 <= self.window_log <= 31:
            raise ValueError("window_log must be in 10..31")


@dataclasses.dataclass(frozen=True)
class ZstdDecodeOptions:
    """Decoder options (reference: src/decoder/zstd.rs:22-74 — the
    window_log cap is the only knob; device_literals additionally decodes
    4-stream Huffman literal sections on the device,
    kernels/zstd_lit_decode_jax.py)."""

    window_log_max: int = 31
    device_literals: bool = False

    def __post_init__(self) -> None:
        if not 10 <= self.window_log_max <= 31:
            raise ValueError("window_log_max must be in 10..31")
