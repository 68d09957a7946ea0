"""Streaming encoder core: the type-erased driver over format pipelines.

Behavioral equivalent of the reference's ``Encoder`` + ``encoder::Interface``
(reference: src/encoder/mod.rs:52-330). Exposes the 3-op protocol
(Process/Flush/Finish) and the convenience I/O layer (``encode`` /
``encode_vec`` / ``encode_vec_full`` / ``encode_buf``,
reference: src/encoder/mod.rs:179-308). The encoder retains its construction
options across ``reset()`` (the reference stores them in a 2-byte opts
payload, src/encoder/mod.rs:148-156; here the pipeline object keeps its
options dataclass).
"""

from __future__ import annotations

from typing import Callable, Dict

from .status import Encode, EncodeOp, EncodeStatus
from .vec import ByteVec
from .formats.base import EncoderBackend


class Encoder:
    """Owns one encode pipeline and drives it through the op/status contract."""

    __slots__ = ("_backend",)

    def __init__(self, backend: EncoderBackend) -> None:
        self._backend = backend

    @property
    def name(self) -> str:
        return self._backend.name

    # -- raw layer (reference: raw_encode / encode, encoder/mod.rs:171-201) --
    def encode(self, inp, out, op: EncodeOp) -> Encode:
        """Encode ``inp`` into the writable buffer ``out`` under ``op``.

        Never allocates output: only the provided buffer is written.
        """
        return self._backend.encode(inp, out, op)

    # -- convenience layer ---------------------------------------------------
    def encode_vec(self, inp, vec: ByteVec, op: EncodeOp) -> Encode:
        """Encode into ``vec``'s spare capacity, advancing its length
        (reference: encode_vec, encoder/mod.rs:203-213)."""
        spare = vec.spare_capacity_mut()
        result = self.encode(inp, spare, op)
        vec.add_len(len(spare) - result.output_remain)
        return result

    def encode_vec_full(self, inp, vec: ByteVec, op: EncodeOp) -> Encode:
        """Encode a complete input, growing ``vec`` as needed with the
        reference's size-tiered strategy (reference: encode_vec_full,
        encoder/mod.rs:238-267 — compressed output tiers are divisors of the
        input size since compression usually shrinks)."""
        size = len(inp)
        if size < 1024:
            vec.reserve_exact(max(64, size + 64))
        elif size < 65_536:
            vec.reserve_exact(size // 2 + 128)
        else:
            vec.reserve_exact(size // 3 + 256)
        inp = memoryview(inp)
        while True:
            result = self.encode_vec(inp, vec, op)
            if result.status is not EncodeStatus.NeedOutput:
                return result
            inp = inp[len(inp) - result.input_remain :]
            vec.reserve_exact(1024 if len(vec) < 65_536 else 8192)

    def encode_buf(self, inp, out_buf, op: EncodeOp) -> Encode:
        """Encode into a ``bytes::BufMut``-style sink (reference:
        encode_buf, encoder/mod.rs:276-308). Sinks exposing
        ``chunk_mut()``/``advance_mut()`` (e.g. ``ChunkedSink``) are written
        in place, chunk by chunk — no staging copy; plain ``bytearray``
        sinks fall back to append-a-chunk."""
        inp = memoryview(inp)
        lending = hasattr(out_buf, "chunk_mut") and hasattr(out_buf, "advance_mut")
        staged = None if lending else bytearray(65_536)
        while True:
            chunk = out_buf.chunk_mut() if lending else staged
            result = self.encode(inp, chunk, op)
            produced = len(chunk) - result.output_remain
            if lending:
                out_buf.advance_mut(produced)
            else:
                out_buf.extend(chunk[:produced])
            if result.status is not EncodeStatus.NeedOutput:
                return Encode(result.input_remain, result.output_remain, result.status)
            inp = inp[len(inp) - result.input_remain :]

    def reset(self) -> bool:
        """Re-arm for a new stream, re-applying construction options
        (reference: encoder/mod.rs:314-322)."""
        return self._backend.reset()


class Interface:
    """Registry of encode pipeline factories + per-format constructors
    (the reference's ``encoder::Interface`` constructors,
    e.g. ``Interface::zstd``, src/encoder/zstd.rs:140-153)."""

    _registry: Dict[str, Callable[..., EncoderBackend]] = {}

    @classmethod
    def register(cls, name: str, factory: Callable[..., EncoderBackend]) -> None:
        cls._registry[name] = factory

    @classmethod
    def new(cls, name: str, *args, **kwargs) -> Encoder:
        try:
            factory = cls._registry[name]
        except KeyError:
            raise ValueError(f"unknown encoder backend: {name!r}") from None
        return Encoder(factory(*args, **kwargs))

    # -- convenience constructors -------------------------------------------
    @staticmethod
    def stored() -> Encoder:
        from .formats import stored

        return Encoder(stored.StoredEncoder())

    @staticmethod
    def zlib(options=None) -> Encoder:
        from .formats.deflate import pipeline

        return Encoder(pipeline.DeflateEncoder(options))

    @staticmethod
    def zlib_native(options=None) -> Encoder:
        """Same format, native C++ deflate hot loop — the encoder half of
        the zlib-ng analogue (reference: Interface::zlib_ng,
        src/encoder/zlib_ng.rs:50-87). Raises if the native runtime is
        unavailable (the reference returns None on init failure)."""
        from .formats.deflate import pipeline

        return Encoder(pipeline.NativeDeflateEncoder(options))

    @staticmethod
    def zlib_device(options=None, block_size=None) -> Encoder:
        """Device implementation of the same deflate format — the
        multi-backend pattern (reference: Interface::zlib_ng,
        src/encoder/zlib_ng.rs:50-87, a second impl of one format behind
        one vtable). Each 256 KiB pipeline block runs the v3 device kernel;
        the streaming state machine, framing, and chunked==one-shot
        invariant are identical to Interface.zlib()."""
        from .formats.deflate import pipeline

        return Encoder(pipeline.DeviceDeflateEncoder(options, block_size=block_size))

    @staticmethod
    def zstd_native(options=None) -> Encoder:
        """Second complete zstd encoder implementation (standalone C++:
        csrc/compu_zstd_enc2.cpp) behind the same Interface — the
        multi-implementation pattern applied to zstd encode. Raises if
        the native runtime is unavailable."""
        from .formats.zstd import pipeline

        return Encoder(pipeline.NativeZstdEncoder(options))

    @staticmethod
    def zstd(options=None) -> Encoder:
        from .formats.zstd import pipeline

        return Encoder(pipeline.ZstdEncoder(options))

    @staticmethod
    def brotli_native(options=None) -> Encoder:
        """Second complete brotli encoder implementation (standalone C++:
        csrc/compu_brotli_enc2.cpp) behind the same Interface — the
        reference's dual-brotli-encoder pattern
        (src/encoder/brotli_c.rs:42-50 vs src/encoder/brotli.rs:22-29).
        Raises if the native runtime is unavailable."""
        from .formats.brotli import pipeline

        return Encoder(pipeline.NativeBrotliEncoder(options))

    @staticmethod
    def brotli(options=None) -> Encoder:
        from .formats.brotli import pipeline

        return Encoder(pipeline.BrotliEncoder(options))
