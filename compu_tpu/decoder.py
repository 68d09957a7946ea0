"""Streaming decoder core: the type-erased driver over format pipelines.

Behavioral equivalent of the reference's ``Decoder`` + ``decoder::Interface``
(reference: src/decoder/mod.rs:160-455). The reference erases backend type
behind a 2-word ``{instance, &'static Interface}`` vtable pair; here the
``Interface`` is a registry of pipeline factories and ``Decoder`` is the
driver that owns one pipeline instance and exposes the convenience I/O
layer (``decode`` / ``decode_vec`` / ``decode_vec_full`` / ``decode_buf``,
reference: src/decoder/mod.rs:299-427).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from .status import Decode, DecodeError, DecodeStatus
from .vec import ByteVec
from .formats.base import DecoderBackend


class Decoder:
    """Owns one decode pipeline and drives it through the status contract."""

    __slots__ = ("_backend",)

    def __init__(self, backend: DecoderBackend) -> None:
        self._backend = backend

    @property
    def name(self) -> str:
        return self._backend.name

    # -- raw layer (reference: raw_decode / decode, decoder/mod.rs:290-321) --
    def decode(self, inp, out) -> Decode:
        """Decode ``inp`` into the writable buffer ``out``.

        Never allocates output: only the provided buffer is written.
        Returns byte counts left in each buffer plus the status.
        """
        return self._backend.decode(inp, out)

    # -- convenience layer ---------------------------------------------------
    def decode_vec(self, inp, vec: ByteVec) -> Decode:
        """Decode into ``vec``'s spare capacity, advancing its length
        (reference: decode_vec, decoder/mod.rs:323-335)."""
        spare = vec.spare_capacity_mut()
        result = self.decode(inp, spare)
        vec.add_len(len(spare) - result.output_remain)
        return result

    def decode_vec_full(self, inp, vec: ByteVec) -> Decode:
        """Decode a complete stream, growing ``vec`` as needed with the
        reference's size-tiered allocation strategy
        (reference: decode_vec_full, decoder/mod.rs:360-385)."""
        size = len(inp)
        if size < 1024:
            vec.reserve_exact(size if size > 0 else 64)
        elif size < 16_384:
            vec.reserve_exact(size + size // 3)
        elif size < 65_536:
            vec.reserve_exact(size + size // 2)
        else:
            vec.reserve_exact(2 * size)
        inp = memoryview(inp)
        while True:
            result = self.decode_vec(inp, vec)
            if result.is_error or result.status is not DecodeStatus.NeedOutput:
                return result
            inp = inp[len(inp) - result.input_remain :]
            vec.reserve_exact(1024 if len(vec) < 65_536 else 8192)

    def decode_buf(self, inp, out_buf) -> Decode:
        """Decode into a ``bytes::BufMut``-style sink (reference:
        decode_buf, decoder/mod.rs:394-427). Sinks exposing
        ``chunk_mut()``/``advance_mut()`` (e.g. ``ChunkedSink``) are written
        in place, chunk by chunk — no staging copy; plain ``bytearray``
        sinks fall back to append-a-chunk."""
        inp = memoryview(inp)
        lending = hasattr(out_buf, "chunk_mut") and hasattr(out_buf, "advance_mut")
        staged = None if lending else bytearray(65_536)
        while True:
            chunk = out_buf.chunk_mut() if lending else staged
            result = self.decode(inp, chunk)
            produced = len(chunk) - result.output_remain
            if lending:
                out_buf.advance_mut(produced)
            else:
                out_buf.extend(chunk[:produced])
            if result.is_error or result.status is not DecodeStatus.NeedOutput:
                return Decode(result.input_remain, result.output_remain, result.status)
            inp = inp[len(inp) - result.input_remain :]

    def reset(self) -> bool:
        """Re-arm for a new stream without losing options
        (reference: decoder/mod.rs:433-441)."""
        return self._backend.reset()

    def describe_error(self, error) -> Optional[str]:
        code = error.code if isinstance(error, DecodeError) else int(error)
        return self._backend.describe_error(code)


class Interface:
    """Registry of decode pipeline factories + per-format constructors
    (the reference's ``decoder::Interface`` vtable constructors,
    e.g. ``Interface::zstd``, src/decoder/zstd.rs:81-94)."""

    _registry: Dict[str, Callable[..., DecoderBackend]] = {}

    @classmethod
    def register(cls, name: str, factory: Callable[..., DecoderBackend]) -> None:
        cls._registry[name] = factory

    @classmethod
    def new(cls, name: str, *args, **kwargs) -> Decoder:
        try:
            factory = cls._registry[name]
        except KeyError:
            raise ValueError(f"unknown decoder backend: {name!r}") from None
        return Decoder(factory(*args, **kwargs))

    # -- convenience constructors -------------------------------------------
    @staticmethod
    def stored() -> Decoder:
        from .formats import stored

        return Decoder(stored.StoredDecoder())

    @staticmethod
    def zlib(options=None) -> Decoder:
        from .formats.deflate import pipeline

        return Decoder(pipeline.DeflateDecoder(options))

    @staticmethod
    def zlib_native(options=None) -> Decoder:
        """Same format, native C++ deflate hot loop — the zlib-ng analogue
        of the multi-backend pattern (reference: Interface::zlib_ng,
        src/decoder/zlib_ng.rs:61-91). Raises if the native runtime is
        unavailable (mirroring the reference's None on init failure)."""
        from .formats.deflate import pipeline

        return Decoder(pipeline.NativeDeflateDecoder(options))

    @staticmethod
    def zlib_device(options=None) -> Decoder:
        """Same format, device speculative-resync inflate — the third full
        decode implementation behind one Interface (reference pattern:
        Interface::zlib_rust, src/decoder/zlib_rust.rs:87-101). Decodes
        arbitrary FOREIGN streams on device (48-entry-phase chunk scan +
        stream-global back-reference resolution); see
        formats/deflate/device_inflate.py and docs/DEVICE_DECODE.md."""
        from .formats.deflate import device_inflate

        return Decoder(device_inflate.DeviceDeflateDecoder(options))

    @staticmethod
    def zstd(options=None) -> Decoder:
        from .formats.zstd import pipeline

        return Decoder(pipeline.ZstdDecoder(options))

    @staticmethod
    def zstd_native(options=None) -> Decoder:
        """Same format, native C++ frame decoder — the libzstd-speed host
        path behind the same Interface (reference: Interface::zstd reaching
        ZSTD_decompressStream, src/decoder/zstd.rs:81-136). Raises if the
        native runtime is unavailable."""
        from .formats.zstd import pipeline

        return Decoder(pipeline.NativeZstdDecoder(options))

    @staticmethod
    def brotli(options=None) -> Decoder:
        from .formats.brotli import pipeline

        return Decoder(pipeline.BrotliDecoder(options))

    @staticmethod
    def brotli_native(options=None) -> Decoder:
        """Same format, native C++ meta-block decoder — the second brotli
        implementation behind one Interface (reference pattern: brotli-C vs
        rust-brotli, src/decoder/brotli_c.rs:22-28 vs brotli.rs:20-26).
        Raises if the native runtime is unavailable."""
        from .formats.brotli import pipeline

        return Decoder(pipeline.NativeBrotliDecoder(options))
