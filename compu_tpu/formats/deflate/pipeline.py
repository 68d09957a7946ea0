"""DEFLATE format pipeline: framing + streaming backend glue.

Plays the role of the reference's zlib adapter pair
(src/encoder/zlib.rs:50-111, src/decoder/zlib.rs:59-126): maps the generic
Encoder/Decoder contract onto the deflate core, emitting/validating
zlib (RFC1950), gzip (RFC1952) or raw framing with rolling adler32/crc32.
"""

from __future__ import annotations

import struct

from ...ops import checksum
from ...status import DecodeStatus
from ..base import CodecFailure, DecoderBackend, EncoderBackend
from .deflate_encode import DeflateStream
from .inflate import ERRORS, Inflate
from .options import ZlibDecodeOptions, ZlibMode, ZlibOptions


class DeflateEncoder(EncoderBackend):
    """Streaming deflate/zlib/gzip encoder backend.

    Matches never cross the 1 MiB pipeline block boundary (window reset per
    block), making self-produced streams block-parallel decodable; the
    format stays fully RFC-compliant for any inflate.
    """

    name = "zlib"
    block_size = 1 << 20

    def __init__(self, options: ZlibOptions | None = None) -> None:
        self.options = options or ZlibOptions()
        super().__init__()
        self._stream = DeflateStream(
            self.options.level, self.options.strategy,
            mem_level=self.options.mem_level,
        )
        self._init_checksums()

    def _init_checksums(self) -> None:
        self._adler = 1
        self._crc = 0
        self._isize = 0

    def _header(self) -> bytes:
        mode = self.options.mode
        if mode is ZlibMode.Zlib:
            cmf = 0x78  # method 8, 32 KiB window
            flevel = (0, 0, 0, 1, 1, 1, 2, 2, 3, 3)[self.options.level]
            flg = flevel << 6
            fcheck = (31 - ((cmf << 8 | flg) % 31)) % 31
            return bytes([cmf, flg | fcheck])
        if mode is ZlibMode.Gzip:
            xfl = 2 if self.options.level >= 9 else (4 if self.options.level <= 2 else 0)
            # mtime 0 keeps chunked == one-shot deterministic.
            return struct.pack("<BBBBIBB", 0x1F, 0x8B, 8, 0, 0, xfl, 255)
        return b""

    def _compress(self, data: bytes, final: bool) -> bytes:
        mode = self.options.mode
        if mode is ZlibMode.Zlib:
            self._adler = checksum.adler32(data, self._adler)
        elif mode is ZlibMode.Gzip:
            self._crc = checksum.crc32(data, self._crc)
            self._isize += len(data)
        return self._stream.compress(data, final)

    def _flush_mark(self) -> bytes:
        return self._stream.sync_flush()

    def _trailer(self) -> bytes:
        out = bytearray(self._stream.align())
        mode = self.options.mode
        if mode is ZlibMode.Zlib:
            out.extend(struct.pack(">I", self._adler))
        elif mode is ZlibMode.Gzip:
            out.extend(struct.pack("<II", self._crc, self._isize & 0xFFFFFFFF))
        return bytes(out)

    def _do_reset(self) -> None:
        self._stream.reset()
        self._init_checksums()


class _DeviceDeflateStream:
    """Deflate core on the device: each pipeline block runs the v3 device
    kernel (dynamic Huffman / fixed / stored by cost), producing a
    self-contained byte-aligned raw-deflate run ending in a sync flush —
    so chunk outputs concatenate into one standard stream. Exposes the
    same compress/sync_flush/align/reset surface as the host
    DeflateStream."""

    def __init__(self, level: int, block_size: int) -> None:
        self.level = level
        self.block_size = block_size

    def reset(self) -> None:
        pass  # stateless between blocks (window resets per block)

    def compress(self, chunk: bytes, final: bool) -> bytes:
        import numpy as np

        out = b""
        if chunk:
            import jax.numpy as jnp

            from ...kernels.block_codec import _LEVEL
            from ...kernels.deflate_jax_v3 import encode_block_dyn

            depth = min(_LEVEL[max(1, min(9, self.level))][0], 8)
            arr = np.zeros(self.block_size, dtype=np.uint8)
            arr[: len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
            blob, meta = encode_block_dyn(
                jnp.asarray(arr), jnp.int32(len(chunk)), depth=depth
            )
            out = np.asarray(blob)[: int(np.asarray(meta)[0])].tobytes()
        if final:
            # Terminate the stream: final empty stored block.
            out += bytes([0x01, 0x00, 0x00, 0xFF, 0xFF])
        return out

    def sync_flush(self) -> bytes:
        return b""  # every device block already ends byte-aligned at a flush

    def align(self) -> bytes:
        return b""


class _NativeDeflateStream:
    """Deflate core in C++ (csrc/compu_deflate.cpp): hash-chain lazy
    matching + dynamic/fixed/stored blocks with RLE headers. Same
    compress/sync_flush/align/reset surface as the Python DeflateStream;
    bit state carries across chunks inside the native handle so chunked ==
    one-shot output holds."""

    def __init__(self, level: int, mem_level: int = 8) -> None:
        import ctypes

        from ...runtime import native

        self._ctypes = ctypes
        self._lib = native._load()
        if self._lib is None or not hasattr(self._lib, "compu_deflate_new"):
            raise RuntimeError("native deflate unavailable")
        self.level = max(1, min(9, level))
        self._handle = self._lib.compu_deflate_new(self.level)
        if mem_level != 8:
            self._lib.compu_deflate_set_hash_bits(self._handle, mem_level + 8)
        self._mem_level = mem_level

    def __del__(self):  # pragma: no cover - lifecycle
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_handle", None)
        if lib is not None and h:
            lib.compu_deflate_free(h)
            self._handle = None

    def reset(self) -> None:
        self._lib.compu_deflate_reset(self._handle)
        if self._mem_level != 8:
            self._lib.compu_deflate_set_hash_bits(self._handle, self._mem_level + 8)

    def _run(self, chunk: bytes, flush: int, final: int) -> bytes:
        ctypes = self._ctypes
        cap = len(chunk) + len(chunk) // 2 + 4096
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.compu_deflate_run(
            self._handle, chunk, len(chunk), buf, cap, flush, final
        )
        return buf.raw[:n]

    def compress(self, chunk: bytes, final: bool) -> bytes:
        return self._run(chunk, 0, 1 if final else 0)

    def sync_flush(self) -> bytes:
        return self._run(b"", 1, 0)

    def align(self) -> bytes:
        return b""  # final=1 already byte-aligned the stream


class NativeDeflateEncoder(DeflateEncoder):
    """Same format, native (C++) deflate hot loop — the encoder half of the
    zlib-ng multi-backend analogue (reference: Interface::zlib_ng,
    src/encoder/zlib_ng.rs:50-87). Framing + checksums stay in Python."""

    name = "zlib-native"

    def __init__(self, options: ZlibOptions | None = None) -> None:
        self.options = options or ZlibOptions()
        EncoderBackend.__init__(self)
        if self.options.level == 0:
            # level 0 = stored-only; the Python core implements it directly
            self._stream = DeflateStream(0, self.options.strategy)
        else:
            self._stream = _NativeDeflateStream(
                self.options.level, self.options.mem_level
            )
        self._init_checksums()


class DeviceDeflateEncoder(DeflateEncoder):
    """Device-backed deflate encoder behind the SAME product Interface and
    state machine as the host backend (the multi-backend vtable pattern:
    reference src/encoder/zlib.rs vs zlib_ng.rs — here host vs device
    implementations of one format). Chunked == one-shot holds because
    block boundaries depend only on absolute stream offsets."""

    name = "zlib-device"
    block_size = 1 << 18  # one v3 kernel invocation per block

    def __init__(self, options: ZlibOptions | None = None,
                 block_size: int | None = None) -> None:
        if block_size is not None:
            self.block_size = block_size
        super().__init__(options)
        self._stream = _DeviceDeflateStream(self.options.level, self.block_size)


class DeflateDecoder(DecoderBackend):
    """Streaming inflate backend accepting foreign streams bit-exactly."""

    name = "zlib"
    ERRORS = ERRORS

    def __init__(self, options: ZlibDecodeOptions | ZlibMode | None = None) -> None:
        if options is None:
            options = ZlibDecodeOptions()
        if isinstance(options, ZlibMode):
            options = ZlibDecodeOptions(mode=options)
        self.options = options
        super().__init__()
        self._inflate = Inflate(self.options.mode)
        self._inflate.sink_budget = self.pending_high_water

    def _pump(self) -> None:
        try:
            consumed, finished = self._inflate.pump(self._staged, self._staged_pos)
        except CodecFailure:
            raise
        if self._inflate.sink:
            self._pending.extend(self._inflate.sink)
            self._inflate.sink = bytearray()
        self._staged_pos = consumed
        if finished:
            self._finished = True

    def _rebase_input(self, nbytes: int) -> None:
        # The inflate core keeps an absolute bit cursor into the staged
        # buffer; shift it when the backend drops the consumed prefix.
        self._inflate.bitpos -= 8 * nbytes

    def _do_reset(self) -> None:
        self._inflate = Inflate(self.options.mode)
        self._inflate.sink_budget = self.pending_high_water


class NativeDeflateDecoder(DeflateDecoder):
    """Same format, native (C++) deflate hot loop — the framework's zlib-ng
    analogue: a second implementation of one format behind the same
    Interface (reference pattern: src/decoder/zlib.rs vs zlib_ng.rs).
    Framing + checksums stay in Python (formats/deflate/native_inflate.py);
    raw deflate blocks decode in csrc/compu_inflate.cpp."""

    name = "zlib-native"

    def __init__(self, options: ZlibDecodeOptions | ZlibMode | None = None) -> None:
        from .native_inflate import NativeInflate

        if options is None:
            options = ZlibDecodeOptions()
        if isinstance(options, ZlibMode):
            options = ZlibDecodeOptions(mode=options)
        self.options = options
        DecoderBackend.__init__(self)
        self._inflate = NativeInflate(self.options.mode)
        self._inflate.sink_budget = self.pending_high_water

    def _rebase_input(self, nbytes: int) -> None:
        self._inflate.pos -= nbytes

    def _decode_direct(self, inp, out):
        """Zero-copy fast path (base.py hook): stream caller bytes straight
        through the C++ state machine into the caller's buffer. A partial-
        token tail on NeedInput is staged so chunk-fed callers keep the
        consumed-everything behavior of the buffered path."""
        res = self._inflate.run_direct(inp, out)
        if res is None:
            return None
        consumed, written, finished, need_output = res
        if finished:
            self._finished = True
            self._pending = bytearray()
            self._pending_pos = 0
            return consumed, written, DecodeStatus.Finished
        if need_output:
            return consumed, written, DecodeStatus.NeedOutput
        if consumed < len(inp):  # partial token tail: stage it
            self._staged = bytearray(inp[consumed:])
            self._staged_pos = 0
            self._inflate.pos = 0
            consumed = len(inp)
        return consumed, written, DecodeStatus.NeedInput

    def _do_reset(self) -> None:
        self._inflate._reset_stream()
        self._inflate.sink_budget = self.pending_high_water
