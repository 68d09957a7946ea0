"""Block-parallel stream scheduler (pigz-style).

Splits a stream into fixed-size independent blocks, encodes them on device
(batched or mesh-sharded), and assembles ONE standard zlib/gzip stream:

* every block is a self-contained run of deflate blocks terminated by an
  empty stored block (Z_SYNC_FLUSH), so block outputs are byte-aligned and
  concatenate freely;
* matches never cross block boundaries (the device kernel enforces this),
  so any block can be decoded knowing only its bytes;
* per-block checksums computed on device are merged on the host with the
  O(log) combine algebra (ops/checksum.py) — no serial re-scan;
* the scheduler records a block index (compressed offset, raw length) that
  makes *our own* streams embarrassingly parallel to decode, while any
  stock inflate still accepts them sequentially.

This subsystem plays the role the generic vtable Interface plays in the
reference (SURVEY §2c): it assigns blocks to devices, tracks per-block
status, and reassembles ordered output.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..ops import checksum
from ..formats.deflate.options import ZlibMode


class BlockState:
    """Per-block scheduler status, mirroring the Encode/Decode status model
    (SURVEY §2c: the scheduler tracks per-block statuses the way the
    reference's state machine tracks per-call statuses)."""

    Ok = "ok"
    DeviceFailed = "device_failed"   # device step failed; host fallback used
    HostFallback = "host_fallback"   # decoded/encoded by the host oracle
    Failed = "failed"                # both paths failed (stream aborts)


@dataclasses.dataclass
class BlockStatus:
    index: int
    state: str = BlockState.Ok
    error: str | None = None


@dataclasses.dataclass
class BlockIndex:
    """Side index of a block-parallel stream (in stream order).

    ``segment_bits`` (optional) holds per-block arrays of segment bit
    offsets relative to each block's first byte — the key that makes
    self-produced blocks segment-parallel to decode on device
    (kernels/inflate_jax.py)."""

    raw_lengths: list[int]
    compressed_offsets: list[int]  # offset of each block's first byte
    compressed_lengths: list[int]
    segment_bits: list | None = None

    def to_bytes(self) -> bytes:
        out = bytearray(struct.pack("<I", len(self.raw_lengths)))
        for r, o, c in zip(self.raw_lengths, self.compressed_offsets, self.compressed_lengths):
            out.extend(struct.pack("<QQQ", r, o, c))
        return bytes(out)

    @staticmethod
    def from_bytes(blob: bytes) -> "BlockIndex":
        (n,) = struct.unpack_from("<I", blob, 0)
        idx = BlockIndex([], [], [])
        for i in range(n):
            r, o, c = struct.unpack_from("<QQQ", blob, 4 + 24 * i)
            idx.raw_lengths.append(r)
            idx.compressed_offsets.append(o)
            idx.compressed_lengths.append(c)
        return idx


def _gzip_header() -> bytes:
    return struct.pack("<BBBBIBB", 0x1F, 0x8B, 8, 0, 0, 0, 255)


def _zlib_header() -> bytes:
    cmf, flg = 0x78, 0x80
    fcheck = (31 - ((cmf << 8 | flg) % 31)) % 31
    return bytes([cmf, flg | fcheck])


class BlockParallelEncoder:
    """Encode a whole buffer as one standard stream of independent blocks.

    ``block_fn(blocks_u8[B, N], lens_i32[B]) -> (out_u8[B, cap],
    out_lens[B], adlers_or_crcs[B])`` is the device step — batched
    single-chip (kernels/deflate_jax.py) or mesh-sharded
    (parallel/mesh.py). The host does framing, ordering, and checksum
    combining only.
    """

    def __init__(self, block_fn, block_size: int = 1 << 20, mode: ZlibMode = ZlibMode.Gzip,
                 host_fallback: bool = True):
        if mode is ZlibMode.Auto:
            raise ValueError("Auto is decode-only")
        self.block_fn = block_fn
        self.block_size = block_size
        self.mode = mode
        #: Re-encode failed blocks on the host oracle instead of aborting.
        self.host_fallback = host_fallback
        #: Per-block statuses of the last encode() (BlockStatus list).
        self.block_statuses: list[BlockStatus] = []
        from ..utils.metrics import Metrics

        self.metrics = Metrics()

    def encode(self, data: bytes) -> tuple[bytes, BlockIndex]:
        from ..utils.metrics import trace_span

        n = len(data)
        bs = self.block_size
        nblocks = max(1, -(-n // bs))
        # Pad the block matrix to fixed shapes for the device step.
        with self.metrics.stage("stage_blocks"):
            blocks = np.zeros((nblocks, bs), dtype=np.uint8)
            lens = np.zeros(nblocks, dtype=np.int32)
            for i in range(nblocks):
                chunk = data[i * bs : (i + 1) * bs]
                blocks[i, : len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
                lens[i] = len(chunk)

        self.block_statuses = [BlockStatus(i) for i in range(nblocks)]
        seg_index = None
        try:
            with self.metrics.stage("device_encode"), trace_span("compu/device_encode"):
                result = self.block_fn(blocks, lens)
            if len(result) == 4:
                out, out_lens, adlers, seg_index = result
            else:
                out, out_lens, adlers = result
            out_lens = np.asarray(out_lens)
            adlers = np.asarray(adlers)
        except Exception as exc:  # device step failed wholesale
            if not self.host_fallback:
                for st in self.block_statuses:
                    st.state, st.error = BlockState.Failed, str(exc)
                raise
            for st in self.block_statuses:
                st.state, st.error = BlockState.DeviceFailed, str(exc)
            out, out_lens, adlers = [None] * nblocks, np.zeros(nblocks, np.int64), np.zeros(nblocks, np.uint32)
            seg_index = None

        # Per-block validation + host retry: a block whose metadata is
        # implausible (empty/oversized output) is re-encoded by the host
        # oracle so one bad block never aborts the stream.
        cap = bs + bs // 4 + 64
        for i in range(nblocks):
            bad = (
                self.block_statuses[i].state is not BlockState.Ok
                or not (0 < int(out_lens[i]) <= cap)
            )
            if not bad:
                continue
            if not self.host_fallback:
                self.block_statuses[i].state = BlockState.Failed
                raise ValueError(f"block {i}: invalid device output and host_fallback=False")
            blob, chk = _host_encode_block(
                bytes(blocks[i, : int(lens[i])].tobytes()), self.mode
            )
            out = list(out)
            out[i] = np.frombuffer(blob, dtype=np.uint8)
            out_lens = np.asarray(out_lens).copy()
            out_lens[i] = len(blob)
            adlers = np.asarray(adlers).copy()
            adlers[i] = chk
            self.block_statuses[i].state = BlockState.HostFallback
            if seg_index is not None:
                # Host blocks carry no segment index; drop the device-decode
                # side index for the whole stream (it must be complete).
                seg_index = None
        for i in range(nblocks):
            self.metrics.record_block(int(lens[i]), int(out_lens[i]))

        with self.metrics.stage("assemble"):
            stream, index = self._assemble(data, out, out_lens, adlers, lens, nblocks, n)
        if seg_index is not None:
            index.segment_bits = [seg_index[i] for i in range(nblocks)]
        return stream, index

    def _assemble(self, data, out, out_lens, adlers, lens, nblocks, n):
        header = (
            _gzip_header()
            if self.mode is ZlibMode.Gzip
            else (_zlib_header() if self.mode is ZlibMode.Zlib else b"")
        )
        stream = bytearray(header)
        index = BlockIndex([], [], [])
        for i in range(nblocks):
            index.raw_lengths.append(int(lens[i]))
            index.compressed_offsets.append(len(stream))
            index.compressed_lengths.append(int(out_lens[i]))
            stream.extend(np.asarray(out[i])[: int(out_lens[i])].tobytes())
        # Closing: empty FINAL stored block terminates the deflate stream.
        stream.extend(bytes([0x01, 0x00, 0x00, 0xFF, 0xFF]))

        if self.mode is ZlibMode.Zlib:
            total = 1
            for i in range(nblocks):
                total = checksum.adler32_combine(total, int(adlers[i]), int(lens[i]))
            stream.extend(struct.pack(">I", total))
        elif self.mode is ZlibMode.Gzip:
            # Device step returns per-block crc32 for gzip mode.
            total = 0
            for i in range(nblocks):
                total = checksum.crc32_combine(total, int(adlers[i]), int(lens[i]))
            stream.extend(struct.pack("<II", total, n & 0xFFFFFFFF))
        return bytes(stream), index


class BlockParallelDecoder:
    """Decode a block-parallel stream using its side index.

    Each block's compressed bytes are independent (window reset + byte
    alignment), so blocks decode concurrently — on host threads today, on
    the device inflate kernel as it lands. Ordered reassembly is a simple
    concatenation because the index is in stream order.
    """

    def __init__(self, block_decode_fn=None, device: bool = False,
                 block_size: int = 1 << 18, host_fallback: bool = True):
        self._decode_block = block_decode_fn or _host_inflate_block
        self._device = device
        self._block_size = block_size
        #: Retry device-decode failures on the host oracle per block.
        self.host_fallback = host_fallback
        #: Per-block statuses of the last decode() (BlockStatus list).
        self.block_statuses: list[BlockStatus] = []
        #: Blocks the last decode() inflated on the device (stored blocks
        #: and host-path decodes are not counted).
        self.device_blocks = 0

    def decode(self, stream: bytes, index: BlockIndex) -> bytes:
        nblocks = len(index.raw_lengths)
        self.block_statuses = [BlockStatus(i) for i in range(nblocks)]
        self.device_blocks = 0
        if self._device and index.segment_bits is not None:
            try:
                return self._decode_device(stream, index)
            except Exception as exc:
                self.device_blocks = 0
                if not self.host_fallback:
                    for st in self.block_statuses:
                        st.state, st.error = BlockState.Failed, str(exc)
                    raise
                for st in self.block_statuses:
                    st.state, st.error = BlockState.DeviceFailed, str(exc)
        # Host path: blocks are independent, so decode them concurrently —
        # the native (C++) block decoder releases the GIL inside the
        # ctypes call, so a thread pool scales near-linearly (VERDICT r3
        # item 8). Ordered reassembly via the futures list.
        from concurrent.futures import ThreadPoolExecutor

        def one(i, off, clen, rlen):
            try:
                piece = self._decode_block(stream[off : off + clen], rlen)
            except Exception as exc:
                self.block_statuses[i].state = BlockState.Failed
                self.block_statuses[i].error = str(exc)
                raise
            if self.block_statuses[i].state is BlockState.DeviceFailed:
                self.block_statuses[i].state = BlockState.HostFallback
            return piece

        jobs = list(zip(
            range(nblocks), index.compressed_offsets,
            index.compressed_lengths, index.raw_lengths,
        ))
        if nblocks > 1:
            import os as _os

            # workers = cores: oversubscribing a small host thrashes the
            # GIL-released C++ decoders' caches (8 workers on 2 cores
            # measured SLOWER than single-stream)
            workers = min(_os.cpu_count() or 1, nblocks, 8)
            with ThreadPoolExecutor(max_workers=workers) as pool:
                futs = [pool.submit(one, *j) for j in jobs]
                pieces = [f.result() for f in futs]
        else:
            pieces = [one(*j) for j in jobs]
        return b"".join(pieces)

    DEVICE_DECODE_BATCH = 16

    def _decode_device(self, stream: bytes, index: BlockIndex) -> bytes:
        """Segment-parallel device inflate, batched DEVICE_DECODE_BATCH
        blocks per kernel call (amortizes per-op dispatch overhead across
        all segment lanes). Each block's deflate header is parsed on the
        host (tiny) into per-block code-length tables, so fixed AND
        dynamic blocks decode through the canonical-arithmetic scan
        (kernels/inflate_jax_dyn.py); stored blocks (incompressible data)
        are host memcpys."""
        import jax.numpy as jnp

        from ..kernels.inflate_jax_dyn import (
            decode_blocks_indexed_dyn,
            parse_block_tables,
        )
        from ..kernels.inflate_jax_lut import decode_blocks_indexed_lut

        bs = self._block_size
        cap = bs + bs // 4 + 64 + 16
        nblocks = len(index.raw_lengths)
        batch = self.DEVICE_DECODE_BATCH
        futs = []
        host_pieces: dict[int, bytes] = {}
        for base in range(0, nblocks, batch):
            cnt = min(batch, nblocks - base)
            comps = np.zeros((batch, cap), dtype=np.uint8)
            segs = np.zeros((batch, bs // 128), dtype=np.int32)
            ns = np.zeros(batch, dtype=np.int32)
            lit_lens = np.zeros((batch, 288), dtype=np.int32)
            dist_lens = np.zeros((batch, 30), dtype=np.int32)
            lit_lens[:, 0] = 1  # inert complete-ish tables for empty slots
            lit_lens[:, 256] = 1
            dist_lens[:, 0] = 1
            dist_lens[:, 1] = 1
            for j in range(cnt):
                b = base + j
                off = index.compressed_offsets[b]
                clen = index.compressed_lengths[b]
                blob = stream[off : off + clen]
                kind, lit, dist, _ = parse_block_tables(blob[:4096])
                if kind == 0 or int(np.asarray(index.segment_bits[b])[0]) < 0:
                    # stored block: host memcpy (no entropy decode)
                    host_pieces[b] = _host_inflate_block(
                        blob, index.raw_lengths[b]
                    )
                    ns[j] = 0  # inert device lane
                    continue
                comps[j, :clen] = np.frombuffer(blob, dtype=np.uint8)
                segs[j] = np.asarray(index.segment_bits[b], dtype=np.int32)
                ns[j] = index.raw_lengths[b]
                lit_lens[j] = lit
                dist_lens[j] = dist
            # LUT fast path covers every code the v3 encoder can emit
            # (CAPBITS=12) and fixed trees; rare foreign indexed streams
            # with 13..15-bit codes use the canonical-arithmetic scan.
            decode_fn = (
                decode_blocks_indexed_lut
                if max(int(lit_lens.max()), int(dist_lens.max())) <= 12
                else decode_blocks_indexed_dyn
            )
            out, ok = decode_fn(
                jnp.asarray(comps), jnp.asarray(segs), jnp.asarray(ns),
                jnp.asarray(lit_lens), jnp.asarray(dist_lens), n_out=bs
            )
            futs.append((out, ok, base, cnt))
            self.device_blocks += cnt - sum(
                1 for b in range(base, base + cnt) if b in host_pieces)
        pieces = []
        for out, ok, base, cnt in futs:
            if int(np.asarray(ok)[0]) != 1:
                raise ValueError("device inflate failed consistency checks")
            flat = np.asarray(out)
            for j in range(cnt):
                b = base + j
                if b in host_pieces:
                    pieces.append(host_pieces[b])
                    continue
                rlen = index.raw_lengths[b]
                pieces.append(flat[j * bs : j * bs + rlen].tobytes())
        return b"".join(pieces)


def make_host_block_encode_fn(mode: ZlibMode, level: int = 6,
                              workers: int | None = None):
    """Threaded HOST block-encode step with the BlockParallelEncoder
    contract — the scheduler's CPU engine. Each block is one
    GIL-releasing C++ deflate call (window reset per block keeps blocks
    independent) plus a native checksum, pooled across cores (the
    scheduler composes either engine behind one stream format)."""
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    from ..formats.deflate.pipeline import _NativeDeflateStream

    nworkers = workers or min(_os.cpu_count() or 1, 8)

    def encode_one(data: bytes):
        s = _NativeDeflateStream(level)
        blob = s.compress(data, final=False) + s.sync_flush()
        if mode is ZlibMode.Zlib:
            chk = checksum.adler32(data, 1)
        else:
            chk = checksum.crc32(data, 0)
        return blob, chk

    def fn(blocks, lens):
        import numpy as _np

        B = blocks.shape[0]
        datas = [bytes(blocks[i, : int(lens[i])].tobytes()) for i in range(B)]
        if B > 1 and nworkers > 1:
            with ThreadPoolExecutor(max_workers=min(nworkers, B)) as pool:
                results = list(pool.map(encode_one, datas))
        else:
            results = [encode_one(d) for d in datas]
        out = [_np.frombuffer(blob, dtype=_np.uint8) for blob, _ in results]
        out_lens = _np.asarray([len(blob) for blob, _ in results], _np.int64)
        checks = _np.asarray([chk for _, chk in results], _np.uint32)
        return out, out_lens, checks

    return fn


def parallel_zstd_compress(data: bytes, level: int = 3,
                           frame_size: int = 1 << 20,
                           workers: int | None = None,
                           window_log: int = 21,
                           checksum_frames: bool = True) -> bytes:
    """Frame-parallel zstd encode (SURVEY §2c: zstd FRAMES are the
    format's self-contained independent blocks): each ~frame_size slice
    becomes one complete frame via the standalone C++ encoder (GIL
    released inside the call), pooled across cores; the concatenation is
    a standard multi-frame zstd stream every conforming streaming
    decoder (including this repo's two) accepts."""
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    from ..formats.zstd.native_enc2 import NativeZstdStream

    chunks = [data[i:i + frame_size]
              for i in range(0, max(len(data), 1), frame_size)] or [b""]

    def one(chunk: bytes) -> bytes:
        s = NativeZstdStream(level=level, window_log=window_log,
                             checksum=checksum_frames)
        return s.compress_chunk(chunk, final=True)

    nworkers = workers or min(_os.cpu_count() or 1, 8)
    if len(chunks) > 1 and nworkers > 1:
        with ThreadPoolExecutor(max_workers=min(nworkers, len(chunks))) as p:
            frames = list(p.map(one, chunks))
    else:
        frames = [one(c) for c in chunks]
    return b"".join(frames)


def _host_encode_block(data: bytes, mode: ZlibMode) -> tuple[bytes, int]:
    """Host-oracle encode of one block: a self-contained raw-deflate run
    terminated by a sync flush (byte-aligned), plus the block checksum the
    scheduler's combine algebra expects (adler32 for zlib, finalized crc32
    for gzip/raw). Used as the per-block retry path when the device step
    fails (SURVEY §2c: scheduler fallback mirroring Decode/Encode errors)."""
    from ..formats.deflate.deflate_encode import DeflateStream
    from ..formats.deflate.options import ZlibStrategy

    s = DeflateStream(6, ZlibStrategy.Default)
    blob = s.compress(data, final=False) + s.sync_flush()
    if mode is ZlibMode.Zlib:
        chk = checksum.adler32(data, 1)
    else:
        chk = checksum.crc32(data, 0)
    return blob, chk


def _host_inflate_block(blob: bytes, raw_len: int) -> bytes:
    """Host block decoder: raw deflate run ending in a sync flush. Uses the
    native (C++) inflate when available, the pure-Python core otherwise.

    The native path is ONE ctypes call into the whole-block C decoder (the
    GIL drops for the duration), so the scheduler's thread pool scales —
    the streaming NativeInflate wrapper's Python-side staging serialized
    most of each block under the GIL."""
    import ctypes

    from ..formats.deflate.options import ZlibMode as _M
    from ..runtime import native

    # Terminate the non-final run so the state machine reaches Finished.
    payload = bytes(blob) + b"\x01\x00\x00\xff\xff"
    lib = native._load()
    if lib is not None and hasattr(lib, "compu_inflate_new"):
        h = lib.compu_inflate_new()
        try:
            out = ctypes.create_string_buffer(raw_len + 8)
            arr = (ctypes.c_ubyte * len(payload)).from_buffer_copy(payload)
            consumed = ctypes.c_size_t(0)
            written = ctypes.c_size_t(0)
            st = lib.compu_inflate_run(
                h, ctypes.cast(arr, ctypes.POINTER(ctypes.c_ubyte)),
                len(payload), out, raw_len + 8,
                ctypes.byref(consumed), ctypes.byref(written))
            if st == 2 and written.value == raw_len:  # DONE
                return out.raw[:raw_len]
        finally:
            lib.compu_inflate_free(h)
        # fall through to the streaming wrapper on any anomaly
    try:
        from ..formats.deflate.native_inflate import (
            NativeInflate,
            native_inflate_available,
        )
        if native_inflate_available():
            inf = NativeInflate(_M.Deflate)
            inf.pump(payload, 0)
            out = bytes(inf.sink)
            if len(out) != raw_len:
                raise ValueError(
                    f"block decoded {len(out)} bytes, expected {raw_len}"
                )
            return out
    except RuntimeError:
        pass
    from ..formats.deflate.inflate import Inflate

    inf = Inflate(_M.Deflate)
    inf.pump(payload, 0)
    out = bytes(inf.sink)
    if len(out) != raw_len:
        raise ValueError(f"block decoded {len(out)} bytes, expected {raw_len}")
    return out
