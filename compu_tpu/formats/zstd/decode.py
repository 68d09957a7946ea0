"""Zstandard frame/block decoder (RFC 8878 §3).

Accepts arbitrary foreign streams (the compatibility oracle path, like
formats/deflate/inflate.py): frame headers, raw/RLE/compressed blocks,
Huffman literals (all four modes, 1- and 4-stream), FSE sequences
(predefined / RLE / compressed / repeat modes), the 3-slot repeat-offset
history, window handling and xxhash64 content checksums.

Behavior contract mirrors the reference's zstd adapter
(src/decoder/zstd.rs:98-136): suspend/resume at any byte, typed errors,
window_log cap option.
"""

from __future__ import annotations

import struct

from ...ops.xxhash import xxh64
from ..base import CodecFailure
from .fse import BackwardBitReader, FseDecodeTable, read_norm_counts
from .huff import HufTable, decode_weights
from . import tables as T

ZSTD_MAGIC = 0xFD2FB528
SKIPPABLE_LOW = 0x184D2A50

ERR_MAGIC = 201
ERR_FRAME = 202
ERR_BLOCK = 203
ERR_LITERALS = 204
ERR_SEQUENCES = 205
ERR_OFFSET = 206
ERR_CHECKSUM = 207
ERR_WINDOW = 208
ERR_DICT = 209

ERRORS = {
    ERR_MAGIC: "invalid zstd magic",
    ERR_FRAME: "corrupt frame header",
    ERR_BLOCK: "corrupt block header",
    ERR_LITERALS: "corrupt literals section",
    ERR_SEQUENCES: "corrupt sequences section",
    ERR_OFFSET: "offset beyond window",
    ERR_CHECKSUM: "content checksum mismatch",
    ERR_WINDOW: "window size beyond configured limit",
    ERR_DICT: "dictionaries not supported",
}

MAX_BLOCK = 128 * 1024


class _NeedMore(Exception):
    """Internal: staged input ends before a complete unit."""


class ZstdFrameDecoder:
    """Resumable frame decoder over an external staged buffer.

    ``pump(staged, pos)`` consumes whole units (frame headers, blocks),
    appends decoded bytes to ``self.sink`` and returns
    ``(consumed_pos, finished)``.
    """

    def __init__(self, window_log_max: int = 31,
                 device_literals: bool = False) -> None:
        #: decode the 4-stream Huffman literal sections on device
        self.device_literals = device_literals
        #: literal sections the device decoded (the rest took the host)
        self.device_literal_sections = 0
        self.window_log_max = window_log_max
        self.sink = bytearray()
        self._reset_stream()

    def _reset_stream(self) -> None:
        self.phase = "magic"
        self.pos = 0
        self.has_checksum = False
        self.content_size = None
        self.window_size = None
        self.single_segment = False
        self.skippable_remaining = 0
        self.window = bytearray()
        self.sink_budget = None  # pause once this many sink bytes pend
        self.rep = [1, 4, 8]
        self.ll_table = None
        self.ml_table = None
        self.of_table = None
        self.huf_table = None
        self.hasher_buf = bytearray()  # decoded bytes for xxh64 (frame scope)
        self.last_block = False

    # ------------------------------------------------------------------
    def pump(self, staged, pos: int) -> tuple[int, bool]:
        del pos
        buf = staged
        try:
            while True:
                if (self.sink_budget is not None
                        and len(self.sink) >= self.sink_budget
                        and self.phase != "done"):
                    # Output budget reached: pause at this (resumable)
                    # phase boundary until the caller drains.
                    return self.pos, False
                if self.phase == "magic":
                    self._parse_magic(buf)
                elif self.phase == "skippable":
                    self._skip_frame(buf)
                elif self.phase == "frame_header":
                    self._parse_frame_header(buf)
                elif self.phase == "block":
                    self._decode_block(buf)
                elif self.phase == "checksum":
                    self._check_checksum(buf)
                elif self.phase == "done":
                    return self.pos, True
        except _NeedMore:
            return self.pos, False

    def _need(self, buf, n: int) -> bytes:
        if len(buf) - self.pos < n:
            raise _NeedMore()
        return bytes(buf[self.pos : self.pos + n])

    # ------------------------------------------------------------------
    def _parse_magic(self, buf) -> None:
        word = struct.unpack("<I", self._need(buf, 4))[0]
        if word == ZSTD_MAGIC:
            self.pos += 4
            self.phase = "frame_header"
        elif SKIPPABLE_LOW <= word <= SKIPPABLE_LOW + 15:
            size = struct.unpack("<I", self._need(buf, 8)[4:])[0]
            self.pos += 8
            self.skippable_remaining = size
            self.phase = "skippable"
        else:
            raise CodecFailure(ERR_MAGIC, ERRORS[ERR_MAGIC])

    def _skip_frame(self, buf) -> None:
        avail = len(buf) - self.pos
        take = min(avail, self.skippable_remaining)
        self.pos += take
        self.skippable_remaining -= take
        if self.skippable_remaining:
            raise _NeedMore()
        self.phase = "magic"

    def _parse_frame_header(self, buf) -> None:
        start = self.pos
        fhd = self._need(buf, 1)[0]
        p = self.pos + 1
        fcs_flag = fhd >> 6
        single_segment = bool(fhd & 0x20)
        has_checksum = bool(fhd & 0x04)
        dict_flag = fhd & 0x03
        if fhd & 0x08:
            raise CodecFailure(ERR_FRAME, "reserved frame header bit set")

        def take(n):
            nonlocal p
            if len(buf) - p < n:
                raise _NeedMore()
            v = bytes(buf[p : p + n])
            p += n
            return v

        if not single_segment:
            wd = take(1)[0]
            exponent = wd >> 3
            mantissa = wd & 7
            window_log = 10 + exponent
            window_base = 1 << window_log
            window_size = window_base + (window_base // 8) * mantissa
        else:
            window_size = None
        if dict_flag:
            take((0, 1, 2, 4)[dict_flag])
            raise CodecFailure(ERR_DICT, ERRORS[ERR_DICT])
        fcs_size = (0, 2, 4, 8)[fcs_flag]
        if single_segment and fcs_flag == 0:
            fcs_size = 1
        content_size = None
        if fcs_size:
            raw = take(fcs_size)
            content_size = int.from_bytes(raw, "little")
            if fcs_size == 2:
                content_size += 256
        if single_segment:
            window_size = content_size
        if window_size is not None and window_size > (1 << self.window_log_max):
            raise CodecFailure(ERR_WINDOW, ERRORS[ERR_WINDOW])
        # Commit.
        self.pos = p
        del start
        self.single_segment = single_segment
        self.has_checksum = has_checksum
        self.content_size = content_size
        self.window_size = window_size or (1 << 27)
        self.phase = "block"
        self.last_block = False
        self.rep = [1, 4, 8]
        self.huf_table = None
        self.ll_table = self.ml_table = self.of_table = None
        self.hasher_buf = bytearray()
        self.frame_decoded = 0

    # ------------------------------------------------------------------
    def _emit(self, data: bytes) -> None:
        self.sink.extend(data)
        self.window.extend(data)
        limit = self.window_size + MAX_BLOCK
        if len(self.window) > limit + (1 << 20):
            del self.window[: len(self.window) - limit]
        if self.has_checksum:
            self.hasher_buf.extend(data)
        self.frame_decoded += len(data)

    def _decode_block(self, buf) -> None:
        hdr = int.from_bytes(self._need(buf, 3), "little")
        last = hdr & 1
        btype = (hdr >> 1) & 3
        size = hdr >> 3
        p = self.pos + 3
        if btype == 0:  # raw
            if len(buf) - p < size:
                raise _NeedMore()
            self._emit(bytes(buf[p : p + size]))
            p += size
        elif btype == 1:  # RLE
            if len(buf) - p < 1:
                raise _NeedMore()
            self._emit(bytes([buf[p]]) * size)
            p += 1
        elif btype == 2:  # compressed
            if size > MAX_BLOCK:
                raise CodecFailure(ERR_BLOCK, "block too large")
            if len(buf) - p < size:
                raise _NeedMore()
            out = self._decode_compressed_block(bytes(buf[p : p + size]))
            self._emit(out)
            p += size
        else:
            raise CodecFailure(ERR_BLOCK, ERRORS[ERR_BLOCK])
        self.pos = p
        if last:
            if self.content_size is not None and self.frame_decoded != self.content_size:
                raise CodecFailure(ERR_FRAME, "content size mismatch")
            self.phase = "checksum" if self.has_checksum else "done"

    def _check_checksum(self, buf) -> None:
        expect = struct.unpack("<I", self._need(buf, 4))[0]
        got = xxh64(bytes(self.hasher_buf)) & 0xFFFFFFFF
        if expect != got:
            raise CodecFailure(ERR_CHECKSUM, ERRORS[ERR_CHECKSUM])
        self.pos += 4
        self.phase = "done"

    # ------------------------------------------------------------------
    # Compressed block internals
    # ------------------------------------------------------------------
    def _decode_compressed_block(self, block: bytes) -> bytes:
        literals, seq_data = self._decode_literals(block)
        return self._execute_sequences(seq_data, literals)

    def _decode_literals(self, block: bytes):
        if not block:
            raise CodecFailure(ERR_LITERALS, ERRORS[ERR_LITERALS])
        b0 = block[0]
        lit_type = b0 & 3
        size_format = (b0 >> 2) & 3
        if lit_type in (0, 1):  # Raw / RLE
            if size_format in (0, 2):
                regen = b0 >> 3
                hdr = 1
            elif size_format == 1:
                if len(block) < 2:
                    raise CodecFailure(ERR_LITERALS, ERRORS[ERR_LITERALS])
                regen = (b0 >> 4) | (block[1] << 4)
                hdr = 2
            else:
                if len(block) < 3:
                    raise CodecFailure(ERR_LITERALS, ERRORS[ERR_LITERALS])
                regen = (b0 >> 4) | (block[1] << 4) | (block[2] << 12)
                hdr = 3
            if lit_type == 0:
                literals = block[hdr : hdr + regen]
                if len(literals) != regen:
                    raise CodecFailure(ERR_LITERALS, ERRORS[ERR_LITERALS])
                return literals, block[hdr + regen :]
            if len(block) <= hdr:
                raise CodecFailure(ERR_LITERALS, ERRORS[ERR_LITERALS])
            return bytes([block[hdr]]) * regen, block[hdr + 1 :]

        # Compressed (2) or Treeless (3)
        if size_format == 0:
            streams = 1
            regen = (b0 >> 4) | ((block[1] & 0x3F) << 4)
            comp = (block[1] >> 6) | (block[2] << 2)
            hdr = 3
        elif size_format == 1:
            streams = 4
            regen = (b0 >> 4) | ((block[1] & 0x3F) << 4)
            comp = (block[1] >> 6) | (block[2] << 2)
            hdr = 3
        elif size_format == 2:
            streams = 4
            regen = (b0 >> 4) | (block[1] << 4) | ((block[2] & 3) << 12)
            comp = (block[2] >> 2) | (block[3] << 6)
            hdr = 4
        else:
            streams = 4
            regen = (b0 >> 4) | (block[1] << 4) | ((block[2] & 0x3F) << 12)
            comp = (block[2] >> 6) | (block[3] << 2) | (block[4] << 10)
            hdr = 5
        if len(block) < hdr + comp:
            raise CodecFailure(ERR_LITERALS, ERRORS[ERR_LITERALS])
        payload = block[hdr : hdr + comp]
        rest = block[hdr + comp :]
        if lit_type == 2:
            weights, consumed = decode_weights(payload)
            self.huf_table = HufTable(weights)
            payload = payload[consumed:]
        elif self.huf_table is None:
            raise CodecFailure(ERR_LITERALS, "treeless literals without tree")
        table = self.huf_table
        if streams == 1:
            literals = table.decode_stream(payload, regen)
        else:
            if len(payload) < 6:
                raise CodecFailure(ERR_LITERALS, ERRORS[ERR_LITERALS])
            s1, s2, s3 = struct.unpack_from("<HHH", payload, 0)
            body = payload[6:]
            if len(body) < s1 + s2 + s3:
                raise CodecFailure(ERR_LITERALS, ERRORS[ERR_LITERALS])
            per = (regen + 3) // 4
            sizes = [s1, s2, s3, len(body) - s1 - s2 - s3]
            counts = [per, per, per, regen - 3 * per]
            literals = None
            if self.device_literals and min(counts) > 0:
                # device 4-stream decode (VERDICT r4 item 8): the four
                # backward bitstreams decode as independent device lanes;
                # a malformed-stream signal (None) takes the host path,
                # which raises the format error
                from ...kernels.zstd_lit_decode_jax import (
                    decode_4stream_device)

                bodies = []
                off = 0
                for sz in sizes:
                    bodies.append(bytes(body[off : off + sz]))
                    off += sz
                literals = decode_4stream_device(
                    bodies, counts, table.symbol, table.nbits,
                    table.max_bits)
                if literals is not None:
                    self.device_literal_sections += 1
            if literals is None:
                literals = bytearray()
                off = 0
                for sz, cnt in zip(sizes, counts):
                    literals.extend(
                        table.decode_stream(body[off : off + sz], cnt))
                    off += sz
                literals = bytes(literals)
        if len(literals) != regen:
            raise CodecFailure(ERR_LITERALS, ERRORS[ERR_LITERALS])
        return literals, rest

    # -- sequences -----------------------------------------------------
    def _read_seq_table(self, data, mode, max_symbol, max_log, default_dist,
                        default_log, current, rle_symbol_bits=8):
        """Returns (FseDecodeTable-or-('rle', sym), bytes consumed)."""
        if mode == 0:  # predefined
            return FseDecodeTable(default_dist, default_log), 0
        if mode == 1:  # RLE: one byte symbol
            if not data:
                raise CodecFailure(ERR_SEQUENCES, ERRORS[ERR_SEQUENCES])
            return ("rle", data[0]), 1
        if mode == 2:  # FSE compressed
            counts, log, bitpos = read_norm_counts(data, 0, max_symbol, max_log)
            return FseDecodeTable(counts, log), (bitpos + 7) // 8
        # mode 3: repeat
        if current is None:
            raise CodecFailure(ERR_SEQUENCES, "repeat mode without prior table")
        return current, 0

    def _execute_sequences(self, data: bytes, literals: bytes) -> bytes:
        if not data:
            raise CodecFailure(ERR_SEQUENCES, ERRORS[ERR_SEQUENCES])
        b0 = data[0]
        if b0 == 0:
            # No sequences: literals only. Flush entropy tables per spec?
            # (Tables persist; rep offsets persist.)
            return literals
        if b0 < 128:
            nseq = b0
            p = 1
        elif b0 < 255:
            if len(data) < 2:
                raise CodecFailure(ERR_SEQUENCES, ERRORS[ERR_SEQUENCES])
            nseq = ((b0 - 128) << 8) + data[1]
            p = 2
        else:
            if len(data) < 3:
                raise CodecFailure(ERR_SEQUENCES, ERRORS[ERR_SEQUENCES])
            nseq = data[1] + (data[2] << 8) + 0x7F00
            p = 3
        if len(data) <= p:
            raise CodecFailure(ERR_SEQUENCES, ERRORS[ERR_SEQUENCES])
        modes = data[p]
        if modes & 3:
            raise CodecFailure(ERR_SEQUENCES, "reserved sequence mode bits")
        p += 1
        ll_mode = (modes >> 6) & 3
        of_mode = (modes >> 4) & 3
        ml_mode = (modes >> 2) & 3
        tbl, used = self._read_seq_table(
            data[p:], ll_mode, T.MAX_LL_SYMBOL, T.MAX_LL_LOG,
            T.LL_DEFAULT_DIST, T.LL_DEFAULT_LOG, self.ll_table)
        self.ll_table = tbl
        p += used
        tbl, used = self._read_seq_table(
            data[p:], of_mode, T.MAX_OF_SYMBOL, T.MAX_OF_LOG,
            T.OF_DEFAULT_DIST, T.OF_DEFAULT_LOG, self.of_table)
        self.of_table = tbl
        p += used
        tbl, used = self._read_seq_table(
            data[p:], ml_mode, T.MAX_ML_SYMBOL, T.MAX_ML_LOG,
            T.ML_DEFAULT_DIST, T.ML_DEFAULT_LOG, self.ml_table)
        self.ml_table = tbl
        p += used

        reader = BackwardBitReader(data[p:])

        def init_state(table):
            if isinstance(table, tuple):
                return None
            return reader.read(table.table_log)

        ll_state = init_state(self.ll_table)
        of_state = init_state(self.of_table)
        ml_state = init_state(self.ml_table)

        def symbol_of(table, state):
            if isinstance(table, tuple):
                return table[1]
            return int(table.symbol[state])

        out = bytearray()
        lit_pos = 0
        window = self.window
        rep = self.rep
        for i in range(nseq):
            of_code = symbol_of(self.of_table, of_state)
            ml_sym = symbol_of(self.ml_table, ml_state)
            ll_sym = symbol_of(self.ll_table, ll_state)
            if of_code > T.MAX_OF_SYMBOL or ml_sym > T.MAX_ML_SYMBOL or ll_sym > T.MAX_LL_SYMBOL:
                raise CodecFailure(ERR_SEQUENCES, ERRORS[ERR_SEQUENCES])
            # Extra bits: offset, then match length, then literals length.
            offset_value = (1 << of_code) + reader.read(of_code)
            ml = int(T.ML_BASE[ml_sym]) + reader.read(int(T.ML_BITS[ml_sym]))
            ll = int(T.LL_BASE[ll_sym]) + reader.read(int(T.LL_BITS[ll_sym]))
            # Resolve repeat offsets (RFC 8878 §3.1.1.5; ll==0 shifts the
            # repeat indices and value 3 means rep1 - 1).
            if offset_value > 3:
                offset = offset_value - 3
                rep[2] = rep[1]
                rep[1] = rep[0]
                rep[0] = offset
            else:
                idx = offset_value - 1 + (1 if ll == 0 else 0)
                if idx == 0:
                    offset = rep[0]  # rep history unchanged
                elif idx == 1:
                    offset = rep[1]
                    rep[1] = rep[0]
                    rep[0] = offset
                elif idx == 2:
                    offset = rep[2]
                    rep[2] = rep[1]
                    rep[1] = rep[0]
                    rep[0] = offset
                else:  # ll == 0 and offset_value == 3
                    offset = rep[0] - 1
                    if offset <= 0:
                        raise CodecFailure(ERR_OFFSET, ERRORS[ERR_OFFSET])
                    rep[2] = rep[1]
                    rep[1] = rep[0]
                    rep[0] = offset
            # Copy literals.
            if lit_pos + ll > len(literals):
                raise CodecFailure(ERR_SEQUENCES, "literals overrun")
            piece = literals[lit_pos : lit_pos + ll]
            out.extend(piece)
            window.extend(piece)
            lit_pos += ll
            # Copy match.
            if ml:
                if offset > len(window):
                    raise CodecFailure(ERR_OFFSET, ERRORS[ERR_OFFSET])
                start = len(window) - offset
                if offset >= ml:
                    m = window[start : start + ml]
                else:
                    m = bytes(window[start:])
                    reps_needed = -(-ml // offset)
                    m = (m * reps_needed)[:ml]
                out.extend(m)
                window.extend(m)
            # State updates (not after the last sequence).
            if i < nseq - 1:
                if not isinstance(self.ll_table, tuple):
                    ll_state = int(self.ll_table.baseline[ll_state]) + reader.read(
                        int(self.ll_table.nbits[ll_state])
                    )
                if not isinstance(self.ml_table, tuple):
                    ml_state = int(self.ml_table.baseline[ml_state]) + reader.read(
                        int(self.ml_table.nbits[ml_state])
                    )
                if not isinstance(self.of_table, tuple):
                    of_state = int(self.of_table.baseline[of_state]) + reader.read(
                        int(self.of_table.nbits[of_state])
                    )
        # Trailing literals.
        tail = literals[lit_pos:]
        out.extend(tail)
        window.extend(tail)
        # NOTE: _emit re-extends the window; trim the double-extension here.
        del window[len(window) - len(out) :]
        return bytes(out)
