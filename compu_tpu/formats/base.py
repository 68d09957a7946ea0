"""Backend plumbing shared by every format pipeline.

The reference's backends are vtables over opaque native stream objects
(``decoder::Interface``, src/decoder/mod.rs:160-166; ``encoder::Interface``,
src/encoder/mod.rs:52-57). In this framework a backend is a *block
pipeline*: the host stages input bytes, cuts them into fixed-shape blocks,
runs the format's device kernels over the blocks, and drains the produced
bytes back through the caller's buffers. The streaming status contract
(NeedInput/NeedOutput/Finished, Process/Flush/Finish) is implemented once
here; formats implement a small set of hooks.

Design note on buffering: the reference documents that backends may either
buffer internally (brotli) or wait for output space (zlib)
(tests/decoder.rs:38-39 comment). The device pipelines buffer internally —
device kernels produce whole blocks at once, which the host then drains —
but the internal buffering is BOUNDED: once undrained output exceeds
``pending_high_water``, further input is refused (``input_remain`` reports
it back, the reference's back-pressure contract at src/decoder/mod.rs:150-157)
until the caller drains, and consumed input/drained output prefixes are
compacted away. A stream of any length therefore flows through small caller
buffers in O(window + high_water) host memory.
"""

from __future__ import annotations

from typing import Optional

from ..status import Decode, DecodeError, DecodeStatus, Encode, EncodeOp, EncodeStatus


class CodecFailure(Exception):
    """Raised by format hooks on a malformed stream or internal failure.

    ``code`` is the backend-specific error code surfaced through
    ``DecodeError`` (reference: src/decoder/mod.rs:117-135).
    """

    def __init__(self, code: int, message: str = "corrupt stream") -> None:
        super().__init__(message)
        self.code = code
        self.message = message


class DecoderBackend:
    """Base class for decode pipelines.

    Subclass contract — implement:

    * ``_pump()``: consume bytes from ``self._staged`` starting at
      ``self._staged_pos`` (advancing it), append decoded bytes to
      ``self._pending``, and set ``self._finished = True`` once the stream's
      trailer has been consumed and verified. Must be resumable: called
      whenever new input arrives; decode as far as the available bytes
      allow and return (keeping any partial-unit tail unconsumed).
      Raise :class:`CodecFailure` on corruption.
    * ``_do_reset()``: drop all stream state; options survive.
    * ``ERRORS``: dict code -> static message for ``describe_error``.
    """

    name = "?"
    ERRORS: dict[int, str] = {}
    #: Back-pressure threshold: once this many undrained decoded bytes are
    #: pending, new input is refused (reported via ``input_remain``) until
    #: the caller drains output.
    pending_high_water = 1 << 20

    def __init__(self) -> None:
        self._init_stream_state()

    def _init_stream_state(self) -> None:
        self._staged = bytearray()
        self._staged_pos = 0
        self._pending = bytearray()
        self._pending_pos = 0
        self._finished = False
        self._error: Optional[DecodeError] = None

    # -- hooks ---------------------------------------------------------------
    def _pump(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _do_reset(self) -> None:
        pass

    def _rebase_input(self, nbytes: int) -> None:
        """Notify the format that ``nbytes`` were dropped from the front of
        ``_staged`` (compaction); formats keeping absolute offsets into the
        staged buffer shift them here. Default: nothing keeps offsets."""

    #: Optional zero-copy fast path. When set (a callable ``(inp, out) ->
    #: (consumed, written, DecodeStatus) | None``), ``decode`` tries it
    #: FIRST whenever no staged residue or pending backlog exists — the
    #: backend may then stream caller bytes straight through its native
    #: state machine into the caller's buffer, skipping every intermediate
    #: bytearray. Returning None falls back to the generic staged path.
    #: The hook may stage an unconsumed tail itself (set ``_staged``/
    #: ``_staged_pos``) and must set ``_finished`` when the trailer was
    #: verified.
    _decode_direct = None

    # -- internal helpers -----------------------------------------------------
    def _drain(self, out) -> int:
        """Move pending bytes into ``out``; returns bytes written."""
        avail = len(self._pending) - self._pending_pos
        n = min(avail, len(out))
        if n:
            out[:n] = self._pending[self._pending_pos : self._pending_pos + n]
            self._pending_pos += n
            if self._pending_pos == len(self._pending):
                self._pending = bytearray()
                self._pending_pos = 0
            elif self._pending_pos > (1 << 16):
                del self._pending[: self._pending_pos]
                self._pending_pos = 0
        return n

    def _compact_staged(self) -> None:
        if self._staged_pos > (1 << 16):
            drop = self._staged_pos
            del self._staged[:drop]
            self._staged_pos = 0
            self._rebase_input(drop)

    # -- generic state machine ----------------------------------------------
    def decode(self, inp, out) -> Decode:
        inp = memoryview(inp).cast("B") if len(inp) else memoryview(b"")
        out = memoryview(out).cast("B") if len(out) else memoryview(bytearray())
        if self._error is not None:
            return Decode(len(inp), len(out), self._error)

        # Drain already-pending bytes first so back-pressure releases as
        # soon as the caller offers output space.
        written = self._drain(out)
        consumed = 0
        if (self._decode_direct is not None
                and not self._finished
                and self._staged_pos == len(self._staged)
                and self._pending_pos == len(self._pending)):
            try:
                res = self._decode_direct(inp, out[written:])
            except CodecFailure as failure:
                self._error = DecodeError(failure.code)
                return Decode(len(inp), len(out), self._error)
            if res is not None:
                consumed_d, written_d, status = res
                return Decode(len(inp) - consumed_d,
                              len(out) - written - written_d, status)
        backlog = len(self._pending) - self._pending_pos
        if not self._finished and backlog < self.pending_high_water:
            self._staged.extend(inp)
            consumed = len(inp)
            # Pump until the stream finishes, back-pressure engages, or the
            # format genuinely needs more input (no progress). A single
            # pump can stop early at its sink budget; with a large caller
            # buffer the drain empties pending again, so keep going —
            # otherwise the call would report NeedInput with decodable
            # input still staged.
            while True:
                before_pos = self._staged_pos
                before_avail = len(self._pending) - self._pending_pos
                try:
                    self._pump()
                except CodecFailure as failure:
                    self._error = DecodeError(failure.code)
                    return Decode(len(inp), len(out), self._error)
                progressed = (
                    self._staged_pos != before_pos
                    or len(self._pending) - self._pending_pos != before_avail
                )
                self._compact_staged()
                if self._finished:
                    # Bytes past the end of the stream are not ours to
                    # consume; attribute the excess to the current input
                    # slice (the reference's zlib leaves trailing bytes in
                    # avail_in).
                    excess = len(self._staged) - self._staged_pos
                    consumed = len(inp) - min(excess, len(inp))
                    break
                written += self._drain(out[written:])
                if not progressed:
                    break
                if len(self._pending) - self._pending_pos >= self.pending_high_water:
                    break
            written += self._drain(out[written:])
        if len(self._pending) - self._pending_pos > 0:
            status = DecodeStatus.NeedOutput
        elif self._finished:
            status = DecodeStatus.Finished
        else:
            status = DecodeStatus.NeedInput
        return Decode(len(inp) - consumed, len(out) - written, status)

    def reset(self) -> bool:
        self._init_stream_state()
        self._do_reset()
        return True

    def describe_error(self, code: int) -> Optional[str]:
        if code == 0:
            return "unknown error"  # DecodeError::no_error analogue
        return self.ERRORS.get(code)


class EncoderBackend:
    """Base class for encode pipelines.

    Input is staged and cut into ``block_size`` chunks at absolute stream
    offsets, which keeps chunked and one-shot encodes byte-identical (the
    reference's determinism invariant, tests/encoder.rs:56-57). Subclass
    contract — implement:

    * ``_header() -> bytes``: stream header, emitted once lazily.
    * ``_compress(data, final) -> bytes``: compress one complete chunk;
      the format tracks rolling state (checksums, window carry) itself.
      Called with ``final=True`` exactly once, on Finish (possibly with
      empty ``data``).
    * ``_flush_mark() -> bytes``: byte-aligned sync point for Flush.
    * ``_trailer() -> bytes``: stream trailer (checksums, frame end).
    * ``_do_reset()``: drop stream state, keep options.
    """

    name = "?"
    block_size = 1 << 20  # 1 MiB device blocks by default

    @property
    def pending_high_water(self) -> int:
        """Back-pressure threshold for undrained compressed output: under
        ``Process``, input is refused (``input_remain``) once this much
        output is waiting — a small-output-buffer caller therefore bounds
        host memory at O(block) instead of O(stream)."""
        return self.block_size + (1 << 16)

    def __init__(self) -> None:
        self._init_stream_state()

    def _init_stream_state(self) -> None:
        self._staged = bytearray()
        self._pending = bytearray()
        self._pending_pos = 0
        self._finished = False
        self._failed = False
        self._header_emitted = False

    # -- hooks ---------------------------------------------------------------
    def _header(self) -> bytes:
        return b""

    def _compress(self, data: bytes, final: bool) -> bytes:  # pragma: no cover
        raise NotImplementedError

    def _flush_mark(self) -> bytes:
        return b""

    def _trailer(self) -> bytes:
        return b""

    def _do_reset(self) -> None:
        pass

    # -- generic state machine ----------------------------------------------
    def _ensure_header(self) -> None:
        if not self._header_emitted:
            self._pending.extend(self._header())
            self._header_emitted = True

    def _compress_staged(self, final: bool) -> None:
        """Compress staged input in block_size chunks (all of it)."""
        self._ensure_header()
        view = bytes(self._staged)
        self._staged = bytearray()
        offset = 0
        if final and not view:
            self._pending.extend(self._compress(b"", True))
            return
        while offset < len(view):
            chunk = view[offset : offset + self.block_size]
            offset += len(chunk)
            is_last = final and offset >= len(view)
            self._pending.extend(self._compress(chunk, is_last))

    def _drain(self, out) -> int:
        """Move pending bytes into ``out``; returns bytes written."""
        avail = len(self._pending) - self._pending_pos
        n = min(avail, len(out))
        if n:
            out[:n] = self._pending[self._pending_pos : self._pending_pos + n]
            self._pending_pos += n
            if self._pending_pos == len(self._pending):
                self._pending = bytearray()
                self._pending_pos = 0
            elif self._pending_pos > (1 << 16):
                del self._pending[: self._pending_pos]
                self._pending_pos = 0
        return n

    def encode(self, inp, out, op: EncodeOp) -> Encode:
        inp = memoryview(inp).cast("B") if len(inp) else memoryview(b"")
        out = memoryview(out).cast("B") if len(out) else memoryview(bytearray())
        if self._failed or (self._finished and op is not EncodeOp.Finish):
            return Encode(len(inp), len(out), EncodeStatus.Error)
        written = self._drain(out)
        refused = 0
        try:
            if not self._finished:
                backlog = len(self._pending) - self._pending_pos
                if op is EncodeOp.Process and backlog >= self.pending_high_water:
                    # Back-pressure: refuse input until the caller drains.
                    # (Flush/Finish always accept — they finalize the stream
                    # and the caller resumes draining via NeedOutput.)
                    refused = len(inp)
                else:
                    self._staged.extend(inp)
                if op is EncodeOp.Process:
                    # Compress only complete blocks; boundaries depend on
                    # absolute offsets so chunked == one-shot.
                    while len(self._staged) >= self.block_size:
                        self._ensure_header()
                        chunk = bytes(self._staged[: self.block_size])
                        del self._staged[: self.block_size]
                        self._pending.extend(self._compress(chunk, False))
                elif op is EncodeOp.Flush:
                    self._compress_staged(final=False)
                    self._pending.extend(self._flush_mark())
                elif op is EncodeOp.Finish:
                    self._compress_staged(final=True)
                    self._pending.extend(self._trailer())
                    self._finished = True
        except CodecFailure:
            self._failed = True
            return Encode(len(inp), len(out), EncodeStatus.Error)

        written += self._drain(out[written:])
        if len(self._pending) - self._pending_pos > 0:
            status = EncodeStatus.NeedOutput
        elif self._finished:
            status = EncodeStatus.Finished
        else:
            status = EncodeStatus.Continue
        return Encode(refused, len(out) - written, status)

    def reset(self) -> bool:
        self._init_stream_state()
        self._do_reset()
        return True
