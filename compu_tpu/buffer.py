"""Fixed-size staging buffer for chunked drivers.

Behavioral equivalent of the reference's ``Buffer<const N: usize>``
(reference: src/buffer.rs:4-49): a fixed byte array plus a cursor. Codecs
write into the spare region, the user drains ``data()`` and ``consume()``s.

In the device framework this is also the shape of the per-host staging driver:
a fixed-size block in, an ordered drain out (see parallel/scheduler.py).
"""

from __future__ import annotations

from .status import Decode, Encode, EncodeOp

MIN_SIZE = 128  # debug_assert!(N >= 128) in the reference (src/buffer.rs:12)


class Buffer:
    """Fixed-capacity staging buffer with a write cursor."""

    __slots__ = ("_buf", "_cursor")

    def __init__(self, size: int = 4096) -> None:
        if size < MIN_SIZE:
            raise ValueError(f"Buffer size must be >= {MIN_SIZE}")
        self._buf = bytearray(size)
        self._cursor = 0

    @property
    def capacity(self) -> int:
        return len(self._buf)

    def __len__(self) -> int:
        return self._cursor

    def data(self) -> bytes:
        """The written prefix (reference: src/buffer.rs:32)."""
        return bytes(self._buf[: self._cursor])

    def consume(self) -> None:
        """Reset the cursor, discarding staged data (src/buffer.rs:38)."""
        self._cursor = 0

    def spare_capacity_mut(self) -> memoryview:
        """Writable region after the cursor (src/buffer.rs:44)."""
        return memoryview(self._buf)[self._cursor :]

    # -- codec integration (reference: Buffer::encode / Buffer::decode,
    # src/encoder/mod.rs:395-412, src/decoder/mod.rs:507-531) --------------
    def encode(self, encoder, input_data, op: EncodeOp) -> tuple[int, "Encode"]:
        """Encode ``input_data`` into this buffer's spare capacity.

        Returns ``(bytes_consumed, Encode)`` so the caller can advance its
        input slice, mirroring ``Buffer::encode`` returning
        ``(consumed, status)`` (src/encoder/mod.rs:403-410).
        """
        spare = self.spare_capacity_mut()
        result = encoder.encode(input_data, spare, op)
        written = len(spare) - result.output_remain
        self._cursor += written
        consumed = len(input_data) - result.input_remain
        return consumed, result

    def decode(self, decoder, input_data) -> tuple[int, "Decode"]:
        """Decode ``input_data`` into this buffer's spare capacity
        (reference: src/decoder/mod.rs:507-531)."""
        spare = self.spare_capacity_mut()
        result = decoder.decode(input_data, spare)
        written = len(spare) - result.output_remain
        self._cursor += written
        consumed = len(input_data) - result.input_remain
        return consumed, result
