"""Hybrid pipelines: device LZ stage feeding the host entropy coders.

All three formats consume the same token-cover contract
(tok_pos, tok_len, tok_dist). DEFLATE's device path stays fully on device
(kernels/deflate_jax_v2.py); zstd and brotli run the shared device
match+parse kernel and keep their entropy stages (FSE / prefix codes) on
the host. Enable per-encoder via the ``device_lz`` option.
"""

from __future__ import annotations

import numpy as np


class DeviceTokenizer:
    """Pads chunks to a fixed block shape and runs the jitted LZ stage.

    One compiled executable per (block_size, max_dist, depth).
    """

    def __init__(self, block_size: int, max_dist: int, depth: int = 8) -> None:
        self.block_size = block_size
        self.max_dist = min(max_dist, block_size)
        self.depth = depth

    def __call__(self, data: bytes):
        import jax.numpy as jnp

        from ..kernels.deflate_jax_v2 import device_match_tokens, device_tokens

        n = len(data)
        padded = np.zeros(self.block_size, dtype=np.uint8)
        padded[:n] = np.frombuffer(data, dtype=np.uint8)
        # Matches-only D2H (one i64 per match, ~4x fewer bytes than the
        # per-position form); literal tokens are the uncovered gaps. Overflow
        # (count > cap: degenerate min-length covers) falls back to the
        # dense per-position transfer.
        packed, count = device_match_tokens(
            jnp.asarray(padded), jnp.int32(n),
            depth=self.depth, max_dist=self.max_dist,
        )
        count = int(count)
        if count <= packed.shape[0]:
            v = np.asarray(packed[:count]).astype(np.int64)
            mpos = v[:, 0] & 0xFFFFF
            mlen = (v[:, 0] >> 20) & 0x1FF
            mdist = v[:, 1] & 0x1FFFFF
            # covered[i] > 0 inside a match span; token starts = match
            # positions plus every uncovered position (a literal each)
            delta = np.zeros(n + 1, dtype=np.int32)
            np.add.at(delta, mpos, 1)
            np.add.at(delta, np.minimum(mpos + mlen, n), -1)
            covered = np.cumsum(delta[:n]) > 0
            lit_pos = np.nonzero(~covered)[0].astype(np.int64)
            tok_pos = np.concatenate([lit_pos, mpos])
            tok_len = np.concatenate([np.zeros(len(lit_pos), np.int64), mlen])
            tok_dist = np.concatenate([np.zeros(len(lit_pos), np.int64), mdist])
            order = np.argsort(tok_pos, kind="stable")
            return tok_pos[order], tok_len[order], tok_dist[order]
        packed = np.asarray(device_tokens(
            jnp.asarray(padded), jnp.int32(n),
            depth=self.depth, max_dist=self.max_dist,
        ))[:n]
        tok_pos = np.nonzero(packed & 1)[0].astype(np.int64)
        v = packed[tok_pos].astype(np.int64)
        tok_len = (v >> 1) & 0x1FF
        tok_dist = (v >> 10) & 0x1FFFFF
        return tok_pos, tok_len, tok_dist
