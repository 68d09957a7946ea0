"""Device block-codec steps for the block-parallel scheduler.

Transfer discipline:

* ONE bulk H2D of the block matrix (or one per pipelined group);
* one jitted dispatch per batch: the block kernel runs over the whole
  (B, N) matrix, so a batch costs one dispatch instead of B;
* metadata returned as small arrays, fetched in one transfer;
* device-side compaction of the padded per-block outputs into one
  byte buffer (sequential dynamic_update_slice — later blocks overwrite
  the previous block's padding overhang), so D2H is ONE transfer of the
  compressed bytes, rounded up to a whole block cap.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..formats.deflate.options import ZlibMode
from ..ops import checksum
from .deflate_jax_v2 import encode_block_fixed_v2

# level -> (depth, nice, lazy): the host-ladder depth also caps the v2
# kernel's and the streaming device encoder's (formats/deflate/pipeline.py).
_LEVEL = {
    1: (1, 8, False),
    2: (2, 16, False),
    3: (4, 32, False),
    4: (4, 32, True),
    5: (8, 64, True),
    6: (8, 128, True),
    7: (16, 128, True),
    8: (24, 258, True),
    9: (32, 258, True),
}


@functools.partial(
    jax.jit, static_argnames=("depth", "cap", "with_index", "check", "kernel",
                              "wcap", "matcher", "stride", "lex_keys")
)
def _encode_blocks_batched(blocks: jnp.ndarray, lens: jnp.ndarray, *, depth: int,
                           cap: int, with_index: bool, check: str,
                           kernel: str = "v3", wcap: int = 32,
                           matcher: str = "lex", stride: int = 1,
                           lex_keys: int = 2):
    """One jit over the whole (B, N) block matrix: the block kernel plus
    the compaction, so a batch costs ONE dispatch instead of B+1.
    ``kernel`` picks v3 (dynamic/fixed/stored block types) or v2
    (fixed-Huffman only).
    Returns (packed u8[B*cap+cap], metas i32[B,2], segs|None)."""
    if kernel == "v3":
        # Staged batched kernel: token scan / emit lax.map over blocks,
        # tree building vmapped (its bounded loops must not serialize
        # per block — see encode_blocks_dyn).
        from .deflate_jax_v3 import encode_blocks_dyn

        if with_index:
            outs, metas, segs = encode_blocks_dyn(
                blocks, lens, depth=depth, cap=cap, with_index=True,
                check=check, wcap=wcap, matcher=matcher, stride=stride,
                lex_keys=lex_keys,
            )
        else:
            outs, metas = encode_blocks_dyn(
                blocks, lens, depth=depth, cap=cap, with_index=False,
                check=check, wcap=wcap, matcher=matcher, stride=stride,
                lex_keys=lex_keys,
            )
            segs = None
        return _compact(outs, metas, cap), metas, segs

    block_kernel = encode_block_fixed_v2

    def one(args):
        block, n = args
        return block_kernel(
            block, n, depth=depth, cap=cap, with_index=with_index, check=check
        )

    if with_index:
        outs, metas, segs = jax.lax.map(one, (blocks, lens))
    else:
        outs, metas = jax.lax.map(one, (blocks, lens))
        segs = None
    return _compact(outs, metas, cap), metas, segs


def _compact(outs: jnp.ndarray, metas: jnp.ndarray, cap: int) -> jnp.ndarray:
    """Pack B padded block outputs (B, cap) into one contiguous buffer:
    block i lands at sum(lens[:i]); each write covers its full cap window
    and the next block's write overwrites the overhang, so the prefix is
    exactly the concatenated compressed bytes."""
    B = outs.shape[0]
    with jax.named_scope("compaction"):
        offsets = jnp.concatenate(
            [jnp.zeros(1, jnp.int32),
             jnp.cumsum(metas[:, 0].astype(jnp.int32))[:-1]])
        buf = jnp.zeros(B * cap + cap, dtype=jnp.uint8)

        def body(i, buf):
            return jax.lax.dynamic_update_slice(buf, outs[i], (offsets[i],))

        return jax.lax.fori_loop(0, B, body, buf)


def make_block_encode_fn(mode: ZlibMode, level: int = 6,
                         kernel: str = "v3", segment_index: bool = False,
                         pipeline_groups: int = 1):
    """Returns ``fn(blocks u8[B,N], lens i32[B]) -> (outs: list[np.uint8],
    out_lens[B], checks[B])`` where ``checks`` are adler32 (zlib) or crc32
    (gzip) of each block — the contract BlockParallelEncoder expects.

    ``kernel='v3'`` (default) adds per-block dynamic-Huffman trees and
    stored blocks to the gather-minimal sort/matmul kernel; ``'v2'`` is
    the fixed-Huffman-only variant."""
    if kernel not in ("v2", "v3"):
        raise ValueError(f"unknown device kernel {kernel!r}")
    depth = _LEVEL[max(1, min(9, level))][0]
    # Device ladder for the lex/LCP matcher (lcp_match.py): the
    # adjacent-LCP composition makes small depths match hash-scan-32
    # quality (on the 4 MB bench slice: lex keys2 d16 ratio 3.960 vs hash
    # d32 ratio 3.942). Fast levels add stride-2 anchor sampling (halves
    # sort/candidate elements at ~13% ratio cost — the zlib-fast
    # tradeoff).
    dev_wcap = {1: 8, 2: 8, 3: 8, 4: 16, 5: 16, 6: 16, 7: 16, 8: 16, 9: 16}
    dev_depth = {1: 4, 2: 6, 3: 8, 4: 8, 5: 12, 6: 16, 7: 24, 8: 32, 9: 48}
    dev_keys = {1: 1, 2: 1, 3: 1, 4: 1, 5: 2, 6: 2, 7: 2, 8: 2, 9: 2}
    dev_stride = {1: 2, 2: 2, 3: 2, 4: 1, 5: 1, 6: 1, 7: 1, 8: 1, 9: 1}
    lvl = max(1, min(9, level))
    wcap = dev_wcap[lvl]
    vdepth = dev_depth[lvl]
    vkeys = dev_keys[lvl]
    vstride = dev_stride[lvl]

    check = "crc" if mode is ZlibMode.Gzip else "adler"
    kdepth = vdepth if kernel == "v3" else min(depth, 8)

    def fn(blocks: np.ndarray, lens: np.ndarray):
        import time as _time

        t_start = _time.perf_counter()
        B, N = blocks.shape
        # Fixed-Huffman worst case is 9 bits/byte (+ tiny block overhead),
        # so N + N//4 capacity is safe and trims the D2H transfer.
        cap = N + N // 4 + 64
        G = pipeline_groups if (pipeline_groups > 1 and B % pipeline_groups == 0
                                and B >= 2 * pipeline_groups) else 1
        # Pipelined groups: group g's dispatch overlaps group g+1's H2D
        # upload (both async; the runtime orders per-buffer).
        gb = B // G
        lens_j = jnp.asarray(lens, jnp.int32)
        dev = jax.device_put(blocks[:gb])
        parts = []
        for g in range(G):
            parts.append(_encode_blocks_batched(
                dev, lens_j[g * gb : (g + 1) * gb], depth=kdepth, cap=cap,
                with_index=segment_index, check=check, kernel=kernel,
                wcap=wcap, lex_keys=vkeys, stride=vstride,
            ))
            if g + 1 < G:
                dev = jax.device_put(blocks[(g + 1) * gb : (g + 2) * gb])
        small = [p[1].reshape(-1) for p in parts]
        if segment_index:
            small += [p[2].reshape(-1) for p in parts]
        t_dispatched = _time.perf_counter()
        small_h = np.asarray(jnp.concatenate(small))  # sync 1 (small)
        t_meta = _time.perf_counter()
        meta_host = small_h[: 2 * B].reshape(B, 2)
        out_lens = meta_host[:, 0].astype(np.int32)
        checks = meta_host[:, 1].astype(np.uint32)
        seg_index = (
            small_h[2 * B :].reshape(B, -1).astype(np.int32) if segment_index else None
        )
        # Each group's buffer holds its own compacted prefix; fetch it
        # (sync 2: the compressed bytes). The slice length is rounded up
        # to whole block caps: every distinct static slice size is a new
        # executable, and an exact size would compile once per call.
        flat = np.concatenate([
            np.asarray(p[0][: -(-tg // cap) * cap])[:tg]
            for p, tg in zip(parts, (int(out_lens[g * gb : (g + 1) * gb].sum())
                                     for g in range(G)))])
        t_payload = _time.perf_counter()
        offsets = np.concatenate([[0], np.cumsum(out_lens)])
        out = [flat[offsets[i] : offsets[i + 1]] for i in range(B)]
        if mode is ZlibMode.Gzip:
            # meta carries the raw init-0 register of the padded block:
            # fold in the init register, strip the pad, finalize.
            front = checksum.crc_shift(0xFFFFFFFF, N)
            crcs = np.empty(B, dtype=np.uint32)
            for i in range(B):
                reg = front ^ int(checks[i])
                reg = checksum.crc_unshift(reg, N - int(lens[i]))
                crcs[i] = reg ^ 0xFFFFFFFF
            checks = crcs
        # per-call transfer/compute budget for the bench's e2e breakdown
        # (h2d+dispatch are async-overlapped; sync_meta is the first point
        # the host blocks on device completion, so it carries kernel time
        # plus the H2D it waited on; payload_d2h is the compressed-bytes
        # fetch; host_asm is framing/crc bookkeeping)
        fn.last_timings = {
            "h2d_dispatch_ms": round(1e3 * (t_dispatched - t_start), 1),
            "sync_meta_ms": round(1e3 * (t_meta - t_dispatched), 1),
            "payload_d2h_ms": round(1e3 * (t_payload - t_meta), 1),
            "host_asm_ms": round(1e3 * (_time.perf_counter() - t_payload), 1),
        }
        if segment_index:
            return out, out_lens, checks, seg_index
        return out, out_lens, checks

    return fn
