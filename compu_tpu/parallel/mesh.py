"""Multi-chip distribution: shard_map encode over a device mesh.

Compression has one natural parallel axis — independent blocks (SURVEY
§2c: DEFLATE blocks / zstd frames are self-contained) — so the principal
mesh axis is ``dp``: blocks shard across devices, each device runs the
block kernel locally, and the only cross-device coupling is ordering
metadata:

* ``all_gather`` of per-block compressed lengths (to compute output
  offsets for ordered reassembly);
* ``psum`` of total compressed bytes (scheduler accounting);
* the ragged payload gather itself happens at host assembly (payloads are
  variable-length; lengths ride ICI, bytes ride host DMA).

A secondary ``lane`` axis demonstrates intra-block sharding (the
sequence-parallel analogue): crc32 lane registers of one block split
across devices and merge with a gather — checksum algebra is associative,
so lanes are location-free.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..kernels.deflate_jax_v3 import encode_block_dyn
from ..kernels.checksum_jax import crc32_lane_registers


def make_sharded_encode_step(mesh: Mesh, *, depth: int = 8, nice: int = 128,
                             lazy: bool = True):  # nice/lazy kept for API compat
    """Build the jitted multi-chip encode step.

    ``step(blocks u8[B, N], lens i32[B])`` with B divisible by the dp axis
    size. Blocks shard over ``dp``; every device encodes its local blocks
    sequentially (lax.map), then lengths are all-gathered so each device —
    and the host — knows the global offsets. Returns
    (out u8[B, cap] sharded, out_lens i32[B] replicated,
    adlers u32[B] replicated, total_bytes i32 replicated).
    """

    def local_encode(blocks, lens):
        def one(args):
            block, n = args
            # v3 kernel: sort-carried matching, matmul parse, device-built
            # dynamic Huffman trees, matmul pack.
            return encode_block_dyn(block, n, depth=min(depth, 8))

        outs, metas = jax.lax.map(one, (blocks, lens))
        out_lens = metas[:, 0]
        adlers = metas[:, 1]
        # Ordering metadata rides the ICI: lengths + checksums to everyone.
        gathered_lens = jax.lax.all_gather(out_lens, "dp", tiled=True)
        gathered_adlers = jax.lax.all_gather(adlers, "dp", tiled=True)
        total = jax.lax.psum(jnp.sum(out_lens), "dp")
        return outs, gathered_lens, gathered_adlers, total

    sharded = shard_map(
        local_encode,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp")),
        out_specs=(P("dp", None), P(), P(), P()),
        check_vma=False,  # all_gather outputs are replicated by construction
    )
    return jax.jit(sharded)


def make_stream_sharded_literal_step(mesh: Mesh, *, cap: int):
    """Intra-block sequence-parallel analogue on a REAL codec stage: the
    four Huffman literal streams of a zstd block are independent BY FORMAT
    DESIGN (RFC 8878 §3.1.1.3 — that is why the 4-stream variant exists),
    so one block's entropy coding shards across devices: stream lanes
    spread over ``dp``, each device packs its local lanes
    (kernels/zstd_literals_jax.py's writer, byte-identical to the host
    BackwardBitWriter), and an all_gather returns every stream + length
    replicated for host assembly. With 8 devices and 2 blocks, each
    block's four streams genuinely span four devices — cross-device
    sharding INSIDE one block, not just block data-parallelism.

    ``step(mat u8[L, P], counts i32[L], code u32[256], nbits i32[256])``
    with L divisible by the dp axis size; returns
    (streams u8[L, cap] replicated, nbytes i32[L] replicated)."""
    from ..kernels.zstd_literals_jax import _encode_streams

    def local(mat, counts, code, nbits):
        out, nb = _encode_streams(mat, counts, code, nbits, cap=cap)
        return (jax.lax.all_gather(out, "dp", tiled=True),
                jax.lax.all_gather(nb, "dp", tiled=True))

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp"), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,  # all_gather outputs are replicated by construction
    )
    return jax.jit(sharded)


def make_lane_sharded_crc(mesh: Mesh, *, lanes_per_device: int = 256):
    """crc32 lane registers of one block, lanes sharded over the ``lane``
    mesh axis (intra-block parallelism). Returns all lane registers
    replicated; the host folds them with the GF(2) algebra."""

    def local(block_shard):
        regs = crc32_lane_registers(block_shard[0], lanes=lanes_per_device)
        return jax.lax.all_gather(regs, "lane", tiled=True)[None]

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, "lane"),),
        out_specs=P(None, None),
        check_vma=False,  # all_gather output is replicated by construction
    )
    return jax.jit(sharded)


def default_mesh(axis: str = "dp") -> Mesh:
    """1-D mesh over every visible device."""
    devices = np.asarray(jax.devices())
    return Mesh(devices, (axis,))
