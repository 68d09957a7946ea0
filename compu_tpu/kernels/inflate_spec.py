"""Speculative-resync device inflate for FOREIGN (unindexed) streams.

Implements the entry-phase design of docs/DEVICE_DECODE.md: a foreign
deflate block's token boundaries are unknown, but every lit+dist token is
at most 48 bits, so the decode trajectory enters a C-bit chunk at one of
48 bit offsets relative to the chunk start. Each (chunk, phase) lane
decodes speculatively with the 15-bit direct LUTs (inflate_jax_lut) and
multi-token steps, recording tokens + its exit phase into the next chunk;
the true trajectory is the orbit of the phase maps from the block's first
token bit — a trivial sequential walk over ~(compressed_bits / C) bytes
of per-chunk exit phases on the host, after which the true lanes' records
become authoritative and feed a stream-global expansion / back-reference
resolution (window history flows across deflate blocks, unlike the
independent-block indexed path).

Worst-case amplification is 48 speculative lanes per chunk; measured
merge behavior (most phase pairs converge within a few symbols) would
allow retiring lanes early — not implemented; this is the correctness +
parallelism form. Wave structure: the driver scans WAVE_CHUNKS chunks per
dispatch (block ends are discovered, not known), continuing until the
composed trajectory hits the block's EOB.

Reference parity: foreign-stream decode of inflate
(reference src/decoder/zlib.rs:97; golden-fixture oracle
reference tests/decoder.rs:8-19), as a device pipeline.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..formats.deflate import consts
from .inflate_jax import rel_mod
from .inflate_jax_lut import _dist_lut_block, _lit_lut_block, _mux12

FBITS = 15          # RFC max code length — foreign streams use full range
PHASES = 48         # max token bits: 15+5+15+13
C = 512             # chunk bits per speculative lane
WAVE_CHUNKS = 256   # chunks per dispatch (16 KiB of compressed bits)
KF = 4              # token slots per step
RF = 192            # record slots per lane (tokens can be as short as
                    # 2 bits with degenerate dynamic codes; overflow sets
                    # the lane's bad flag and the driver falls back)
FSTEPS = RF // KF


@functools.partial(jax.jit, static_argnames=())
def build_foreign_luts(lit_lens: jnp.ndarray, dist_lens: jnp.ndarray):
    """15-bit direct LUTs for ONE block's host-parsed code lengths."""
    return (_lit_lut_block(lit_lens, FBITS), _dist_lut_block(dist_lens, FBITS))


@functools.partial(jax.jit, static_argnames=())
def spec_scan_wave(comp12: jnp.ndarray, lit_lut: jnp.ndarray,
                   dist_lut: jnp.ndarray, wave_bit0: jnp.ndarray,
                   total_bits: jnp.ndarray):
    """Speculatively decode WAVE_CHUNKS x PHASES lanes.

    comp12: (W, 12) overlapping 12-word row view of the whole stream.
    wave_bit0: absolute bit offset of the wave's first chunk boundary.
    Returns per-lane (exit_rel, eob_bit, flags, nrec, outbytes) and the
    (RF, L) record rows: outlen(9) | is_lit(1) | payload(15).
    flags bit0 = EOB hit, bit1 = bad/overflow.
    """
    L = WAVE_CHUNKS * PHASES
    lane = jnp.arange(L, dtype=jnp.int32)
    chunk = lane // PHASES
    phase = lane % PHASES
    bit_start = wave_bit0 + chunk * C + phase
    chunk_end = wave_bit0 + (chunk + 1) * C

    def step(carry):
        t, bit, outp, nrec, done, eob, bad, eob_bit, t_rec = carry
        gword = bit >> 5
        row = gword >> 2
        w = jnp.take(comp12, jnp.clip(row, 0, comp12.shape[0] - 1), axis=0)
        ph = ((bit & 31) + ((gword & 3) << 5)).astype(jnp.int32)
        active = ~done
        recs = []
        for _ in range(KF):
            fits = ph <= 319
            live = active & fits & ~done
            q = ph >> 5
            sh = (ph & 31).astype(jnp.uint32)
            w0 = _mux12(w, q)
            w1 = _mux12(w, q + 1)
            w2 = _mux12(w, q + 2)
            nz = sh > 0
            inv = (jnp.uint32(32) - sh) & jnp.uint32(31)
            lo = (w0 >> sh) | jnp.where(nz, w1 << inv, jnp.uint32(0))
            hi = (w1 >> sh) | jnp.where(nz, w2 << inv, jnp.uint32(0))

            a = lit_lut[(lo & ((1 << FBITS) - 1)).astype(jnp.int32)]
            kind = a & 3
            clen = (a >> 2) & 15
            lxb = (a >> 6) & 7
            arg = (a >> 9) & 0xFF
            is_lit = live & (kind == 0)
            is_m = live & (kind == 1)
            is_eob = live & (kind == 2)
            bad = bad | (live & (kind == 3))
            lextra = ((lo >> clen.astype(jnp.uint32)).astype(jnp.int32)
                      & ((1 << lxb) - 1))
            mlen = 3 + arg + lextra
            dsh = (clen + lxb).astype(jnp.uint32)
            wB = (lo >> dsh) | jnp.where(
                dsh > 0, hi << ((jnp.uint32(32) - dsh) & jnp.uint32(31)),
                jnp.uint32(0))
            d = dist_lut[(wB & ((1 << FBITS) - 1)).astype(jnp.int32)]
            dvalid = d & 1
            dlen = (d >> 1) & 15
            dxb = (d >> 5) & 15
            dist = 1 + ((d >> 9) & 0x7FFF) + (
                (wB >> dlen.astype(jnp.uint32)).astype(jnp.int32)
                & ((1 << dxb) - 1))
            bad = bad | (is_m & (dvalid == 0))

            adv = jnp.where(is_lit, clen,
                            jnp.where(is_m, clen + lxb + dlen + dxb,
                                      jnp.where(is_eob, clen, 0)))
            outlen = jnp.where(is_lit, 1, jnp.where(is_m, mlen, 0))
            emit = is_lit | is_m
            payload = jnp.where(is_lit, arg, dist - 1)
            recs.append(
                jnp.where(emit, outlen, 0).astype(jnp.uint32)
                | (is_lit.astype(jnp.uint32) << 9)
                | (payload.astype(jnp.uint32) << 10)
            )
            eob_bit = jnp.where(is_eob, bit + clen, eob_bit)
            eob = eob | is_eob
            bit = bit + adv
            ph = ph + adv
            outp = outp + outlen
            nrec = nrec + emit.astype(jnp.int32)
            # lane retires past its chunk, at EOB, past the stream, or bad
            done = (done | is_eob | bad | (bit >= chunk_end)
                    | (bit >= total_bits))
        t_rec = jax.lax.dynamic_update_slice(
            t_rec, jnp.stack(recs), (t * KF, 0))
        return (t + 1, bit, outp, nrec, done, eob, bad, eob_bit, t_rec)

    def not_done(carry):
        t = carry[0]
        done = carry[4]
        return (t < FSTEPS) & ~jnp.all(done)

    init = (
        jnp.int32(0),
        bit_start,
        jnp.zeros(L, jnp.int32),
        jnp.zeros(L, jnp.int32),
        bit_start >= total_bits,
        jnp.zeros(L, bool),
        jnp.zeros(L, bool),
        jnp.full(L, -1, jnp.int32),
        jnp.full((RF, L), 0, jnp.uint32),
    )
    t, bit, outp, nrec, done, eob, bad, eob_bit, t_rec = jax.lax.while_loop(
        not_done, step, init)
    bad = bad | (~done)  # record-slot overflow (degenerate short codes)
    exit_rel = jnp.clip(bit - chunk_end, 0, PHASES - 1)
    flags = eob.astype(jnp.int32) | (bad.astype(jnp.int32) << 1)
    return exit_rel, eob_bit, flags, nrec, outp, t_rec.T  # (L, RF)


def make_comp12(comp_bytes: np.ndarray):
    """(W, 12) overlapping row view of the whole compressed stream (same
    layout as the indexed LUT decoder's window rows)."""
    pad = (-len(comp_bytes)) % 16 + 16
    cb = np.concatenate([comp_bytes, np.zeros(pad, np.uint8)])
    c4 = cb.reshape(-1, 4).astype(np.uint32)
    comp32 = c4[:, 0] | (c4[:, 1] << 8) | (c4[:, 2] << 16) | (c4[:, 3] << 24)
    A = comp32.reshape(-1, 4)
    A1 = np.concatenate([A[1:], np.zeros((1, 4), np.uint32)])
    A2 = np.concatenate([A[2:], np.zeros((2, 4), np.uint32)])
    return jnp.asarray(np.concatenate([A, A1, A2], axis=1))


@functools.partial(jax.jit, static_argnames=("total_out",))
def resolve_foreign(outlens: jnp.ndarray, is_lit: jnp.ndarray,
                    payload: jnp.ndarray, starts: jnp.ndarray,
                    stored_out: jnp.ndarray, stored_mask: jnp.ndarray,
                    *, total_out: int):
    """Stream-global expansion + back-reference resolution from an ordered
    token list (the composed true trajectory of every block).

    outlens/is_lit/payload/starts: (T,) ordered tokens (outlen 0 = inert
    padding). stored_out/stored_mask: (total_out,) bytes + mask for
    stored-block ranges (their positions are literal roots directly).
    Returns (out u8[total_out], ok i32[1])."""
    NT = total_out
    T = outlens.shape[0]
    valid_tok = outlens > 0
    slot_at = jnp.zeros(NT + 512, jnp.int32).at[
        jnp.clip(starts, 0, NT + 511)
    ].max(jnp.where(valid_tok, jnp.arange(T, dtype=jnp.int32) + 1, 0))[:NT]
    tokid = jnp.clip(jax.lax.cummax(slot_at) - 1, 0, T - 1)

    gp = jnp.arange(NT, dtype=jnp.int32)
    start_of = starts[tokid]
    lit_of = is_lit[tokid]
    pay_of = payload[tokid]
    dist_of = pay_of + 1
    relmod = rel_mod(gp - start_of, dist_of)
    src = start_of - dist_of + relmod
    root = jnp.where(lit_of, -(pay_of + 1), jnp.clip(src, 0, NT - 1))
    # stored ranges are literal fixpoints
    root = jnp.where(stored_mask, -(stored_out.astype(jnp.int32) + 1), root)

    max_iters = max(1, int(np.ceil(np.log2(max(NT, 2)))))

    def not_done(carry):
        root, unresolved, it = carry
        return (unresolved > 0) & (it < max_iters)

    def advance(carry):
        root, _, it = carry
        hop = root[jnp.maximum(root, 0)]
        root = jnp.where(root >= 0, hop, root)
        hop = root[jnp.maximum(root, 0)]
        root = jnp.where(root >= 0, hop, root)
        return root, jnp.sum((root >= 0).astype(jnp.int32)), it + 1

    unres0 = jnp.sum((root >= 0).astype(jnp.int32))
    root, _, _ = jax.lax.while_loop(not_done, advance,
                                    (root, unres0, jnp.int32(0)))
    out = (jnp.where(root < 0, -root, 1) - 1).astype(jnp.uint8)
    ok = jnp.all(root < 0)
    return out, jnp.where(ok, 1, 0).astype(jnp.int32).reshape(1)
