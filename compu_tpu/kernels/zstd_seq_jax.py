"""Device FSE sequence-section encoding for zstd (RFC 8878 §3.1.1.4).

Joins the device LZ stage and the device 4-stream literals into a full
device zstd block-entropy path: the three interleaved FSE state chains
(LL / ML / OF) and the bitstream pack run on device; the host keeps only
the table construction (tiny: <=512-entry CTables from the normalized
counts it already built for the section header) and the mode selection.

The state chains are inherently sequential (state_i depends on
state_{i+1}); they run as ONE ``lax.scan`` over the sequence list in push
order — a single dispatch whose step is three 512-entry gathers — and the
resulting push list (6 fields per sequence + head extras + tail flushes)
packs through a cumsum + 4-lane scatter-add, the same byte-disjoint trick
as the DEFLATE emit. Output is byte-identical to the host
ForwardBitWriter path (asserted in tests), so frames stay foreign-valid.

An associative formulation (compose the per-symbol state maps with
one-hot matmuls, log-depth) exists if the scan step count ever dominates;
at <=7K sequences per 256 KiB block the single scan is not the
bottleneck.

Reference parity: the sequence half of ZSTD_compressStream2's block
entropy (reference src/encoder/zstd.rs:156-198), on device.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

STBL = 512  # max FSE table size (table_log <= 9 for LL/ML, 8 for OF)
NSYM = 64   # max symbol count (LL 36, ML 53, OF ~32)


def _chan_arrays(table):
    """Pad one FseEncodeTable (or None) to fixed device shapes."""
    st = np.zeros(STBL, np.int32)
    dnb = np.zeros(NSYM, np.int32)
    df = np.zeros(NSYM, np.int32)
    if table is None:
        return st, dnb, df, np.int32(0), np.int32(0)
    n = 1 << table.table_log
    st[:n] = table.state_table
    k = len(table.delta_nbits)
    dnb[:k] = table.delta_nbits
    df[:k] = table.delta_find
    return st, dnb, df, np.int32(table.table_log), np.int32(1)


@functools.partial(jax.jit, static_argnames=("cap",))
def _seq_bitstream(codes, xvals, xbits, inits, st, dnb, df, logs, ens,
                   nseq, *, cap):
    """codes/xvals/xbits: i32[3, P] per channel in SEQ ORDER (ll, ml, of);
    inits: i32[3] initial states (from seq nseq-1); st/dnb/df: per-channel
    tables (3, ...); logs/ens: i32[3]. Returns (bytes u8[cap], nbits)."""
    P = codes.shape[1]

    # --- state scan over i = nseq-2 .. 0 (push order) -------------------
    # scan step j handles seq i = nseq-2-j; masked beyond the real count.
    idx = nseq - 2 - jnp.arange(P, dtype=jnp.int32)          # (P,)
    valid = idx >= 0
    gather_idx = jnp.clip(idx, 0, P - 1)
    c_sc = jnp.take_along_axis(codes, gather_idx[None, :].repeat(3, 0), axis=1)

    def step(states, xs):
        code3, ok = xs
        nb = (states + jnp.take_along_axis(dnb, code3[:, None], axis=1)[:, 0]
              ) >> 16
        pushv = states
        nstate = jnp.take_along_axis(
            st,
            jnp.clip((states >> jnp.maximum(nb, 0))
                     + jnp.take_along_axis(df, code3[:, None], axis=1)[:, 0]
                     - STBL * 0, 0, STBL - 1)[:, None],
            axis=1)[:, 0]
        nb = jnp.where(ok & (ens > 0), nb, 0)
        states = jnp.where(ok & (ens > 0), nstate, states)
        return states, (pushv, nb)

    final_states, (push_v, push_b) = jax.lax.scan(
        step, inits, (c_sc.T, valid))
    # push_v/push_b: (P, 3) in channel order (ll, ml, of) — push order per
    # seq is of, ml, ll states then ll_x, ml_x, of_x extras.
    x_sc = jnp.take_along_axis(xvals, gather_idx[None, :].repeat(3, 0), axis=1)
    xb_sc = jnp.take_along_axis(xbits, gather_idx[None, :].repeat(3, 0), axis=1)
    vmask = valid[:, None]
    fields_v = jnp.concatenate([
        push_v[:, 2:3], push_v[:, 1:2], push_v[:, 0:1],   # of, ml, ll states
        x_sc.T[:, 0:1], x_sc.T[:, 1:2], x_sc.T[:, 2:3],   # ll_x, ml_x, of_x
    ], axis=1)                                            # (P, 6)
    fields_b = jnp.concatenate([
        push_b[:, 2:3], push_b[:, 1:2], push_b[:, 0:1],
        xb_sc.T[:, 0:1], xb_sc.T[:, 1:2], xb_sc.T[:, 2:3],
    ], axis=1)
    fields_b = jnp.where(vmask, fields_b, 0)

    # --- head (last seq's extras) + body + tail (flushes + sentinel) ----
    last = jnp.clip(nseq - 1, 0, P - 1)
    head_v = jnp.stack([xvals[0, last], xvals[1, last], xvals[2, last]])
    head_b = jnp.stack([xbits[0, last], xbits[1, last], xbits[2, last]])
    # flushes: ml, of, ll states at table_log bits (enabled channels only)
    tail_v = jnp.stack([final_states[1], final_states[2], final_states[0],
                        jnp.int32(1)])
    tail_b = jnp.stack([
        jnp.where(ens[1] > 0, logs[1], 0),
        jnp.where(ens[2] > 0, logs[2], 0),
        jnp.where(ens[0] > 0, logs[0], 0),
        jnp.int32(1),  # the finish() sentinel bit
    ])
    all_v = jnp.concatenate([head_v, fields_v.reshape(-1), tail_v]
                            ).astype(jnp.uint32)
    all_b = jnp.concatenate([head_b, fields_b.reshape(-1), tail_b])
    all_v = all_v & ((jnp.uint32(1) << all_b.astype(jnp.uint32))
                     - jnp.uint32(1))

    off = jnp.concatenate([jnp.zeros(1, jnp.int32),
                           jnp.cumsum(all_b)])
    total_bits = off[-1]
    off = off[:-1]
    sh = (off & 7).astype(jnp.uint32)
    shifted = jnp.where(all_b > 0, all_v << sh, 0)  # values < 2^25: exact
    base = off >> 3
    out = jnp.zeros(cap, jnp.int32)
    for k in range(4):
        out = out.at[jnp.clip(base + k, 0, cap - 1)].add(
            ((shifted >> jnp.uint32(8 * k)) & jnp.uint32(0xFF)
             ).astype(jnp.int32))
    return (out & 0xFF).astype(jnp.uint8), total_bits


def encode_sequences_device(ll_codes, ml_codes, of_codes, ll_x, ml_x, of_x,
                            ll_xb, ml_xb, of_xb, ll_t, ml_t, of_t) -> bytes:
    """Device twin of _sequences_section's push loop. Tables are the
    host-selected FseEncodeTable per channel (None = RLE/omitted channel —
    no state pushes). Returns the bitstream bytes (without the section
    headers, which the host already wrote)."""
    n = len(ll_codes)
    P = 1 << max(4, (n - 1).bit_length())
    pad = P - n

    def prep(a):
        return np.concatenate([np.asarray(a, np.int32), np.zeros(pad, np.int32)])

    codes = np.stack([prep(ll_codes), prep(ml_codes), prep(of_codes)])
    xvals = np.stack([prep(ll_x), prep(ml_x), prep(of_x)])
    xbits = np.stack([prep(ll_xb), prep(ml_xb), prep(of_xb)])
    chans = [_chan_arrays(t) for t in (ll_t, ml_t, of_t)]
    st = np.stack([c[0] for c in chans])
    dnb = np.stack([c[1] for c in chans])
    df = np.stack([c[2] for c in chans])
    logs = np.stack([c[3] for c in chans])
    ens = np.stack([c[4] for c in chans])
    inits = np.asarray([
        t.init_state(int(c[-1])) if t is not None else 0
        for t, c in ((ll_t, ll_codes), (ml_t, ml_codes), (of_t, of_codes))
    ], np.int32)
    # worst-case bits: 6 fields x (25 bits) per seq + head/tail
    cap = (P * 6 * 32) // 8 + 64
    out, total_bits = _seq_bitstream(
        jnp.asarray(codes), jnp.asarray(xvals), jnp.asarray(xbits),
        jnp.asarray(inits), jnp.asarray(st), jnp.asarray(dnb),
        jnp.asarray(df), jnp.asarray(logs), jnp.asarray(ens),
        jnp.int32(n), cap=cap)
    nb = int(np.asarray(total_bits))
    return np.asarray(out)[: (nb + 7) // 8].tobytes()
