"""Batched Huffman decode in XLA: one token chain per read, reads in
parallel (the CPU path of the multi-scheme DB decode).

A single Huffman stream is bit-serial, but a Dazzler DB stores every read's
stream offset (``coff`` in .idx), and within an entry the later streams'
offsets follow arithmetically from the earlier ones — so decoding a block
of N reads is N independent chains (SURVEY §7 "hard parts (a)").  Each
``fori_loop`` iteration advances every active lane by one symbol:

    peek 16 bits (three u8 gathers + shifts — streams start at arbitrary
    byte offsets), look up the 64K table of the lane's scheme, advance by
    the code length, handle the escape literal with a second peek.

Outputs are written column-wise (symbol j of every lane at iteration j) for
plain streams; RLE streams decode (runlen, literal) token pairs that a
vectorized cumsum/scatter pass expands afterwards.

The total bit count and final emission width per lane feed the encoder's
word-count formula so the caller can chain to each entry's next stream.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def _peek16(buf, base_bytes, bitpos):
    """16-bit big-endian-bit-order window at absolute bit position."""
    byte = base_bytes + (bitpos >> 3)
    b0 = buf[byte].astype(jnp.uint32)
    b1 = buf[jnp.minimum(byte + 1, buf.shape[0] - 1)].astype(jnp.uint32)
    b2 = buf[jnp.minimum(byte + 2, buf.shape[0] - 1)].astype(jnp.uint32)
    win = (b0 << 16) | (b1 << 8) | b2
    return (win >> (8 - (bitpos & 7))) & 0xFFFF


def _word_peek16(buf, base_bytes, bitpos):
    """Peek matching the C decoder's little-endian u32 word stream.

    The stream is a sequence of LE u32 words; bit 0 is the MSB of word 0's
    *value*.  Bit position p lives in word w = p>>5; assemble the 64-bit
    window from two words and shift.
    """
    w = base_bytes + (bitpos >> 5) * 4
    n = buf.shape[0]

    def word(at):
        # caller pads the buffer with >= 8 trailing zero bytes
        b = lambda k: buf[jnp.minimum(at + k, n - 1)].astype(jnp.uint32)
        return (b(0) | (b(1) << jnp.uint32(8)) | (b(2) << jnp.uint32(16))
                | (b(3) << jnp.uint32(24)))

    w0 = word(w)
    w1 = word(w + 4)
    # keep every operand unsigned: mixing int32 shift amounts would promote
    # the whole expression to int32 and make >> arithmetic
    p = (bitpos & 31).astype(jnp.uint32)
    hi = jnp.where(p == 0, w0,
                   (w0 << p) | (w1 >> (jnp.uint32(32) - jnp.maximum(p, 1))))
    return (hi >> jnp.uint32(16)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("max_len",))
def decode_plain_batch(buf, starts, rlens, scheme_ids, lookups, lens_tbl,
                       types, *, max_len: int):
    """Decode N plain streams in parallel.

    buf:        (B,) u8 — whole container image
    starts:     (N,) i64 byte offset of each stream
    rlens:      (N,) i32 symbols to decode per stream
    scheme_ids: (N,) i32 index into the scheme tables
    lookups:    (S, 65536) i32; lens_tbl: (S, 256) i32; types: (S,) i32

    Returns (symbols (N, max_len) u8, total_bits (N,), last_gran (N,)).
    """
    n = starts.shape[0]
    signal = jnp.where(types[scheme_ids] == 2, 255, 256)

    def body(j, carry):
        pos, last, out = carry
        active = j < rlens
        peek = _word_peek16(buf, starts, pos)
        sym = lookups[scheme_ids, peek]
        nbits = lens_tbl[scheme_ids, sym]
        pos2 = pos + nbits
        esc = active & (sym == signal)
        peek2 = _word_peek16(buf, starts, pos2)
        lit = (peek2 >> 8) & 0xFF
        sym = jnp.where(esc, lit.astype(jnp.int32), sym)
        width = jnp.where(esc, 8, nbits)
        pos3 = jnp.where(active, pos2 + jnp.where(esc, 8, 0), pos)
        last = jnp.where(active, width, last)
        out = out.at[:, j].set(jnp.where(active, sym, 0).astype(jnp.uint8))
        return pos3, last, out

    # derive the carries from a varying input so the loop is shard_map-safe
    # (a plain jnp.zeros would be replicated and trip the vma check)
    z = rlens * 0
    out0 = jnp.broadcast_to(z.astype(jnp.uint8)[:, None], (n, max_len))
    pos, last, out = jax.lax.fori_loop(0, max_len, body, (z, z, out0))
    return out, pos, last


@functools.partial(jax.jit, static_argnames=("max_tokens",))
def decode_run_batch(buf, starts, rlens, sym_ids, run_ids, lookups, lens_tbl,
                     types, *, max_tokens: int):
    """Decode N RLE streams into (runlen, literal) token pairs.

    Each iteration consumes one run token (code [+16-bit length literal])
    and, while symbols remain, one literal token (code [+8-bit literal]).
    Returns (runlens (N, T) i32, lits (N, T) i32 with -1 for none,
             n_tokens (N,), total_bits (N,), last_gran (N,)).
    """
    n = starts.shape[0]
    nsignal = jnp.where(types[sym_ids] == 2, 255, 256)

    def body(j, carry):
        pos, emitted, last, runs, lits = carry
        active = emitted < rlens

        peek = _word_peek16(buf, starts, pos)
        c = lookups[run_ids, peek]
        nb = lens_tbl[run_ids, c]
        pos1 = pos + nb
        resc = active & (c == 255)
        runlit = _word_peek16(buf, starts, pos1)
        runlen = jnp.where(resc, runlit.astype(jnp.int32), c)
        pos2 = pos1 + jnp.where(resc, 16, 0)
        width = jnp.where(resc, 16, nb)
        emitted1 = jnp.minimum(emitted + runlen, rlens)

        need_sym = active & (emitted1 < rlens)
        peek2 = _word_peek16(buf, starts, pos2)
        s = lookups[sym_ids, peek2]
        snb = lens_tbl[sym_ids, s]
        pos3 = pos2 + jnp.where(need_sym, snb, 0)
        sesc = need_sym & (s == nsignal)
        peek3 = _word_peek16(buf, starts, pos3)
        slit = (peek3 >> 8) & 0xFF
        s = jnp.where(sesc, slit.astype(jnp.int32), s)
        pos4 = pos3 + jnp.where(sesc, 8, 0)
        width = jnp.where(need_sym, jnp.where(sesc, 8, snb), width)

        runs = runs.at[:, j].set(jnp.where(active, runlen, 0))
        lits = lits.at[:, j].set(jnp.where(need_sym, s, -1))
        pos = jnp.where(active, pos4, pos)
        last = jnp.where(active, width, last)
        emitted = jnp.where(active, emitted1 + need_sym.astype(jnp.int32),
                            emitted)
        return pos, emitted, last, runs, lits

    # carries derived from a varying input (see decode_plain_batch)
    z = rlens * 0
    runs0 = jnp.broadcast_to(z[:, None], (n, max_tokens))
    lits0 = runs0 - 1
    pos, emitted, last, runs, lits = jax.lax.fori_loop(
        0, max_tokens, body, (z, z, z, runs0, lits0))
    return runs, lits, emitted, pos, last



def expand_runs_np(runs: np.ndarray, lits: np.ndarray, rlens: np.ndarray,
                   rchar: int) -> np.ndarray:
    """Expand (runlen, literal) token pairs into symbol rows (host side)."""
    n, t = runs.shape
    max_len = int(rlens.max(initial=0))
    out = np.full((n, max_len), rchar, np.uint8)
    # literal positions: runlen cumsum + token index
    starts = np.cumsum(runs, axis=1) + np.arange(t)[None, :]
    valid = lits >= 0
    rows = np.repeat(np.arange(n), t).reshape(n, t)
    out[rows[valid], starts[valid]] = lits[valid].astype(np.uint8)
    return out


def stream_word_counts(total_bits: np.ndarray, last_gran: np.ndarray) -> np.ndarray:
    """Encoder word counts from decoder totals (tail-padding rule)."""
    t = total_bits.astype(np.int64)
    olen = t & 31
    llen = (t - last_gran) & 31
    raw = (t + 31) >> 5
    dup = (olen > 0) & (llen > 16) & (olen > llen)
    zext = (olen == 0) & (llen > 16) & (t > 0)
    return raw + dup.astype(np.int64) + zext.astype(np.int64)
