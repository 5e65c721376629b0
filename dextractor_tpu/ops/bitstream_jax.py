"""Batched Huffman bitstream encoding on the device.

The reference encodes one symbol at a time through a 32-bit shift register
(OCODE, QV.c:404-422).  The device formulation turns the whole file into one
data-parallel program over an (N, Lpad) rectangle of streams:

  1. per-symbol emission values/widths via 256-entry LUT gathers
     (escapes fused: code||literal as one <=32-bit emission);
  2. run tokenization via a row-wise exclusive running maximum of literal
     positions (no sequential scan over symbols);
  3. bit offsets via row-wise exclusive cumulative sums;
  4. word assembly via running sums over slots plus one scatter-set per
     word (see ``pack_words`` — word indices are monotone and never skip);
  5. the reference's exact tail-padding (duplicate/zero word) applied as a
     cheap host-side gather using per-row totals.

Every step is elementwise, cumsum, or scatter — shapes are static, so XLA
fuses 1-3 and the step stays HBM-bound.  uint64 is avoided throughout:
hi/lo word contributions use clamped 32-bit shifts.

Scheme tables enter as packed (256,) int32 LUTs (bits<<6 | len<<1 | esc)
so each symbol costs one gather (see ``scheme_luts``).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .huffman import HScheme


def scheme_luts(scheme: HScheme, run: bool = False) -> np.ndarray:
    """Pack a scheme into a (256,) int32 LUT: ``bits << 6 | len << 1 | esc``.

    One gather per symbol recovers all three fields (final schemes have
    codes <= 16 bits and lengths <= 16, so the packing is exact).

    Symbol schemes escape only when type == 2 (Encode, QV.c:397-402); run
    schemes test code-equals-255's-code *unconditionally* (Encode_Run,
    QV.c:468-469), so their flag is set for every bucket sharing 255's code.
    """
    esc = np.zeros(256, np.int64)
    if run or scheme.type == 2:
        esc = ((scheme.codebits == scheme.codebits[255])
               & (scheme.codelens == scheme.codelens[255])).astype(np.int64)
    packed = ((scheme.codebits.astype(np.int64) << 6)
              | (scheme.codelens.astype(np.int64) << 1) | esc)
    return packed.astype(np.int32)


def _excl_cumsum(x, axis):
    c = jnp.cumsum(x, axis=axis)
    return c - x


def _lut_gather(data, lut_i32):
    """256-entry LUT lookup for every element of ``data`` (u8 -> i32)."""
    return lut_i32[data.astype(jnp.int32)]


def _sym_emissions(data, luts):
    """Fused emission (value u32, width, granular-last-width) per symbol.

    One packed-LUT gather per symbol: bits<<6 | len<<1 | esc."""
    packed = _lut_gather(data, luts).astype(jnp.uint32)
    bits = packed >> jnp.uint32(6)
    lens = ((packed >> jnp.uint32(1)) & 31).astype(jnp.int32)
    esc = (packed & 1).astype(jnp.bool_)
    v = jnp.where(esc, (bits << 8) | data.astype(jnp.uint32), bits)
    n = jnp.where(esc, lens + 8, lens)
    gran = jnp.where(esc, 8, lens)
    return v, n, gran


def plain_emissions(data, lengths, luts):
    """Emissions for a non-RLE stream rectangle (N, L).

    Returns (v, n) of shape (N, L) plus (T, last_gran) of shape (N,).
    """
    n_rows, l = data.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (n_rows, l), 1)
    valid = col < lengths[:, None]
    v, n, gran = _sym_emissions(data, luts)
    v = jnp.where(valid, v, 0)
    n = jnp.where(valid, n, 0)
    t = n.sum(axis=1)
    idx = jnp.maximum(lengths - 1, 0)
    last_gran = jnp.where(lengths > 0, jnp.take_along_axis(gran, idx[:, None], 1)[:, 0], 0)
    return v, n, t, last_gran


def run_emissions(data, lengths, rchar, sym_luts, run_luts):
    """Emissions for an RLE stream rectangle (N, L).

    Token layout per row: slots [2i, 2i+1] hold the run emission and the
    literal emission for position i (nonzero only where data[i] != rchar),
    slot 2L holds the trailing run emission.  Run lengths are recovered
    without a sequential walk: an inclusive row max of literal positions,
    shifted, gives the previous literal index at every position.
    """
    n_rows, l = data.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (n_rows, l), 1)
    valid = col < lengths[:, None]
    is_lit = valid & (data != rchar)

    lit_pos = jnp.where(is_lit, col, -1)
    run_max = jax.lax.associative_scan(jnp.maximum, lit_pos, axis=1)
    prev_lit = jnp.concatenate(
        [jnp.full((n_rows, 1), -1, jnp.int32), run_max[:, :-1]], axis=1)
    runlen = col - prev_lit - 1

    # run emission before each literal (escape flag from the LUT: any
    # bucket sharing 255's code escapes, not just 255)
    x = jnp.minimum(runlen, 255)
    rpacked = _lut_gather(x, run_luts).astype(jnp.uint32)
    rb = rpacked >> jnp.uint32(6)
    rl = ((rpacked >> jnp.uint32(1)) & 31).astype(jnp.int32)
    resc = (rpacked & 1).astype(jnp.bool_)
    rv = jnp.where(resc, (rb << 16) | (runlen.astype(jnp.uint32) & 0xFFFF), rb)
    rn = jnp.where(resc, rl + 16, rl)
    rgran = jnp.where(resc, 16, rl)
    rv = jnp.where(is_lit, rv, 0)
    rn = jnp.where(is_lit, rn, 0)

    sv, sn, sgran = _sym_emissions(data, sym_luts)
    sv = jnp.where(is_lit, sv, 0)
    sn = jnp.where(is_lit, sn, 0)

    # trailing run after the last literal (only when > 0 symbols remain)
    last_lit = run_max[:, -1] if l > 0 else jnp.full((n_rows,), -1, jnp.int32)
    trail = jnp.maximum(lengths - last_lit - 1, 0)
    has_trail = trail > 0
    tx = jnp.minimum(trail, 255)
    tpacked = run_luts[tx].astype(jnp.uint32)
    tb = tpacked >> jnp.uint32(6)
    tl = ((tpacked >> jnp.uint32(1)) & 31).astype(jnp.int32)
    tesc = (tpacked & 1).astype(jnp.bool_)
    tv = jnp.where(tesc, (tb << 16) | (trail.astype(jnp.uint32) & 0xFFFF), tb)
    tn = jnp.where(tesc, tl + 16, tl)
    tgran = jnp.where(tesc, 16, tl)
    tv = jnp.where(has_trail, tv, 0)
    tn = jnp.where(has_trail, tn, 0)

    # interleave: (N, 2L+1)
    v = jnp.concatenate(
        [jnp.stack([rv, sv], axis=2).reshape(n_rows, 2 * l), tv[:, None]], axis=1)
    n = jnp.concatenate(
        [jnp.stack([rn, sn], axis=2).reshape(n_rows, 2 * l), tn[:, None]], axis=1)
    t = n.sum(axis=1)

    # granular width of the final emission (for the tail-padding rule)
    lit_gran = jnp.where(is_lit, sgran, 0)
    idx = jnp.maximum(last_lit, 0)
    last_lit_gran = jnp.take_along_axis(lit_gran, idx[:, None], 1)[:, 0]
    last_gran = jnp.where(has_trail, tgran,
                          jnp.where(last_lit >= 0, last_lit_gran, 0))
    return v, n, t, last_gran


def compact_monotone(vals: tuple, keep):
    """Stable left-compaction of flagged elements via log2(M) shifts.

    Destinations are the ranks of the kept elements, so the displacement
    ``d = position - rank`` is monotone non-decreasing along the row; moving
    every element whose remaining displacement has bit b set by 2^b, LSB to
    MSB, routes all kept elements without collisions (overwrites only hit
    dropped slots).
    """
    n_rows, m = keep.shape
    ranks = jnp.cumsum(keep, axis=1) - 1
    col = jax.lax.broadcasted_iota(jnp.int32, (n_rows, m), 1)
    d = jnp.where(keep, col - ranks, 0)
    bits = max(m - 1, 1).bit_length()
    for b in range(bits):
        step = 1 << b
        move_src = jnp.roll((d >> b) & 1, -step, axis=1) == 1
        zero_tail = jax.lax.broadcasted_iota(jnp.int32, (n_rows, m), 1) < m - step
        move_src = move_src & zero_tail
        vals = tuple(jnp.where(move_src, jnp.roll(x, -step, axis=1), x)
                     for x in vals)
        d = jnp.where(move_src, jnp.roll(d, -step, axis=1) - step, d)
    return vals


def pack_words(v, n):
    """Assemble emissions (N, M) into per-row u32 word rectangles (N, M+1).

    Bit offsets are row-local; each emission lands in at most two words
    (hi/lo 32-bit contributions, bit-disjoint so sum == or):

    - per-slot word indices ``w = off >> 5`` are monotone and never skip
      (every emission is <= 32 bits), so contributions to one word are a
      contiguous slot range;
    - running sums over slots (u32, wraparound-safe) turn each word's value
      into a difference of two cumsum samples at word boundaries;
    - the boundary samples move to their word indexes by shift-network
      compaction (their destinations are their ranks); the lo contributions
      of word j+1 end at the same boundary slot, so one compaction carries
      both cumsum planes.
    """
    n_rows, m = v.shape
    off = _excl_cumsum(n, axis=1)
    w = off >> 5
    p = off & 31

    pn = p + n
    fits = pn <= 32
    hi = jnp.where(fits, v << jnp.clip(32 - pn, 0, 31).astype(jnp.uint32),
                   v >> jnp.clip(pn - 32, 0, 31).astype(jnp.uint32))
    lo = jnp.where(fits, jnp.uint32(0),
                   v << jnp.clip(64 - pn, 0, 31).astype(jnp.uint32))
    hi = jnp.where(n > 0, hi, 0)

    cs_hi = jnp.cumsum(hi.astype(jnp.uint32), axis=1)
    cs_lo = jnp.cumsum(lo.astype(jnp.uint32), axis=1)
    nxt = jnp.concatenate(
        [w[:, 1:], jnp.full((n_rows, 1), -1, w.dtype)], axis=1)
    last = w != nxt
    s_hi, s_lo = compact_monotone((cs_hi, cs_lo), last)

    key_max = jnp.max(jnp.where(n > 0, w, -1), axis=1, keepdims=True)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n_rows, m + 1), 1)
    z1 = jnp.zeros((n_rows, 1), jnp.uint32)

    # hi: word j = s_hi[j] - s_hi[j-1], valid for 0 <= j <= key_max
    # (pad one column: there are m slots but m+1 output words; the pad is
    # always masked since key_max <= m - 1 + ... bounded by real words)
    s_hi = jnp.concatenate([s_hi, z1], axis=1)
    hi_cum = s_hi[:, : m + 1]
    hi_prev = jnp.concatenate([z1, hi_cum[:, : m]], axis=1)
    hi_vals = jnp.where(idx <= key_max, hi_cum - hi_prev, 0)

    # lo: word j+1 = s_lo[j] - s_lo[j-1], valid for 1 <= j+1 <= key_max+1
    lo_cum = jnp.concatenate([z1, s_lo[:, : m]], axis=1)
    lo_prev = jnp.concatenate([z1, lo_cum[:, : m]], axis=1)
    lo_vals = jnp.where((idx >= 1) & (idx <= key_max + 1), lo_cum - lo_prev, 0)

    return hi_vals + lo_vals


def word_counts(t, last_gran):
    """(raw_words, out_words, dup, zero_ext) per row from totals.

    raw: ceil(T/32) — what pack_words fills;
    out: what the reference encoder writes (tail-padding rule).
    """
    olen = t & 31
    llen = (t - last_gran) & 31
    raw = (t + 31) >> 5
    dup = (olen > 0) & (llen > 16) & (olen > llen)
    zext = (olen == 0) & (llen > 16) & (t > 0)
    out = raw + dup.astype(t.dtype) + zext.astype(t.dtype)
    return raw, out, dup, zext


# ---------------------------------------------------------------------------
# host-side finishing: expand rows into the exact byte streams
# ---------------------------------------------------------------------------

def finalize_rows(words: np.ndarray, raw: np.ndarray, out: np.ndarray,
                  dup: np.ndarray, zext: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Gather each row's raw words into the padded output stream.

    Returns (flat u32 array of all rows concatenated, per-row word counts).
    A duplicated partial word repeats the final raw word; a zero-extension
    appends a zero word (gather index -1 -> 0 via a guard row).
    """
    n_rows, m1 = words.shape
    out = out.astype(np.int64)
    raw = raw.astype(np.int64)
    total = int(out.sum())
    if total == 0:
        return np.empty(0, np.uint32), out
    starts = np.zeros(n_rows, np.int64)
    np.cumsum(out[:-1], out=starts[1:])
    rel = np.arange(total, dtype=np.int64) - np.repeat(starts, out)
    row = np.repeat(np.arange(n_rows, dtype=np.int64), out)
    # within-row source index: rel, except the dup/zext extra word
    src = np.minimum(rel, np.repeat(raw, out) - 1)
    is_extra = rel >= np.repeat(raw, out)
    use_zero = np.repeat(zext, out) & is_extra
    flat = words[row, src]
    flat[use_zero] = 0
    return flat, out


# ---------------------------------------------------------------------------
# fused device programs
# ---------------------------------------------------------------------------

@jax.jit
def encode_plain_rows(data, lengths, luts):
    v, n, t, lg = plain_emissions(data, lengths, luts)
    raw, out, dup, zext = word_counts(t, lg)
    return pack_words(v, n), raw, out, dup, zext


@jax.jit
def encode_run_rows(data, lengths, rchar, sym_luts, run_luts):
    v, n, t, lg = run_emissions(data, lengths, rchar, sym_luts, run_luts)
    raw, out, dup, zext = word_counts(t, lg)
    return pack_words(v, n), raw, out, dup, zext


def encode_rows_np(data, lengths, scheme: HScheme,
                   run_scheme: HScheme | None = None, rchar: int = -1):
    """Encode a rectangle of streams; returns (flat u32, words-per-row)."""
    luts = jnp.asarray(scheme_luts(scheme))
    d = jnp.asarray(data)
    ln = jnp.asarray(lengths.astype(np.int32))
    if run_scheme is None:
        parts = encode_plain_rows(d, ln, luts)
    else:
        rluts = jnp.asarray(scheme_luts(run_scheme, run=True))
        parts = encode_run_rows(d, ln, jnp.int32(rchar), luts, rluts)
    return finalize_rows(*(np.asarray(x) for x in parts))
