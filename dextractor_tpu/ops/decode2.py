"""Batched Huffman decode of .dexqv entries (v2 of ops/decode_jax.py).

A Huffman stream is bit-serial, but a batch of entries is N independent
chains once each entry's stream offsets are known (the native lens walk
reports them).  This module holds the batch layout and the five-channel
entry step:

  * entries are decoded from dense per-channel rectangles of little-endian
    u32 words (N, K), built host-side at memcpy speed, so every chain
    reads only its own row and starts at word 0;
  * codes resolve through two-level tables (``scheme_tables2``): L1 over
    the top 8 window bits, L2 subtables for codes longer than 8 bits;
  * run channels decode to (runlen, literal) token pairs, expanded to
    symbol rows by a time-reversed shift-compaction network
    (``expand_monotone``); the delTag codes ride the same network;
  * the chains themselves run in the GPU kernel (ops/chain_gpu) on a GPU
    backend, and as the XLA ``fori_loop`` formulation below elsewhere —
    the CPU path and the reference the kernel is tested against.

Semantics are identical to v1 (QV.c:510-691 decode contract, exercised by
the in-repo reference tests); only the execution strategy differs.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# host-side table + rectangle preparation
# ---------------------------------------------------------------------------

def scheme_tables2(schemes, lmax_bucket: int | None = None):
    """Two-level decode tables for a list of HSchemes.

    L1 (S, 256) i32 over the top 8 window bits: terminal entries pack
    ``len << 9 | sym``; prefixes whose code runs past 8 bits carry
    ``1 << 20 | subid``.  L2 is one flat (n_sub * subw,) i32 of
    ``len << 9 | sym`` rows, each ``subw = 2^(lmax-8)`` wide over window
    bits [8, lmax).  Returns (F1, F2flat, subw, lmax).
    """
    lmax = 1
    for s in schemes:
        s.with_lookup()
        lmax = max(lmax, int(s.codelens.max(initial=1)))
    if lmax_bucket is not None:
        lmax = max(lmax, lmax_bucket)
    lmax = 8 if lmax <= 8 else (12 if lmax <= 12 else 16)
    subw = 0 if lmax == 8 else 1 << (lmax - 8)

    f1 = np.zeros((len(schemes), 256), np.int32)
    f2_rows: list[np.ndarray] = []
    hi = np.arange(256) << 8
    for i, s in enumerate(schemes):
        look = s.lookup
        lens = s.codelens.astype(np.int32)
        sym0 = look[hi]
        l0 = lens[sym0]
        term = l0 <= 8
        f1[i] = np.where(term, (l0 << 9) | sym0, 0)
        for h in np.flatnonzero(~term):
            row = look[(h << 8) + (np.arange(subw) << (16 - lmax))]
            f2_rows.append((lens[row] << 9) | row)
            f1[i, h] = (1 << 20) | len(f2_rows) - 1
    if f2_rows:
        f2 = np.concatenate(f2_rows).astype(np.int32)
    else:
        f2 = np.zeros(max(subw, 1), np.int32)
    return f1, f2, subw, lmax


def build_entry_rect(buf: np.ndarray, starts: np.ndarray, k_words: int):
    """Dense (N, K) little-endian u32 rectangle of per-entry bytes.

    Row r holds bytes buf[starts[r] : starts[r] + 4K] (clamped at the
    image end; the tail garbage is never consumed by a well-formed
    stream).  Host-side numpy — one fancy-index at memcpy-ish speed."""
    buf = np.asarray(buf, np.uint8)
    idx = np.asarray(starts, np.int64)[:, None] + np.arange(4 * k_words)
    b = buf[np.minimum(idx, max(len(buf) - 1, 0))]
    return np.ascontiguousarray(b).view(np.uint32)


def rect_k_words(starts: np.ndarray, buf_len: int, pad_words: int = 16) -> int:
    """Static K bucket: pow2 ≥ the longest entry (in u32 words) + slack."""
    starts = np.asarray(starts, np.int64)
    if len(starts) == 0:
        return 64
    ends = np.concatenate([starts[1:], np.array([buf_len], np.int64)])
    k = int(np.max((ends - starts + 3) // 4)) + pad_words
    return 1 << max(k - 1, 63).bit_length()


# ---------------------------------------------------------------------------
# chain primitives
# ---------------------------------------------------------------------------

def _read(rect, pos):
    """The two stream words under bit position pos of each row."""
    k = rect.shape[1]
    widx = pos >> 5
    idx = jnp.clip(jnp.stack([widx, widx + 1], axis=1), 0, k - 1)
    w = jnp.take_along_axis(rect, idx, axis=1)
    return w[:, 0], w[:, 1]


def _peek16(sw_a, sw_b, p):
    """Top 16 bits of the stream window at bit offset p (= pos & 31)."""
    hi = jnp.where(p == 0, sw_a,
                   (sw_a << p) | (sw_b >> ((jnp.uint32(32) - p)
                                           & jnp.uint32(31))))
    return (hi >> jnp.uint32(16)).astype(jnp.int32)


def _extract(sw_a, sw_b, off, nbits: int):
    """bits [off, off+nbits) of the 64-bit window sw_a:sw_b (off+nbits<=64)."""
    off = off.astype(jnp.uint32)
    lt = (sw_a << (off & 31)) | (sw_b >> ((jnp.uint32(32) - off)
                                          & jnp.uint32(31)))
    ge = sw_b << ((off - 32) & 31)
    hi = jnp.where(off == 0, sw_a, jnp.where(off < 32, lt, ge))
    return (hi >> jnp.uint32(32 - nbits)).astype(jnp.int32)


def _take(tbl, idx):
    """tbl[idx] with out-of-range -> 0."""
    d = tbl.shape[0]
    return jnp.where((idx >= 0) & (idx < d), tbl[jnp.clip(idx, 0, d - 1)], 0)


def _entry_lookup(cw, f1c, f2, subw: int, lmax: int):
    """(len << 9 | sym) for the 16-bit window cw via the two-level tables."""
    e1 = _take(f1c, cw >> 8)
    if subw:
        is2 = (e1 >> 20) & 1
        idx2 = ((e1 & 0xFFFF) * subw
                + ((cw >> (16 - lmax)) & (subw - 1)))
        e2 = _take(f2, jnp.where(is2 == 1, idx2, -1))
        return jnp.where(is2 == 1, e2, e1)
    return e1


def roll_rows(x, shift):
    """x[r, c] = x_in[r, (c + shift[r]) % width] — per-row roll, log rounds."""
    width = x.shape[1]
    for b in range(max(width - 1, 1).bit_length()):
        step = 1 << b
        x = jnp.where((((shift >> b) & 1) == 1)[:, None],
                      jnp.roll(x, -step, axis=1), x)
    return x


_EXP_LIVE = jnp.int32(1 << 30)     # packed-state live bit (below the sign)


def expand_monotone(vals: tuple, disp, width: int, live0=None, *,
                    value_bits: int = 8):
    """Route element at column r to column r + disp[r] (time-reversed
    shift compaction).

    Among live elements disp must be >= 0 and non-decreasing along each
    row, with r + disp[r] < width.  ``live0`` (N, t) masks which source
    elements participate (default all); dead elements never move and
    never count as occupancy, so callers can park exhausted-token tails
    by deadening them instead of routing them past the payload (which
    would double the required width).

    This is ``compact_monotone`` run backwards: the stage-b movers are
    the elements whose displacement has bit b set, processed MSB -> LSB
    with right-rolls, which time-reverses the proven LSB -> MSB
    left-roll compaction of the expanded layout back to ranks.  MSB ->
    LSB right-routing is collision-free for live elements: a mover
    landing on a live stationary slot would force the two displacements'
    above-b parts to differ by >= 2^(b+1) while their positions differ
    by exactly 2^b — impossible when disp is non-decreasing.

    Returns the routed arrays plus a routed-occupancy mask (N, width) —
    unrouted slots hold garbage.

    Execution notes: value (``value_bits``, default 8), displacement
    (30 - value_bits bits) and liveness (1 bit, bit 30) are packed into
    ONE i32 plane so each round is a single roll + selects.
    """
    n, t = disp.shape
    width = int(width)
    pad = width - t
    if pad < 0:
        raise ValueError("expand_monotone: width must be >= token count")
    vb = int(value_bits)
    if width > (1 << (30 - vb)):
        raise ValueError("expand_monotone: width exceeds the packed "
                         "displacement field; use multi-value planes")
    vmask = (1 << vb) - 1
    multi = len(vals) > 1
    if live0 is None:
        live = jnp.ones((n, t), jnp.bool_)
    else:
        live = live0
    lv = jnp.pad(live, ((0, 0), (0, pad)))
    d = jnp.pad(jnp.where(live, disp, 0), ((0, 0), (0, pad)))
    if multi:
        # multi-value fallback: separate planes per value (monster widths
        # whose displacement no longer fits the packed field)
        arrs = [jnp.pad(v, ((0, 0), (0, pad))) for v in vals]
        state = [lv, d] + arrs
    else:
        v = jnp.pad(vals[0] & vmask, ((0, 0), (0, pad)))
        s = v | (d << vb) | jnp.where(lv, _EXP_LIVE, 0)
        state = [s]
    col = jax.lax.broadcasted_iota(jnp.int32, (n, width), 1)
    for b in reversed(range(max(width - 1, 1).bit_length())):
        step = 1 << b
        if multi:
            lv, d = state[0], state[1]
            movers = lv & (((d >> b) & 1) == 1)
            dst = jnp.roll(movers, step, axis=1) & (col >= step)
            state[2:] = [jnp.where(dst, jnp.roll(a, step, axis=1), a)
                         for a in state[2:]]
            state[1] = jnp.where(dst, jnp.roll(d, step, axis=1) - step, d)
            state[0] = (lv & ~movers) | dst
        else:
            s = state[0]
            movers = (((s >> 30) & (s >> (vb + b))) & 1) == 1
            # live bit (30) AND displacement bit b (vb+b)
            rolled = jnp.roll(s, step, axis=1)
            dst = ((((rolled >> 30) & (rolled >> (vb + b))) & 1) == 1) \
                & (col >= step)
            s = jnp.where(dst, rolled - (step << vb),
                          jnp.where(movers, s & ~_EXP_LIVE, s))
            state[0] = s
    if multi:
        return tuple(state[2:]), state[0]
    s = state[0]
    return (s & vmask,), ((s >> 30) & 1) == 1


# ---------------------------------------------------------------------------
# chain decoders
# ---------------------------------------------------------------------------

def plain_chain(rect, rlens, f1c, f2, signal, *, max_len: int,
                subw: int, lmax: int, max_sym: int | None = None,
                pos0=None):
    """Decode N plain streams, one per word-aligned rectangle row (XLA).

    Returns symbols (N, max_len) u8.  Eight symbols per loop iteration.
    ``max_sym`` (static, the batch's bucketed longest read) caps the
    serial steps below the padded row width.

    ``pos0`` (N,) i32 in [0, 32): each chain's starting bit offset within
    its rectangle — segment chains resume mid-stream from the native
    walker's checkpoints (rows are sliced at the checkpoint's word)."""
    ml = max_len if max_sym is None else min(max_len, max_sym)
    n = rlens.shape[0]
    group_sz = 8
    groups = (ml + group_sz - 1) // group_sz

    def group(g, carry):
        pos, out = carry
        syms = []
        jbase = g * group_sz
        for s in range(group_sz):
            active = (jbase + s) < rlens
            sw_a, sw_b = _read(rect, pos)
            p = (pos & 31).astype(jnp.uint32)
            cw = _peek16(sw_a, sw_b, p)
            entry = _entry_lookup(cw, f1c, f2, subw, lmax)
            sym = entry & 511
            nbits = (entry >> 9) & 31
            esc = active & (sym == signal)
            lit = _extract(sw_a, sw_b, p + nbits.astype(jnp.uint32), 8)
            sym = jnp.where(esc, lit, sym)
            pos = jnp.where(active, pos + jnp.where(esc, nbits + 8, nbits),
                            pos)
            syms.append(jnp.where(active, sym, 0).astype(jnp.uint8))
        out = jax.lax.dynamic_update_slice(
            out, jnp.stack(syms, axis=1), (0, jbase))
        return pos, out

    z = rlens * 0
    out0 = jnp.broadcast_to(z.astype(jnp.uint8)[:, None],
                            (n, groups * group_sz))
    p0 = z if pos0 is None else pos0.astype(z.dtype)
    _, out = jax.lax.fori_loop(0, groups, group, (p0, out0))
    out = out[:, :ml]
    if ml < max_len:
        out = jnp.pad(out, ((0, 0), (0, max_len - ml)))
    return out


def run_chain(rect, rlens, f1r, f1s, f2, nsignal, *,
              max_tokens: int, subw: int, lmax: int, pos0=None,
              carry=None):
    """Decode N RLE streams into (runlen, literal) token pairs (XLA).

    Three tokens per loop iteration.  ``max_tokens`` comes from the
    native lens walk's exact per-entry token counts, so the chain length
    is tight rather than bounded by rlen.  Token semantics match
    decode_jax.decode_run_batch.

    Segment chains (``pos0``/``carry`` from the walker's checkpoints):
    the chain starts at bit ``pos0`` and, when ``carry >= 0``, its first
    token is the virtual pair (carry, literal-at-pos0) — a checkpoint
    inside a run resumes with the leftover rchars prepended and the
    stream positioned AT the run's literal code; carry < 0 starts at a
    run code normally."""
    n = rlens.shape[0]
    group_sz = 3
    groups = (max_tokens + group_sz - 1) // group_sz
    t_pad = groups * group_sz

    def group(g, st):
        pos, emitted, runs, lits = st
        rcols, lcols = [], []
        for s in range(group_sz):
            active = emitted < rlens
            sw_a, sw_b = _read(rect, pos)
            p = (pos & 31).astype(jnp.uint32)
            cw = _peek16(sw_a, sw_b, p)
            entry = _entry_lookup(cw, f1r, f2, subw, lmax)
            c = entry & 511
            nb = (entry >> 9) & 31
            resc = active & (c == 255)
            runlit = _extract(sw_a, sw_b, p + nb.astype(jnp.uint32), 16)
            runlen = jnp.where(resc, runlit, c)
            if carry is not None and s == 0:
                # segment phase: the first token of the chain is the
                # checkpoint's virtual (carry, literal) pair — no run
                # code is read and the stream sits at the literal
                phase = (g == 0) & (carry >= 0)
                runlen = jnp.where(phase, carry, runlen)
                resc = resc & ~phase
                pos = pos + jnp.where(
                    active & ~phase, nb + jnp.where(resc, 16, 0), 0)
            else:
                pos = pos + jnp.where(active,
                                      nb + jnp.where(resc, 16, 0), 0)
            emitted1 = jnp.minimum(emitted + runlen, rlens)

            need_sym = active & (emitted1 < rlens)
            sw_a, sw_b = _read(rect, pos)
            p = (pos & 31).astype(jnp.uint32)
            cw2 = _peek16(sw_a, sw_b, p)
            entry2 = _entry_lookup(cw2, f1s, f2, subw, lmax)
            sym = entry2 & 511
            snb = (entry2 >> 9) & 31
            sesc = need_sym & (sym == nsignal)
            slit = _extract(sw_a, sw_b, p + snb.astype(jnp.uint32), 8)
            sym = jnp.where(sesc, slit, sym)
            pos = pos + jnp.where(need_sym,
                                  snb + jnp.where(sesc, 8, 0), 0)

            rcols.append(jnp.where(active, runlen, 0))
            lcols.append(jnp.where(need_sym, sym, -1))
            emitted = jnp.where(active,
                                emitted1 + need_sym.astype(jnp.int32),
                                emitted)
        jbase = g * group_sz
        runs = jax.lax.dynamic_update_slice(
            runs, jnp.stack(rcols, axis=1), (0, jbase))
        lits = jax.lax.dynamic_update_slice(
            lits, jnp.stack(lcols, axis=1), (0, jbase))
        return pos, emitted, runs, lits

    z = rlens * 0
    runs0 = jnp.broadcast_to(z[:, None], (n, t_pad))
    lits0 = runs0 - 1
    p0 = z if pos0 is None else pos0.astype(z.dtype)
    _, _, runs, lits = jax.lax.fori_loop(
        0, groups, group, (p0, z, runs0, lits0))
    return runs, lits


def _signal(types, sid):
    """Escape symbol of a scheme: 255 for type-2 schemes, else none."""
    return jnp.where(types[sid] == 2, 255, 256)


def _stack_lanes(rects, vecs_per_chan):
    """Concatenate C channels' chains into one lane batch (rect widths
    padded to the widest channel)."""
    kw = max(r.shape[1] for r in rects)
    rect = jnp.concatenate([jnp.pad(r, ((0, 0), (0, kw - r.shape[1])))
                            for r in rects])
    vecs = tuple(jnp.concatenate(v) for v in zip(*vecs_per_chan))
    return rect, vecs


def plain_chains(specs, rlens, f1, f2, types, *, max_len: int, lmax: int,
                 max_sym: int | None = None, pos0=None,
                 kernel: str | None = None):
    """Decode several plain channels of one batch of entries.

    ``specs`` is a list of (key, rect, sid, subw) with ``sid`` the
    channel's row of ``f1`` (S, 256); ``pos0`` an optional {key: (N,) i32}
    of per-chain starting bit offsets (segment decode).  With ``kernel``
    ("gpu", or "interpret" in CPU tests) every channel's chains run as
    lanes of ONE launch of the GPU chain kernel; otherwise each channel
    runs the XLA chain.  Returns {key: (N, max_len) u8 rows}."""
    ml = max_len if max_sym is None else min(max_len, max_sym)
    n = rlens.shape[0]
    z = rlens * 0
    if not kernel:
        return {key: plain_chain(
            rect, rlens, f1[sid], f2, _signal(types, sid), max_len=max_len,
            subw=sw, lmax=lmax, max_sym=max_sym,
            pos0=None if pos0 is None else pos0.get(key))
            for key, rect, sid, sw in specs}
    from .chain_gpu import plain_chains_gpu

    rect, (rl, sids, sigs, p0) = _stack_lanes(
        [sp[1] for sp in specs],
        [(rlens, z + sid, z + _signal(types, sid),
          z if pos0 is None else pos0[key].astype(z.dtype))
         for key, _, sid, _ in specs])
    rows, _, _ = plain_chains_gpu(
        rect, rl, sids, sigs, p0, f1, f2, max_len=ml,
        subw=max(sp[3] for sp in specs), lmax=lmax,
        interpret=kernel == "interpret")
    if ml < max_len:
        rows = jnp.pad(rows, ((0, 0), (0, max_len - ml)))
    return {sp[0]: rows[i * n:(i + 1) * n] for i, sp in enumerate(specs)}


def run_chains(specs, rlens, f1, f2, types, *, max_tokens: int, lmax: int,
               kernel: str | None = None):
    """Decode several run channels of one batch into token pairs.

    ``specs`` is a list of (key, rect, run_sid, sym_sid, subw, pos0,
    carry) (pos0/carry None outside segment decode).  As
    ``plain_chains``, the GPU kernel decodes all channels in one launch.
    Returns {key: (runs, lits)} with at least ``max_tokens`` columns."""
    if not kernel:
        return {key: run_chain(
            rect, rlens, f1[rsid], f1[ssid], f2, _signal(types, ssid),
            max_tokens=max_tokens, subw=sw, lmax=lmax, pos0=p0, carry=cr)
            for key, rect, rsid, ssid, sw, p0, cr in specs}
    from .chain_gpu import run_chains_gpu

    n = rlens.shape[0]
    z = rlens * 0
    rect, (rl, rsids, ssids, sigs, p0, cr) = _stack_lanes(
        [sp[1] for sp in specs],
        [(rlens, z + rsid, z + ssid, z + _signal(types, ssid),
          z if p0 is None else p0.astype(z.dtype),
          z - 1 if cr is None else cr.astype(z.dtype))
         for _, _, rsid, ssid, _, p0, cr in specs])
    runs, lits, _, _ = run_chains_gpu(
        rect, rl, rsids, ssids, sigs, p0, cr, f1, f2,
        max_tokens=max_tokens, subw=max(sp[4] for sp in specs), lmax=lmax,
        interpret=kernel == "interpret")
    return {sp[0]: (runs[i * n:(i + 1) * n], lits[i * n:(i + 1) * n])
            for i, sp in enumerate(specs)}


def _unpack_tag_codes(tag_bytes, width: int):
    """Positional 2-bit delTag unpack: code k of each row lands at column
    k (Unpack_Tag order, first symbol in bits 7-6 — QV.c:824-847,
    DB.c:334).  (N, TB) u8 -> (N, width) i32.  No gathers: the code
    index IS the column index."""
    n, tb = tag_bytes.shape
    shifts = jnp.array([6, 4, 2, 0], jnp.uint8)
    codes = ((tag_bytes[:, :, None] >> shifts[None, None, :]) & 3)
    codes = codes.reshape(n, 4 * tb).astype(jnp.int32)
    if codes.shape[1] < width:
        codes = jnp.pad(codes, ((0, 0), (0, width - codes.shape[1])))
    return codes[:, :width]


def _tag_letters(codes):
    """2-bit code -> ascii 'a/c/g/t' (undexqv.c tag alphabet)."""
    return jnp.where(
        codes == 0, 97, jnp.where(codes == 1, 99,
                                  jnp.where(codes == 2, 103, 116)))


def expand_del_tag(runs, lits, codes_t, rchar, *, max_len: int):
    """Expand delQV run tokens and route the delTag in the same network.

    Literal k is by construction the k-th non-delChar symbol of the read
    (tokenize_runs / QV.c:448-506 emit one token per non-rchar symbol),
    so kept-rank == token index and packed tag code k (unpacked
    positionally, no gather) rides the same displacement as literal k —
    the separate keep-cumsum + rank-gather tag route (QV.c:824-847
    semantics) collapses into this one pass.

    Returns (del_rows (N, max_len) u8, tag_rows (N, max_len) i32 with
    -1 at in-read holes to be replaced by 'n' and masked by the caller).
    """
    n, t = runs.shape
    d = jnp.cumsum(runs, axis=1)
    valid = lits >= 0
    width = max(max_len, t)
    if width <= (1 << 20):
        val = (lits & 0xFF) | (codes_t << 8)
        (routed,), occ = expand_monotone((val,), d, width, live0=valid,
                                         value_bits=10)
        rlit, rtag = routed & 0xFF, routed >> 8
    else:
        (rlit, rtag), occ = expand_monotone((lits & 0xFF, codes_t), d,
                                            width, live0=valid)
    del_rows = jnp.where(occ, rlit,
                         jnp.asarray(rchar, jnp.int32))[:, :max_len]
    tag_rows = jnp.where(occ, _tag_letters(rtag), -1)[:, :max_len]
    return del_rows.astype(jnp.uint8), tag_rows


def expand_runs2(runs, lits, rchar, *, max_len: int):
    """Expand (runlen, literal) token pairs into symbol rows, gather-free.

    Literal k of lane i lands at column cumsum(runs)[i, k] + k, i.e. a
    displacement of cumsum(runs)[i, k] from its token column — monotone,
    so the shift-expansion network routes it; exhausted-token tails are
    parked past max_len and sliced away."""
    n, t = runs.shape
    d = jnp.cumsum(runs, axis=1)
    valid = lits >= 0
    (routed,), occ = expand_monotone(
        (lits,), d, max(max_len, t), live0=valid)
    rows = jnp.where(occ, routed, jnp.asarray(rchar, jnp.int32))
    return rows[:, :max_len].astype(jnp.uint8)


# ---------------------------------------------------------------------------
# fused five-channel entry decode
# ---------------------------------------------------------------------------

def _entry_rows(rect_del, tag_in, rect_ins, rect_mrg, rect_sub, chain_rlens,
                rlens, sids, f1, f2, types, del_char, sub_char, *,
                chain_len: int, max_len: int, max_tokens: int,
                del_mode: str, sub_mode: str, subw: int, lmax: int,
                chan_l2, max_sym, pos0, carr, widen, tag_codes,
                kernel: str | None):
    """Shared body of the per-read and segmented entry decodes.

    Chains are rows of the rectangles (``chain_rlens`` symbols each,
    ``chain_len`` wide); ``widen`` maps chain rows to (N, max_len) read
    rows.  ``tag_codes(runs)`` gives the delTag codes aligned with the
    del run tokens (run-del mode)."""
    n = rlens.shape[0]
    # per-channel L2 need (host-computed static): channels whose scheme is
    # fully L1-terminal skip the escape-table lookup entirely
    sw = [subw if (chan_l2 is None or chan_l2[k]) else 0 for k in range(6)]
    col = jax.lax.broadcasted_iota(jnp.int32, (n, max_len), 1)
    in_read = col < rlens[:, None]
    p0 = (lambda c: None) if pos0 is None else (lambda c: pos0[c])
    cr = (lambda c: None) if carr is None else (lambda c: carr[c])

    # the plain channels (ins, mrg, and del/sub when not run-coded) and
    # the run channels each decode as one batch of chains
    plain = [("ins", rect_ins, sids[2], sw[2], 1),
             ("mrg", rect_mrg, sids[3], sw[3], 2)]
    runs = []
    if del_mode == "run":
        runs.append(("del", rect_del, sids[1], sids[0], max(sw[0], sw[1]),
                     p0(0), cr(0)))
    else:
        plain.append(("del", rect_del, sids[0], sw[0], 0))
    if sub_mode == "run":
        runs.append(("sub", rect_sub, sids[5], sids[4], max(sw[4], sw[5]),
                     p0(3), cr(1)))
    else:
        plain.append(("sub", rect_sub, sids[4], sw[4], 3))
    prows = plain_chains(
        [sp[:4] for sp in plain], chain_rlens, f1, f2, types,
        max_len=chain_len, lmax=lmax, max_sym=max_sym, kernel=kernel,
        pos0=None if pos0 is None else {sp[0]: pos0[sp[4]]
                                        for sp in plain})
    toks = run_chains(runs, chain_rlens, f1, f2, types,
                      max_tokens=max_tokens, lmax=lmax,
                      kernel=kernel) if runs else {}

    # -- delQV + delTag -------------------------------------------------
    # Run mode: kept-rank == token index (literals are exactly the
    # non-delChar symbols), so the positionally-unpacked tag codes ride
    # the run-expansion network alongside the literals — no keep-cumsum,
    # no rank gather.  Plain mode: every in-read position is kept, so the
    # tag is a direct positional unpack.
    if del_mode == "run":
        druns, dlits = toks["del"]
        del_rows, tag_r = expand_del_tag(druns, dlits, tag_codes(druns),
                                         del_char, max_len=chain_len)
        del_rows, tag_r = widen(del_rows), widen(tag_r)
        tag_rows = jnp.where(
            tag_r >= 0, tag_r,
            jnp.where(in_read, np.int32(ord("n")), 0)).astype(jnp.uint8)
        tag_rows = jnp.where(in_read, tag_rows, jnp.uint8(0))
    else:
        del_rows = widen(prows["del"])
        codes = _unpack_tag_codes(tag_in, max_len)
        tag_rows = jnp.where(in_read, _tag_letters(codes),
                             0).astype(jnp.uint8)

    if sub_mode == "run":
        sub_rows = widen(expand_runs2(*toks["sub"], sub_char,
                                      max_len=chain_len))
    else:
        sub_rows = widen(prows["sub"])

    z = jnp.uint8(0)
    mask = lambda r: jnp.where(in_read, r, z)
    return jnp.stack([mask(del_rows), tag_rows, mask(widen(prows["ins"])),
                      mask(widen(prows["mrg"])), mask(sub_rows)])


@functools.partial(
    jax.jit, static_argnames=("max_len", "max_tokens", "del_mode",
                              "sub_mode", "subw", "lmax", "chan_l2",
                              "max_sym", "kernel"))
def decode_entry_batch2(rect_del, tag_bytes, rect_ins, rect_mrg, rect_sub,
                        rlens, sids, f1, f2, types, del_char, sub_char, *,
                        max_len: int, max_tokens: int, del_mode: str,
                        sub_mode: str, subw: int, lmax: int,
                        chan_l2: tuple | None = None,
                        max_sym: int | None = None,
                        kernel: str | None = None):
    """Fully fused five-channel .dexqv entry decode.

    Each channel decodes from its own word-aligned rectangle (the native
    lens walk supplies per-entry channel boundaries, so the host slices
    them at memcpy speed): every chain starts at word 0, fetch traffic is
    proportional to the channel being decoded rather than the whole entry,
    and the packed delTag bytes arrive pre-sliced (no on-device byte
    realignment).

    rect_del/ins/mrg/sub: (N, K_c) u32 channel words; tag_bytes (N, TB) u8
    with 4*TB >= max_len; rlens (N,) i32; sids (6,) i32 scheme ids
    (del, drun, ins, mrg, sub, srun); f1 (S, 256) i32 L1 tables; f2 flat
    i32 L2; types (S,) i32.  ``kernel`` (static, from
    utils.dispatch.chain_kernel) runs the chains in the GPU kernel.

    Semantics identical to the sequential decoder (QV.c:1428-1477 raw
    container case): returns (5, N, max_len) u8 rows."""
    return _entry_rows(
        rect_del, tag_bytes, rect_ins, rect_mrg, rect_sub, rlens, rlens,
        sids, f1, f2, types, del_char, sub_char, chain_len=max_len,
        max_len=max_len, max_tokens=max_tokens, del_mode=del_mode,
        sub_mode=sub_mode, subw=subw, lmax=lmax, chan_l2=chan_l2,
        max_sym=max_sym, pos0=None, carr=None, widen=lambda r: r,
        tag_codes=lambda runs: _unpack_tag_codes(tag_bytes, runs.shape[1]),
        kernel=kernel)


# ---------------------------------------------------------------------------
# segmented five-channel entry decode (long reads)
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("seg", "s_per", "max_len", "max_tokens",
                              "del_mode", "sub_mode", "subw", "lmax",
                              "chan_l2", "kernel"))
def decode_entry_batch_seg(rect_del, tag_in, rect_ins, rect_mrg, rect_sub,
                           rlens, seg_rlens, pos0, carr, sids, f1, f2,
                           types, del_char, sub_char, *, seg: int,
                           s_per: int, max_len: int, max_tokens: int,
                           del_mode: str, sub_mode: str, subw: int,
                           lmax: int, chan_l2: tuple | None = None,
                           kernel: str | None = None):
    """Segmented fused five-channel .dexqv decode.

    Long reads decode as ``s_per`` independent SHORT chains per read from
    the native walker's checkpoints (qv_codec._index_checkpoints) instead
    of one long one, so a batch of long reads has many chains and every
    chain is short.  Chain rows are segment-major (read r, segment k) ->
    row r * s_per + k; every read owns exactly ``s_per`` segment rows
    (dead ones have seg_rlens 0 and cost no serial steps), so the
    (NS, seg) symbol rows reshape EXACTLY to (N, s_per * seg) and slice to
    max_len.

    rect_*: (NS, K_c) u32 segment rectangles (sliced at each checkpoint's
    word); tag_in: (N, TB) u8 packed tag bytes (plain-del mode) or
    (NS, Tt) i32 per-segment tag codes (run-del mode, codes t0..t0+Tt of
    the read's global kept-rank sequence); rlens (N,); seg_rlens (NS,);
    pos0 (4, NS) per-channel starting bit offsets in [0, 32); carr
    (2, NS) del/sub run carries (-1 = start at a run code; >= 0 = the
    checkpoint fell inside a run: prepend that many rchars and read the
    literal first).  Returns (5, N, max_len) u8 rows."""
    n = rlens.shape[0]

    def widen(rows_seg):
        """(NS, seg) segment rows -> (N, max_len) read rows."""
        r = rows_seg.reshape(n, s_per * seg)
        if s_per * seg < max_len:      # short-read bucket under the
            r = jnp.pad(r, ((0, 0), (0, max_len - s_per * seg)))
        return r[:, :max_len]          # 512-floor of the width bucket

    def tag_codes(runs):
        tp = runs.shape[1]
        codes_t = tag_in[:, :tp]
        if codes_t.shape[1] < tp:
            codes_t = jnp.pad(codes_t, ((0, 0), (0, tp - codes_t.shape[1])))
        return codes_t

    return _entry_rows(
        rect_del, tag_in, rect_ins, rect_mrg, rect_sub, seg_rlens, rlens,
        sids, f1, f2, types, del_char, sub_char, chain_len=seg,
        max_len=max_len, max_tokens=max_tokens, del_mode=del_mode,
        sub_mode=sub_mode, subw=subw, lmax=lmax, chan_l2=chan_l2,
        max_sym=None, pos0=pos0, carr=carr, widen=widen,
        tag_codes=tag_codes, kernel=kernel)
