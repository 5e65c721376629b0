"""Batched device QV entry decode shared by the DB reader and the raw
`.dexqv` container path.

A .dexqv entry is five butted Huffman streams (QV.c:1381-1426); decoding a
*batch* of entries is N independent bit-chains once each entry's first
stream offset is known (the Dazzler DB stores them as ``coff``; for raw
containers the native walker's lens-only pass recovers them).  Within an
entry the later streams' offsets follow arithmetically from the earlier
ones via the encoder's word-count formula, so the device chains
del -> tag -> ins -> mrg -> sub itself, one fori_loop symbol step per
iteration across all lanes (ops/decode_jax.py).

Run expansion, tag unpacking and the inter-phase offset arithmetic are
vectorized host-side NumPy — tiny compared to the Huffman chains.
"""

from __future__ import annotations

import numpy as np

from ..formats.ragged import bucket_len, flat_gather_lens, next_pow2
from ..ops import twobit as tb


def decode_tables_v2(coding):
    """Coding -> gather-free two-level decode tables (ops/decode2).

    Returns (sids (6,) i32, f1 (S,256) i32, f2 flat i32, types (S,) i32,
    del_mode, sub_mode, subw, lmax)."""
    from ..ops.decode2 import scheme_tables2

    schemes = []

    def sidx(s):
        if s is None:
            return 0          # never dereferenced for absent run schemes
        schemes.append(s)
        return len(schemes) - 1

    sids = np.array([
        sidx(coding.del_scheme), sidx(coding.drun_scheme),
        sidx(coding.ins_scheme), sidx(coding.mrg_scheme),
        sidx(coding.sub_scheme), sidx(coding.srun_scheme)], np.int32)
    f1, f2, subw, lmax = scheme_tables2(schemes)
    types = np.array([s.type for s in schemes], np.int32)
    del_mode = "run" if coding.del_char >= 0 else "plain"
    sub_mode = "run" if coding.sub_char >= 0 else "plain"
    return sids, f1, f2, types, del_mode, sub_mode, subw, lmax


def channel_rects(buf: np.ndarray, starts: np.ndarray, coffs: np.ndarray,
                  max_len: int):
    """Slice the five per-channel rectangles out of a container image.

    starts (N,) i64 entry stream offsets; coffs (N, 5) i32 per-entry byte
    offsets of tag/ins/mrg/sub/end relative to the entry start (native
    lens walk).  Returns (rect_del, tag_bytes, rect_ins, rect_mrg,
    rect_sub) — chain rects are word-aligned u32 with pow2-bucketed widths
    (+12 words of window slack), tag_bytes is (N, max_len//4) u8."""
    from ..ops import decode2 as d2

    buf = np.asarray(buf, np.uint8)
    starts = np.asarray(starts, np.int64)
    coffs = np.asarray(coffs, np.int64)
    if len(starts) == 0:
        coffs = np.zeros((0, 5), np.int64)

    def chain_rect(beg, end):
        blen = int((end - beg).max(initial=0))
        k = next_pow2(((blen + 3) // 4) + 12)
        return d2.build_entry_rect(buf, starts + beg, k)

    zero = np.zeros(len(starts), np.int64)
    rect_del = chain_rect(zero, coffs[:, 0])
    rect_ins = chain_rect(coffs[:, 1], coffs[:, 2])
    rect_mrg = chain_rect(coffs[:, 2], coffs[:, 3])
    rect_sub = chain_rect(coffs[:, 3], coffs[:, 4])
    tb = max(max_len // 4, 1)
    idx = (starts + coffs[:, 0])[:, None] + np.arange(tb)
    tag_bytes = buf[np.minimum(idx, max(len(buf) - 1, 0))]
    return rect_del, tag_bytes, rect_ins, rect_mrg, rect_sub


def pow2_words(span_bytes, slack: int) -> np.ndarray:
    """Pow2 rectangle width in u32 words (at least 64) for streams of up
    to ``span_bytes`` bytes plus ``slack`` words of window slack: the one
    width-bucket rule of the chain rectangles."""
    return np.maximum(64, 2 ** np.ceil(np.log2(np.maximum(
        np.asarray(span_bytes, np.int64) // 4 + slack, 1))).astype(np.int64))


def span_buckets(coffs) -> np.ndarray:
    """Per-entry pow2 rect-width bucket key from the lens walk's channel
    offsets — the rect width the entry's widest channel needs (== what
    channel_rects picks for a batch of just this entry).  Entries sharing
    a key decode in one launch at that rectangle width."""
    coffs_a = np.asarray(coffs, np.int64)
    if len(coffs_a) == 0:
        return np.zeros(0, np.int64)
    spans = np.maximum.reduce([
        coffs_a[:, 0],
        coffs_a[:, 2] - coffs_a[:, 1],
        coffs_a[:, 3] - coffs_a[:, 2],
        coffs_a[:, 4] - coffs_a[:, 3]])
    return pow2_words(spans, 12)


def fused_decode_entries(buf: np.ndarray, starts: np.ndarray,
                         rlens: np.ndarray, coffs: np.ndarray,
                         ntoks: np.ndarray, coding, mesh=None):
    """Single-coding batch decode through the fused gather-free device
    step (ops/decode2.decode_entry_batch2): all five channels, run
    expansion and tag interleave on device.  Each channel's bytes are
    laid out as a dense word-aligned rectangle host-side (memcpy speed),
    so the device fetches only the channel being decoded and never
    random-accesses the container image; run chains are bounded by the
    lens walk's exact token counts.

    Entries are split into compressed-length buckets (one launch per
    bucket) so a realistic PacBio length mix decodes each read at its
    own bucket's geometry — a single 60 kb read does not inflate every
    short read's padded rectangle and plane width.  Returns
    (5, N, max_len) u8 rows with max_len the global bucket."""
    import jax.numpy as jnp
    from ..ops import decode2 as d2
    from ..utils.dispatch import chain_kernel

    rlens = np.asarray(rlens, np.int32)
    starts = np.asarray(starts, np.int64)
    coffs_a = np.asarray(coffs, np.int64)
    ntoks_a = np.asarray(ntoks)
    n = len(starts)
    # quarter-octave buckets (not pow2): every (N, max_len) plane op —
    # expand network, tag route, masks, the output stack — pays the full
    # padded width, and pow2 made that up to 2x the data (max_len 4096
    # vs a longest read of 2050 at the benchmark's shapes)
    gmax_len = bucket_len(int(rlens.max(initial=0)), 512)
    sids, f1, f2, types, del_mode, sub_mode, subw, lmax = \
        decode_tables_v2(coding)
    chan_l2 = tuple(bool(((f1[sids[k]] >> 20) & 1).any())
                    for k in range(6))
    args_rep = (jnp.asarray(sids), jnp.asarray(f1), jnp.asarray(f2),
                jnp.asarray(types), jnp.int32(coding.del_char & 0xFF),
                jnp.int32(coding.sub_char & 0xFF))

    def launch(sel):
        rl_b = rlens[sel]
        max_len = bucket_len(int(rl_b.max(initial=0)), 512)
        max_sym = bucket_len(int(rl_b.max(initial=0)))
        max_tokens = bucket_len(int(ntoks_a[sel].max(initial=0)), 16)
        rects = channel_rects(buf, starts[sel], coffs_a[sel], max_len)
        statics = dict(max_len=max_len, max_tokens=max_tokens,
                       del_mode=del_mode, sub_mode=sub_mode, subw=subw,
                       lmax=lmax, chan_l2=chan_l2, max_sym=max_sym,
                       kernel=chain_kernel())
        if mesh is None:
            rows = d2.decode_entry_batch2(
                *(jnp.asarray(r) for r in rects), jnp.asarray(rl_b),
                *args_rep, **statics)
            return rows, max_len
        from ..parallel.pipeline import sharded_decode_entry
        fn = sharded_decode_entry(mesh, **statics)
        pad = (-len(sel)) % mesh.devices.size
        rows = fn(*(jnp.asarray(np.pad(r, ((0, pad), (0, 0))))
                    for r in rects),
                  jnp.asarray(np.pad(rl_b, (0, pad))), *args_rep)
        return rows[:, : len(sel)], max_len

    kws = span_buckets(coffs_a)
    uniq = np.unique(kws)
    if len(uniq) <= 1:
        rows, _ = launch(np.arange(n))
        return rows
    out = np.zeros((5, n, gmax_len), np.uint8)
    for kw in uniq:
        sel = np.flatnonzero(kws == kw)
        rows, ml = launch(sel)
        out[:, sel, :ml] = np.asarray(rows)
    return out


def batch_decode_entries(buf: np.ndarray, starts: np.ndarray,
                         rlens: np.ndarray, codings, table: np.ndarray,
                         ascii_mode: int = 1, mesh=None):
    """Decode all five QV streams of N entries in parallel.

    buf:     (B,) u8 container image (will be padded with 8 zero bytes)
    starts:  (N,) i64 byte offset of each entry's delQV stream
    rlens:   (N,) i32 symbols per entry
    codings: list of QVCoding; table: (N,) index of each entry's coding
    mesh:    optional jax Mesh — shard the Huffman chains over its data axis

    Returns (rows (5, N, max_len) u8, rlens (N,) i64).
    """
    import jax.numpy as jnp
    from ..ops import decode_jax as dj

    n = len(starts)
    rlens = np.asarray(rlens, np.int32)
    # quarter-octave bucket (see fused_decode_entries): plane ops pay the
    # padded width, so pow2 wastes up to 2x on every channel
    max_len = bucket_len(int(rlens.max(initial=0)), 512)
    buf = np.concatenate([np.asarray(buf, np.uint8), np.zeros(8, np.uint8)])
    bufd = jnp.asarray(buf)

    schemes, sids = [], {k: [] for k in
                         ("del", "drun", "ins", "mrg", "sub", "srun")}
    del_chars, sub_chars = [], []

    def sidx(s):
        if s is None:
            return -1
        s.with_lookup()
        schemes.append(s)
        return len(schemes) - 1

    for c in codings:
        sids["del"].append(sidx(c.del_scheme))
        sids["drun"].append(sidx(c.drun_scheme))
        sids["ins"].append(sidx(c.ins_scheme))
        sids["mrg"].append(sidx(c.mrg_scheme))
        sids["sub"].append(sidx(c.sub_scheme))
        sids["srun"].append(sidx(c.srun_scheme))
        del_chars.append(c.del_char)
        sub_chars.append(c.sub_char)
    lookups = jnp.asarray(np.stack([s.lookup for s in schemes]).astype(np.int32))
    lens_t = jnp.asarray(np.stack([s.codelens for s in schemes]).astype(np.int32))
    types_np = np.array([s.type for s in schemes], np.int32)
    types = jnp.asarray(types_np)
    tbl = np.asarray(table, np.int64)
    r_delc = np.array(del_chars, np.int32)[tbl]
    r_subc = np.array(sub_chars, np.int32)[tbl]

    if mesh is not None:
        from ..parallel.pipeline import (
            sharded_decode_plain, sharded_decode_run)
        plain_fn = sharded_decode_plain(mesh, max_len=max_len)
        run_fn = sharded_decode_run(mesh, max_tokens=max_len)
        nsh = mesh.devices.size
    else:
        plain_fn = run_fn = None

    starts = np.asarray(starts, np.int64)
    out = np.empty((5, n, max_len), np.uint8)

    # GPU path: the chain kernel over dense per-entry rectangles, every
    # lane with its own scheme ids (the reads of a multi-cell DB decode in
    # one launch per rectangle width).  With a mesh the same kernel runs
    # per shard under shard_map, so per-read decode cost does not depend
    # on partitioning (DB.c:2575-2621 consumption).
    from ..utils.dispatch import chain_kernel

    kernel = chain_kernel()
    if kernel:
        from ..ops.decode2 import scheme_tables2, build_entry_rect
        from ..ops import chain_gpu as cg

        f1_t, f2_t, subw_t, lmax_t = scheme_tables2(schemes)
        f1_j, f2_j = jnp.asarray(f1_t), jnp.asarray(f2_t)
        # per-entry byte span bounds any channel's stream length
        entry_ends = np.concatenate([starts[1:], np.array([len(buf)])])
        interp = kernel == "interpret"

    def _kw_buckets(starts_b, rl):
        """Split chains by pow2 rect width so long entries get their own
        rectangle and short ones are not padded to it; each bucket decodes
        at its own longest chain's width.  Yields (sel, rect, width)."""
        # the channel start lies inside its entry; the entry end bounds
        # the channel's stream length
        eidx = np.searchsorted(starts, starts_b, "right") - 1
        kws = pow2_words(entry_ends[eidx] - starts_b, 16)
        for kw in np.unique(kws):
            sel = np.flatnonzero(kws == kw)
            yield (sel, build_entry_rect(buf, starts_b[sel], int(kw)),
                   bucket_len(int(rl[sel].max(initial=0))))

    def _k_dispatch(fn, *args):
        """``fn(*args)`` on one device, or per shard over ``mesh``."""
        if mesh is None:
            return fn(*(jnp.asarray(a) for a in args))
        from ..parallel.pipeline import sharded_lanes
        return sharded_lanes(mesh, fn, *args)

    def _signals(ids):
        return np.where(types_np[ids] == 2, 255, 256).astype(np.int32)

    def _k_plain(starts_b, rl, sym_ids):
        o = np.zeros((len(starts_b), max_len), np.uint8)
        bits = np.zeros(len(starts_b), np.int64)
        lg = np.zeros(len(starts_b), np.int64)
        for sel, rect, ms in _kw_buckets(starts_b, rl):
            def fn(rect_, rl_, sid_, sig_, ms=ms):
                return cg.plain_chains_gpu(
                    rect_, rl_, sid_, sig_, rl_ * 0, f1_j, f2_j,
                    max_len=ms, subw=subw_t, lmax=lmax_t, interpret=interp)

            rows, b, g = _k_dispatch(fn, rect, rl[sel], sym_ids[sel],
                                     _signals(sym_ids[sel]))
            o[sel, :ms] = np.asarray(rows)
            bits[sel] = np.asarray(b)
            lg[sel] = np.asarray(g)
        return o, bits, lg

    def _k_run(starts_b, rl, sym_ids, run_ids):
        runs = np.zeros((len(starts_b), max_len), np.int32)
        lits = np.full((len(starts_b), max_len), -1, np.int32)
        bits = np.zeros(len(starts_b), np.int64)
        lg = np.zeros(len(starts_b), np.int64)
        for sel, rect, ms in _kw_buckets(starts_b, rl):
            # every token of a live chain emits at least one symbol
            def fn(rect_, rl_, rid_, sid_, sig_, ms=ms):
                return cg.run_chains_gpu(
                    rect_, rl_, rid_, sid_, sig_, rl_ * 0, rl_ * 0 - 1, f1_j,
                    f2_j, max_tokens=ms, subw=subw_t, lmax=lmax_t,
                    interpret=interp)

            r_, l_, b, g = _k_dispatch(fn, rect, rl[sel], run_ids[sel],
                                       sym_ids[sel], _signals(sym_ids[sel]))
            runs[sel, :ms] = np.asarray(r_)
            lits[sel, :ms] = np.asarray(l_)
            bits[sel] = np.asarray(b)
            lg[sel] = np.asarray(g)
        return runs, lits, None, bits, lg

    def _pad(a):
        return jnp.asarray(np.pad(a, (0, (-len(a)) % nsh)))

    def _xla_plain(starts_b, rl, sym_ids):
        if mesh is None:
            return dj.decode_plain_batch(
                bufd, jnp.asarray(starts_b), jnp.asarray(rl),
                jnp.asarray(sym_ids), lookups, lens_t, types,
                max_len=max_len)
        o, b, lg = plain_fn(bufd, _pad(starts_b), _pad(rl), _pad(sym_ids),
                            lookups, lens_t, types)
        m = len(starts_b)
        return o[:m], b[:m], lg[:m]

    def _xla_run(starts_b, rl, sym_ids, run_ids):
        if mesh is None:
            return dj.decode_run_batch(
                bufd, jnp.asarray(starts_b), jnp.asarray(rl),
                jnp.asarray(sym_ids), jnp.asarray(run_ids), lookups,
                lens_t, types, max_tokens=max_len)
        runs, lits, em, b, lg = run_fn(
            bufd, _pad(starts_b), _pad(rl), _pad(sym_ids), _pad(run_ids),
            lookups, lens_t, types)
        m = len(starts_b)
        return runs[:m], lits[:m], em[:m], b[:m], lg[:m]

    def _plain(starts_b, rl, sym_ids):
        if kernel:
            return _k_plain(starts_b, rl, sym_ids)
        return _xla_plain(starts_b, rl, sym_ids)

    def _run(starts_b, rl, sym_ids, run_ids):
        if kernel:
            return _k_run(starts_b, rl, sym_ids, run_ids)
        return _xla_run(starts_b, rl, sym_ids, run_ids)

    def channel(starts_b, key, run_key, rchars):
        """Decode one channel for all reads; returns (rows, words)."""
        sym_ids = np.array(sids[key], np.int32)[tbl]
        plain = rchars < 0
        rows = np.zeros((n, max_len), np.uint8)
        bits = np.zeros(n, np.int64)
        last = np.zeros(n, np.int64)
        for mask, runmode in ((plain, False), (~plain, True)):
            idx = np.flatnonzero(mask)
            if not len(idx):
                continue
            if not runmode:
                o, b, lg = _plain(starts_b[idx], rlens[idx], sym_ids[idx])
                rows[idx] = np.asarray(o)
            else:
                run_ids = np.array(sids[run_key], np.int32)[tbl]
                runs, lits, _, b, lg = _run(starts_b[idx], rlens[idx],
                                            sym_ids[idx], run_ids[idx])
                runs = np.asarray(runs)
                lits = np.asarray(lits)
                for rc in np.unique(rchars[idx]):
                    sel = idx[rchars[idx] == rc]
                    isel = np.flatnonzero(rchars[idx] == rc)
                    ex = dj.expand_runs_np(runs[isel], lits[isel],
                                           rlens[sel], int(rc))
                    rows[sel, : ex.shape[1]] = ex
            bits[idx] = np.asarray(b)
            last[idx] = np.asarray(lg)
        return rows, dj.stream_word_counts(bits, last)

    # phase A: delQV; its content determines the packed-tag length
    out[0], del_w = channel(starts, "del", "drun", r_delc)
    col = np.arange(max_len)[None, :]
    valid = col < rlens[:, None]
    clens = np.where(
        r_delc < 0, rlens.astype(np.int64),
        (valid & (out[0] != r_delc[:, None])).sum(1)).astype(np.int64)
    tlens = (clens + 3) >> 2

    # packed delTag: gather + unpack + Unpack_Tag (vectorized)
    tag_starts = starts + 4 * del_w
    packed = flat_gather_lens(buf, tag_starts, tlens)
    prow = np.zeros((n, (max_len + 3) >> 2), np.uint8)
    if tlens.sum():
        st = np.zeros(n, np.int64)
        np.cumsum(tlens[:-1], out=st[1:])
        rr = np.repeat(np.arange(n), tlens)
        cc = np.arange(int(tlens.sum())) - np.repeat(st, tlens)
        prow[rr, cc] = packed
    codes = tb.unpack_2bit_np(prow)[:, :max_len]
    kept = tb.LOWER_LUT[codes]
    tag = np.full((n, max_len), ord("n"), np.uint8)
    keepmask = valid & ((out[0] != r_delc[:, None]) | (r_delc < 0)[:, None])
    kidx = np.cumsum(keepmask, 1) - 1
    tag[keepmask] = kept[np.repeat(np.arange(n), keepmask.sum(1)),
                         kidx[keepmask]]
    out[1] = tag

    # phases B-D: ins, mrg, sub chained by arithmetic offsets
    ins_starts = tag_starts + tlens
    out[2], ins_w = channel(ins_starts, "ins", None,
                            np.full(n, -1, np.int32))
    mrg_starts = ins_starts + 4 * ins_w
    out[3], mrg_w = channel(mrg_starts, "mrg", None,
                            np.full(n, -1, np.int32))
    sub_starts = mrg_starts + 4 * mrg_w
    out[4], _ = channel(sub_starts, "sub", "srun", r_subc)

    if ascii_mode == 2:
        out[1] = out[1] - 32
    elif ascii_mode == 0:
        out[1] = tb.NUMBER_BASE_LUT[out[1]]
    return out, rlens.astype(np.int64)


# ---------------------------------------------------------------------------
# segmented decode (long reads at short-chain speed)
# ---------------------------------------------------------------------------

def build_seg_launch(buf, starts, rlens, coffs, ntoks, coding, ck, sel):
    """Device args + statics for decode2.decode_entry_batch_seg over the
    reads ``sel`` (one segs-per-read bucket).

    Each read becomes s_per = ceil(bucket_max_rlen / seg) segment chains
    (dead tails for shorter reads); segment k >= 1 of a channel starts at
    the walker checkpoint's bit offset (rect row sliced at that word,
    pos0 = bit & 31).  Returns (args tuple, statics dict, s_per)."""
    from ..ops.decode2 import build_entry_rect

    seg, ck_offs, ckb, ckt, ckc = ck
    starts = np.asarray(starts, np.int64)[sel]
    coffs_a = np.asarray(coffs, np.int64)[sel]
    ntoks_a = np.asarray(ntoks)[sel]
    rl = np.asarray(rlens, np.int64)[sel]
    cko = np.asarray(ck_offs, np.int64)[sel]
    btot = ckb.shape[1]
    n = len(sel)
    s_per = max(1, int(-(-int(rl.max(initial=1)) // seg)))
    max_len = bucket_len(int(rl.max(initial=0)), 512)
    seg_w = seg if s_per > 1 else min(seg, max_len)
    ns = n * s_per
    kk = np.arange(s_per)
    # checkpoint index of segment (r, k): k=0 has no checkpoint
    cidx = np.minimum(cko[:, None] + kk[None, :] - 1, btot - 1)
    cidx = np.maximum(cidx, 0)
    live_ck = (kk[None, :] >= 1) & (kk[None, :] * seg < rl[:, None])
    live_seg = kk[None, :] * seg < rl[:, None]
    seg_rlens = np.clip(rl[:, None] - kk[None, :] * seg, 0,
                        seg).astype(np.int32).reshape(ns)

    chan_beg = np.stack([np.zeros(n, np.int64), coffs_a[:, 1],
                         coffs_a[:, 2], coffs_a[:, 3]])
    chan_end = np.stack([coffs_a[:, 0], coffs_a[:, 2], coffs_a[:, 3],
                         coffs_a[:, 4]])
    rects, pos0 = [], []
    for c in range(4):
        bits = np.where(live_ck, ckb[c][cidx], 0).astype(np.int64)
        base = starts[:, None] + chan_beg[c][:, None]
        sbyte = base + (bits >> 5) * 4
        p0 = (bits & 31).astype(np.int32)
        # per-segment compressed span bounds the rect width: to the next
        # checkpoint (or the channel end) + window slack
        end_bits = np.concatenate(
            [bits[:, 1:], ((chan_end[c] - chan_beg[c]) * 8)[:, None]],
            axis=1)
        # a live segment's end is the NEXT LIVE checkpoint (or the
        # channel end for the read's last live segment); dead padding
        # segments must not inflate the rect width to the whole channel
        last_live = live_seg & ~np.concatenate(
            [live_seg[:, 1:], np.zeros((n, 1), bool)], axis=1)
        end_bits = np.where(
            last_live, ((chan_end[c] - chan_beg[c]) * 8)[:, None],
            end_bits)
        end_bits = np.maximum(end_bits, bits)
        span_w = ((end_bits - (bits & ~np.int64(31))) + 31) // 32
        span_w = np.where(live_seg, span_w, 1)
        kw = int(next_pow2(int(span_w.max(initial=1)) + 16))
        rects.append(build_entry_rect(buf, sbyte.reshape(ns), kw))
        pos0.append(p0.reshape(ns))
    pos0 = np.stack(pos0)

    del_run = coding.del_char >= 0
    sub_run = coding.sub_char >= 0
    carr = np.full((2, ns), -1, np.int32)
    if del_run:
        carr[0] = np.where(live_ck, ckc[0][cidx], -1).reshape(ns)
    if sub_run:
        carr[1] = np.where(live_ck, ckc[1][cidx], -1).reshape(ns)

    # per-segment token budget + tag codes (run-del): literal index t0
    t0d = np.where(live_ck, ckt[0][cidx], 0).astype(np.int64)
    t0s = np.where(live_ck, ckt[1][cidx], 0).astype(np.int64)
    spans = []
    for t0, on, tk in ((t0d, del_run, 0), (t0s, sub_run, 1)):
        if not on:
            continue
        t1 = np.concatenate([t0[:, 1:], ntoks_a[:, tk:tk + 1]], axis=1)
        last_live = live_seg & ~np.concatenate(
            [live_seg[:, 1:], np.zeros((n, 1), bool)], axis=1)
        t1 = np.where(last_live, ntoks_a[:, tk:tk + 1], t1)
        tok_span = np.where(live_seg, np.maximum(t1 - t0, 0), 0)
        spans.append(int(tok_span.max(initial=1)) + 2)
    max_tokens = bucket_len(max(spans, default=8), 16)

    if del_run:
        # tag codes t0..t0+Tt of each segment from the packed tag bytes
        tag_base = starts + coffs_a[:, 0]          # packed tag byte start
        idx = t0d.reshape(ns)[:, None] + np.arange(max_tokens)
        byte = buf[np.minimum(tag_base.repeat(s_per)[:, None]
                              + (idx >> 2), len(buf) - 1)]
        tag_in = ((byte >> (6 - 2 * (idx & 3))) & 3).astype(np.int32)
    else:
        tb = max(max_len // 4, 1)
        bidx = (starts + coffs_a[:, 0])[:, None] + np.arange(tb)
        tag_in = buf[np.minimum(bidx, len(buf) - 1)]

    args = (rects[0], tag_in, rects[1], rects[2], rects[3],
            np.asarray(rlens, np.int32)[sel], seg_rlens, pos0, carr)
    statics = dict(seg=seg_w, s_per=s_per, max_len=max_len,
                   max_tokens=max_tokens,
                   del_mode="run" if del_run else "plain",
                   sub_mode="run" if sub_run else "plain")
    return args, statics


def build_seg_launch_flat(buf, starts, rlens, coffs, ntoks, coding, ck):
    """ONE fused launch over every LIVE segment of every read.

    The bucketed scheme (seg_read_buckets + build_seg_launch) pads every
    read in a bucket to the bucket's max segments-per-read and pays a
    per-launch floor per bucket.  After checkpointing, segment rows are already uniform
    (<= ``seg`` symbols each, decode2.decode_entry_batch_seg), so the
    flat layout simply lists the live segments of ALL reads as
    independent rows (s_per == 1: each flat row IS a "read" of its
    segment's length), with zero dead rows and one launch for the whole
    batch.  The host scatters the (5, NS, seg) output rows back to read
    rows by (read, k) — fused_decode_entries_seg.

    Returns (args, statics, rid, kseg): args/statics feed
    decode_entry_batch_seg; rid/kseg (NS,) map flat rows to reads."""
    from ..ops.decode2 import build_entry_rect

    seg, ck_offs, ckb, ckt, ckc = ck
    starts = np.asarray(starts, np.int64)
    coffs_a = np.asarray(coffs, np.int64)
    ntoks_a = np.asarray(ntoks)
    rl = np.asarray(rlens, np.int64)
    cko = np.asarray(ck_offs, np.int64)
    n = len(starts)
    btot = ckb.shape[1]
    segs_per = np.maximum(-(-rl // seg), 1)        # rl == 0 keeps one row
    ns = int(segs_per.sum())
    rid = np.repeat(np.arange(n), segs_per)
    base = np.zeros(n, np.int64)
    np.cumsum(segs_per[:-1], out=base[1:])
    kseg = np.arange(ns) - np.repeat(base, segs_per)
    live_ck = kseg >= 1                            # row resumes mid-stream
    cidx = np.clip(cko[rid] + kseg - 1, 0, max(btot - 1, 0))
    seg_rlens = np.clip(rl[rid] - kseg * seg, 0, seg).astype(np.int32)
    seg_w = int(min(seg, bucket_len(int(seg_rlens.max(initial=1)), 512)))
    # a row's stream ends at the NEXT row's checkpoint when that row
    # belongs to the same read, else at the channel end
    nxt_same = (kseg + 1) < segs_per[rid]

    chan_beg = np.stack([np.zeros(n, np.int64), coffs_a[:, 1],
                         coffs_a[:, 2], coffs_a[:, 3]])
    chan_end = np.stack([coffs_a[:, 0], coffs_a[:, 2], coffs_a[:, 3],
                         coffs_a[:, 4]])
    rects, pos0 = [], []
    for c in range(4):
        bits = np.where(live_ck, ckb[c][cidx], 0).astype(np.int64)
        sbyte = starts[rid] + chan_beg[c][rid] + (bits >> 5) * 4
        p0 = (bits & 31).astype(np.int32)
        bits_next = np.concatenate([bits[1:], np.zeros(1, np.int64)])
        end_bits = np.where(
            nxt_same, bits_next,
            (chan_end[c] - chan_beg[c])[rid] * 8)
        end_bits = np.maximum(end_bits, bits)
        span_w = ((end_bits - (bits & ~np.int64(31))) + 31) // 32
        kw = int(next_pow2(int(span_w.max(initial=1)) + 16))
        rects.append(build_entry_rect(buf, sbyte, kw))
        pos0.append(p0)
    pos0 = np.stack(pos0)

    del_run = coding.del_char >= 0
    sub_run = coding.sub_char >= 0
    carr = np.full((2, ns), -1, np.int32)
    if del_run:
        carr[0] = np.where(live_ck, ckc[0][cidx], -1)
    if sub_run:
        carr[1] = np.where(live_ck, ckc[1][cidx], -1)

    t0d = np.where(live_ck, ckt[0][cidx], 0).astype(np.int64)
    t0s = np.where(live_ck, ckt[1][cidx], 0).astype(np.int64)
    spans = []
    for t0, on, tk in ((t0d, del_run, 0), (t0s, sub_run, 1)):
        if not on:
            continue
        t0_next = np.concatenate([t0[1:], np.zeros(1, np.int64)])
        t1 = np.where(nxt_same, t0_next, ntoks_a[rid, tk])
        spans.append(int(np.maximum(t1 - t0, 0).max(initial=1)) + 2)
    max_tokens = bucket_len(max(spans, default=8), 16)

    if del_run:
        tag_base = (starts + coffs_a[:, 0])[rid]
        idx = t0d[:, None] + np.arange(max_tokens)
        byte = buf[np.minimum(tag_base[:, None] + (idx >> 2),
                              len(buf) - 1)]
        tag_in = ((byte >> (6 - 2 * (idx & 3))) & 3).astype(np.int32)
    else:
        tbw = max(seg_w // 4, 1)
        bidx = ((starts + coffs_a[:, 0])[rid][:, None]
                + (kseg * (seg // 4))[:, None] + np.arange(tbw))
        tag_in = buf[np.minimum(bidx, len(buf) - 1)]

    args = (rects[0], tag_in, rects[1], rects[2], rects[3],
            seg_rlens, seg_rlens, pos0, carr)
    statics = dict(seg=seg_w, s_per=1, max_len=seg_w,
                   max_tokens=max_tokens,
                   del_mode="run" if del_run else "plain",
                   sub_mode="run" if sub_run else "plain")
    return args, statics, rid, kseg


def seg_read_buckets(rlens, seg: int, launch_cost: int = 2048):
    """Partition reads into segments-per-read buckets by a small DP.

    Every read in a launch is padded to the bucket's max segment count
    (dead chains), and every launch pays a fixed floor (dispatch and the
    five-channel plane machinery).  The DP over the
    sorted distinct segment counts minimizes
        sum over buckets [ n_b * S_b(max) + launch_cost ]
    (padded-chain units; launch_cost ~= the chain-equivalents of one
    launch floor), so dense counts get tight buckets and sparse tails
    merge."""
    rl = np.asarray(rlens, np.int64)
    segs = np.maximum(-(-rl // seg), 1)
    vals, counts = np.unique(segs, return_counts=True)
    m = len(vals)
    csum = np.concatenate([[0], np.cumsum(counts)])
    best = np.full(m + 1, np.inf)
    best[0] = 0.0
    choice = np.zeros(m + 1, np.int64)
    for i in range(1, m + 1):
        for j in range(i):
            cost = best[j] + (csum[i] - csum[j]) * vals[i - 1] + launch_cost
            if cost < best[i]:
                best[i] = cost
                choice[i] = j
    sels = []
    i = m
    while i > 0:
        j = int(choice[i])
        lo, hi = vals[j], vals[i - 1]
        sels.append(np.flatnonzero((segs >= lo) & (segs <= hi)))
        i = j
    return sels[::-1]


def _pad_seg_args(args, s_per: int, nsh: int):
    """Pad a build_seg_launch arg tuple with dead reads to a device-count
    multiple.  Each pad read contributes s_per dead segment rows
    (seg_rlens 0, zero rects, carry -1) that cost no serial steps and are
    masked by rlens == 0."""
    (rect_del, tag_in, rect_ins, rect_mrg, rect_sub, rl_sel, seg_rlens,
     pos0, carr) = args
    n = len(rl_sel)
    pad_n = (-n) % nsh
    if pad_n == 0:
        return args, n
    pad_ns = pad_n * s_per
    pr = lambda a, p: np.pad(a, ((0, p), (0, 0)))
    tag_pad = pad_n if tag_in.shape[0] == n else pad_ns
    args = (pr(rect_del, pad_ns), pr(tag_in, tag_pad), pr(rect_ins, pad_ns),
            pr(rect_mrg, pad_ns), pr(rect_sub, pad_ns),
            np.pad(rl_sel, (0, pad_n)), np.pad(seg_rlens, (0, pad_ns)),
            np.pad(pos0, ((0, 0), (0, pad_ns))),
            np.pad(carr, ((0, 0), (0, pad_ns)), constant_values=-1))
    return args, n


def fused_decode_entries_seg(buf, starts, rlens, coffs, ntoks, coding, ck,
                             mesh=None):
    """Checkpoint-segmented batch decode: every read runs as short chains
    (decode2.decode_entry_batch_seg).  Default: ONE flat launch over all
    live segments (build_seg_launch_flat — no per-bucket launch floors,
    no dead padded rows); DXT_SEG_FLAT=0 reverts to the round-3 bucketed
    scheme for A/B.  With ``mesh``, segment chains shard over the data
    axis (parallel/pipeline.sharded_decode_entry_seg).
    Returns (5, N, gmax_len) u8 numpy rows."""
    import os
    import jax.numpy as jnp
    from ..ops import decode2 as d2
    from ..utils.dispatch import chain_kernel

    rlens = np.asarray(rlens, np.int32)
    n = len(starts)
    gmax_len = bucket_len(int(rlens.max(initial=0)), 512)
    sids, f1, f2, types, del_mode, sub_mode, subw, lmax = \
        decode_tables_v2(coding)
    chan_l2 = tuple(bool(((f1[sids[k]] >> 20) & 1).any())
                    for k in range(6))
    kernel = chain_kernel()
    args_rep = (jnp.asarray(sids), jnp.asarray(f1), jnp.asarray(f2),
                jnp.asarray(types), jnp.int32(coding.del_char & 0xFF),
                jnp.int32(coding.sub_char & 0xFF))
    out = np.zeros((5, n, gmax_len), np.uint8)

    def launch(args, statics):
        if mesh is None:
            return d2.decode_entry_batch_seg(
                *(jnp.asarray(a) for a in args), *args_rep,
                subw=subw, lmax=lmax, chan_l2=chan_l2, kernel=kernel,
                **statics)
        from ..parallel.pipeline import sharded_decode_entry_seg
        args, nb = _pad_seg_args(args, statics["s_per"],
                                 mesh.devices.size)
        fn = sharded_decode_entry_seg(
            mesh, subw=subw, lmax=lmax, chan_l2=chan_l2, kernel=kernel,
            **statics)
        return fn(*(jnp.asarray(a) for a in args), *args_rep)[:, :nb]

    if os.environ.get("DXT_SEG_FLAT", "1") == "1":
        seg = ck[0]
        args, statics, rid, kseg = build_seg_launch_flat(
            buf, starts, rlens, coffs, ntoks, coding, ck)
        rows = np.asarray(launch(args, statics))      # (5, NS, seg_w)
        for k in np.unique(kseg):
            m = kseg == k
            w = min(rows.shape[2], gmax_len - int(k) * seg)
            out[:, rid[m], int(k) * seg:int(k) * seg + w] = rows[:, m, :w]
        return out

    for sel in seg_read_buckets(rlens, ck[0]):
        args, statics = build_seg_launch(buf, starts, rlens, coffs, ntoks,
                                         coding, ck, sel)
        ml = statics["max_len"]
        rows = launch(args, statics)
        out[:, sel, :ml] = np.asarray(rows)
    return out
