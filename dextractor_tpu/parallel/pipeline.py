"""The flagship sharded codec pipeline.

Production flow for .dexqv at scale (the data-parallel form of the
reference's serial two-pass dexqv.c:79-143):

  phase A  ``sharded_qv_scan``  — every shard histograms its entries; the
           six 256-bin tables are ``psum``-reduced over the data axis so all
           hosts hold the *file-global* statistics (one Huffman table per
           file, matching QVcoding-per-file semantics, QV.c:922-1023);
  host     Huffman tables built once (256 symbols — microseconds) and
           broadcast as replicated LUT arrays;
  phase B  ``sharded_qv_encode`` — every shard encodes its own entries with
           the shared tables; outputs are variable-length per read, gathered
           back in original order host-side (shards are contiguous read
           blocks, so concatenation preserves order).

Both phases are `shard_map`-ed over a 1-D data mesh; the only collective is
the histogram ``psum`` (tiny: 6x256 i64) — everything else is embarrassingly
parallel, so the batch scales with the number of cards.

The single-device ``qv_encode_step`` is also the compile-check entry point
(see __graft_entry__.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..ops import bitstream_jax as bj
from .mesh import DATA_AXIS


def null_run_luts() -> np.ndarray:
    """A packed run-LUT that emits zero bits for run length 0.

    Used to run plain (non-RLE) streams through the uniform run-aware
    kernel: with rchar = -1 every valid position is a literal, all run
    lengths are 0, and the null LUT makes those emissions vanish.
    """
    return np.zeros(256, np.int32)


# ---------------------------------------------------------------------------
# single-device steps (jittable; vmapped over channels)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("run_on",))
def qv_encode_step(streams, lengths, sym_luts, run_luts, rchars, number_lut,
                   run_on=(True, True)):
    """Encode the five QV channels of a batch of entries on one device.

    streams:   (5, N, L) u8 — del, tag, ins, mrg, sub
    lengths:   (N,) i32
    sym_luts:  (4, 256) packed i32 — symbol LUTs for del, ins, mrg, sub
    run_luts:  (4, 256) packed i32 — run LUTs (null LUT for plain channels)
    rchars:    (4,) i32 — run char per channel (-1 for plain)
    number_lut:(256,) u8 — tag base numbering
    run_on:    STATIC (del_has_run_scheme, sub_has_run_scheme) — a
               channel without a run scheme is encoded by the reference
               as a plain stream (QV.c:1393-1423 branches on delChar/
               subChar), so routing it through the run emissions computes
               identical bytes at 2x the slots plus the run-scan
               machinery.  Callers that know the coding pass the real
               flags; the default keeps both on (always correct).

    Returns (words (4, N, M+1) u32, raw (4, N), out (4, N), dup, zext,
             packed_tags (N, L//4) u8, tag_clens (N,)).
    """
    # channel c (del/ins/mrg/sub LUT order) -> its stream plane
    chan_data = (streams[0], streams[2], streams[3], streams[4])
    run_cs = tuple(c for c, on in ((0, run_on[0]), (3, run_on[1])) if on)
    plain_cs = tuple(c for c in (0, 1, 2, 3) if c not in run_cs)

    def mix(rv, pv):
        parts = {}
        for j, c in enumerate(run_cs):
            parts[c] = rv[j]
        for j, c in enumerate(plain_cs):
            parts[c] = pv[j]
        return jnp.stack([parts[c] for c in range(4)])

    def one_run(d, sl, rl, rc):
        v, n, t, lg = bj.run_emissions(d, lengths, rc, sl, rl)
        raw, out, dup, zext = bj.word_counts(t, lg)
        return v, n, raw, out, dup, zext

    def one_plain(d, sl):
        v, n, t, lg = bj.plain_emissions(d, lengths, sl)
        raw, out, dup, zext = bj.word_counts(t, lg)
        return v, n, raw, out, dup, zext

    # pack outside the channel vmap, channels folded into the row axis
    def pack2(v2, n2):
        c, nn, m = v2.shape
        w = bj.pack_words(v2.reshape(c * nn, m), n2.reshape(c * nn, m))
        return w.reshape(c, nn, m + 1)

    p_v, p_n, p_raw, p_out, p_dup, p_zext = jax.vmap(
        one_plain, in_axes=(0, 0))(
        jnp.stack([chan_data[c] for c in plain_cs]),
        sym_luts[jnp.array(plain_cs)])
    p_words = pack2(p_v, p_n)
    if run_cs:
        ri = jnp.array(run_cs)
        r_v, r_n, r_raw, r_out, r_dup, r_zext = jax.vmap(
            one_run, in_axes=(0, 0, 0, 0))(
            jnp.stack([chan_data[c] for c in run_cs]),
            sym_luts[ri], run_luts[ri], rchars[ri])
        r_words = pack2(r_v, r_n)
        # plain word rects are narrower — pad to one stacked shape
        pad = r_words.shape[2] - p_words.shape[2]
        p_words = jnp.pad(p_words, ((0, 0), (0, 0), (0, pad)))
    else:
        r_words = r_raw = r_out = r_dup = r_zext = ()
    words = mix(r_words, p_words)

    raw = mix(r_raw, p_raw)
    out = mix(r_out, p_out)
    dup = mix(r_dup, p_dup)
    zext = mix(r_zext, p_zext)

    packed, clens = _pack_tags(streams[1], streams[0], lengths, rchars[0], number_lut)
    return words, raw, out, dup, zext, packed, clens


def _pack_tags(tag_rows, del_rows, lengths, del_char, number_lut):
    """Pack_Tag + Number_Read + Compress_Read, batched (QV.c:810-819).

    Compaction of kept symbols to row starts via the shift network
    (destinations are ranks)."""
    from ..ops.twobit import pack_2bit

    n, l = tag_rows.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (n, l), 1)
    valid = col < lengths[:, None]
    keep = jnp.where(del_char >= 0,
                     valid & (del_rows != del_char.astype(jnp.uint8)), valid)
    codes = number_lut[tag_rows].astype(jnp.int32)
    (svals,) = bj.compact_monotone((codes,), keep)
    clens = keep.sum(axis=1)
    codes_c = jnp.where(col < clens[:, None], svals, 0).astype(jnp.uint8)
    return pack_2bit(codes_c, mask=False), clens


def _histogram256(data, weights):
    """256-bin histogram of u8 ``data`` over the positions where
    ``weights`` is nonzero (same total size), as an int32 scatter-add.

    Neighbouring positions add into different ones of 64 sub-histograms,
    summed at the end, so concurrent updates rarely hit the same bin."""
    idx = data.reshape(-1).astype(jnp.int32)
    w = weights.reshape(-1).astype(jnp.bool_).astype(jnp.int32)
    sub = jax.lax.broadcasted_iota(jnp.int32, idx.shape, 0) & 63
    hist = jnp.zeros(64 * 256, jnp.int32).at[sub * 256 + idx].add(w)
    return hist.reshape(64, 256).sum(axis=0)


_I32_INF = np.int32(0x7FFFFFFF)


@jax.jit
def qv_scan_step(streams, lengths):
    """Per-shard statistics (phase A): four 256-bin channel histograms,
    per-shard character totals, and the first-'n'-tag location.

    The run histograms need delChar/subChar which only exist after the
    global reduction, so they are a second tiny pass (``qv_run_hist_step``).
    NB: per-shard flat positions are int32 (shards < 2^31 chars).
    """
    _, n, l = streams.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (n, l), 1)
    valid = col < lengths[:, None]
    hists = jnp.stack([
        _histogram256(streams[0], valid),
        _histogram256(streams[2], valid),
        _histogram256(streams[3], valid),
        _histogram256(streams[4], valid),
    ])
    tot = lengths.astype(jnp.int32).sum()
    isn = valid & ((streams[1] == ord("n")) | (streams[1] == ord("N")))
    starts = (jnp.cumsum(lengths) - lengths).astype(jnp.int32)
    flatpos = jnp.where(isn, col + starts[:, None], _I32_INF)
    first_n = flatpos.min()
    first_entry = jnp.where(isn.any(axis=1),
                            jax.lax.broadcasted_iota(jnp.int32, (n,), 0), _I32_INF)
    first_entry = first_entry.min()
    # the delQV under the first 'n' tag
    amin = jnp.argmin(flatpos.reshape(-1))
    del_char_candidate = streams[0].reshape(-1)[amin].astype(jnp.int32)
    return hists, tot, first_n, first_entry, del_char_candidate


@jax.jit
def qv_run_hist_step(data, lengths, rchar):
    """Histogram_Runs over a shard (run-length buckets min(len,255))."""
    n, l = data.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (n, l), 1)
    valid = col < lengths[:, None]
    is_lit = valid & (data != rchar.astype(jnp.uint8))
    lit_pos = jnp.where(is_lit, col, -1)
    run_max = jax.lax.associative_scan(jnp.maximum, lit_pos, axis=1)
    prev_lit = jnp.concatenate(
        [jnp.full((n, 1), -1, jnp.int32), run_max[:, :-1]], axis=1)
    runlen = jnp.minimum(col - prev_lit - 1, 255)
    hist = _histogram256(runlen.astype(jnp.uint8), is_lit)
    last_lit = run_max[:, -1]
    trail = jnp.maximum(lengths - last_lit - 1, 0)
    t_hist = _histogram256(jnp.minimum(trail, 255).astype(jnp.uint8),
                           (trail > 0)[:, None])
    return hist + t_hist


@jax.jit
def qv_subchar_prefix_step(sub_rows, lengths, upto_entry):
    """Partial substitution histogram over entries [0, upto_entry] of a
    shard — the slice the subChar mode is chosen from (QV.c:1006-1017)."""
    n, l = sub_rows.shape
    row = jax.lax.broadcasted_iota(jnp.int32, (n, l), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (n, l), 1)
    w = (row <= upto_entry) & (col < lengths[:, None])
    return _histogram256(sub_rows, w)


# ---------------------------------------------------------------------------
# sharded wrappers (phase A reduction + phase B parallel encode)
# ---------------------------------------------------------------------------

def sharded_qv_scan(mesh):
    """shard_map'd scan: per-shard stats psum-reduced over the data axis."""
    def step(streams, lengths):
        hists, tot, first_n, first_entry, dcand = qv_scan_step(streams, lengths)
        hists = jax.lax.psum(hists, DATA_AXIS)
        tot = jax.lax.psum(tot, DATA_AXIS)
        # shards are contiguous read blocks in file order: the winning shard
        # is the lowest-ranked one containing any 'n' tag
        ai = jax.lax.axis_index(DATA_AXIS).astype(jnp.int32)
        has_n = first_n < _I32_INF
        winner = jax.lax.pmin(jnp.where(has_n, ai, _I32_INF), DATA_AXIS)
        mine = (ai == winner) & has_n
        dchar = jax.lax.pmax(jnp.where(mine, dcand, -1), DATA_AXIS)
        # winning shard id + its local entry index (for the run-hist phase)
        gentry = jax.lax.pmax(jnp.where(mine, first_entry, -1), DATA_AXIS)
        return hists, tot, winner, gentry, dchar

    return shard_map(
        step, mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P(DATA_AXIS)),
        out_specs=(P(), P(), P(), P(), P()))


def sharded_run_hist(mesh):
    """shard_map'd Histogram_Runs with per-shard masked lengths + psum."""
    def step(data, lengths, rchar):
        h = qv_run_hist_step(data, lengths, rchar)
        return jax.lax.psum(h, DATA_AXIS)

    return shard_map(
        step, mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P()),
        out_specs=P())


def sharded_hist_masked(mesh):
    """shard_map'd masked histogram + psum (for the subChar prefix)."""
    def step(data, lengths):
        n, l = data.shape
        col = jax.lax.broadcasted_iota(jnp.int32, (n, l), 1)
        return jax.lax.psum(_histogram256(data, col < lengths[:, None]),
                            DATA_AXIS)

    return shard_map(
        step, mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS)),
        out_specs=P())


def sharded_scan_to_stats(mesh, streams, lengths):
    """Full phase-A scan over a sharded batch, reproducing the sequential
    QVcoding_Scan semantics exactly (QV.c:922-1023): global histograms via
    psum, file-order delChar election, the subChar chosen from the prefix
    up to the 100k-char crossing entry, and run histograms from the
    discovery entries onward.  Returns a codecs.qv_codec.QVStats.
    """
    from ..codecs.qv_codec import QVStats
    from .multihost import mesh_put

    streams = np.asarray(streams)
    lengths_np = np.asarray(lengths).astype(np.int64)
    n = int(lengths_np.shape[0])
    nsh = mesh.devices.size
    # shard_map needs n % nsh == 0; pad with zero-length entries (all stats
    # are length-masked, so they contribute nothing) and keep real entries
    # in file order so the delChar election stays exact
    pad = (-n) % nsh
    if pad:
        streams = np.pad(streams, ((0, 0), (0, pad), (0, 0)))
        lengths_np = np.pad(lengths_np, (0, pad))
        n += pad
    per_shard = n // nsh

    put = mesh_put(mesh)
    streams_d = put(streams, P(None, DATA_AXIS, None))
    del_d = put(streams[0], P(DATA_AXIS, None))
    sub_d = put(streams[4], P(DATA_AXIS, None))

    hists, tot, winner, gentry, dchar = sharded_qv_scan(mesh)(
        streams_d, put(lengths_np.astype(np.int32), P(DATA_AXIS)))
    hists = np.asarray(hists).astype(np.int64)
    del_char = int(dchar)
    entry_idx = np.arange(n)

    del_run = np.ones(256, np.int64)
    if del_char >= 0:
        r0 = int(winner) * per_shard + int(gentry)
        masked = put(np.where(entry_idx >= r0, lengths_np, 0)
                     .astype(np.int32), P(DATA_AXIS))
        del_run += np.asarray(sharded_run_hist(mesh)(
            del_d, masked,
            put(np.int32(del_char), P()))).astype(np.int64)

    sub_run = np.ones(256, np.int64)
    sub_char = -1
    total = int(tot)
    cum = np.cumsum(lengths_np)
    if total >= 100000:
        r1 = int(np.searchsorted(cum, 100000, "left"))
        masked = put(np.where(entry_idx <= r1, lengths_np, 0)
                     .astype(np.int32), P(DATA_AXIS))
        part = np.asarray(sharded_hist_masked(mesh)(sub_d, masked))
        sub_char = int(np.argmax(part))
        masked2 = put(np.where(entry_idx >= r1, lengths_np, 0)
                      .astype(np.int32), P(DATA_AXIS))
        sub_run += np.asarray(sharded_run_hist(mesh)(
            sub_d, masked2,
            put(np.int32(sub_char), P()))).astype(np.int64)

    return QVStats(hists[0], hists[1], hists[2], hists[3], del_run, sub_run,
                   del_char, sub_char, total)


def sharded_decode_plain(mesh, *, max_len: int):
    """shard_map'd batch Huffman decode: container image + tables
    replicated, the per-read bit-chains sharded over the data axis (reads
    are independent chains — the decode analog of DB-block parallelism,
    DB.c:2575-2621)."""
    from ..ops import decode_jax as dj

    def step(buf, starts, rlens, sym_ids, lookups, lens_t, types):
        return dj.decode_plain_batch(buf, starts, rlens, sym_ids, lookups,
                                     lens_t, types, max_len=max_len)

    return shard_map(
        step, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                  P(), P(), P()),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)))


def sharded_decode_run(mesh, *, max_tokens: int):
    """shard_map'd RLE-stream decode (see sharded_decode_plain)."""
    from ..ops import decode_jax as dj

    def step(buf, starts, rlens, sym_ids, run_ids, lookups, lens_t, types):
        return dj.decode_run_batch(buf, starts, rlens, sym_ids, run_ids,
                                   lookups, lens_t, types,
                                   max_tokens=max_tokens)

    return shard_map(
        step, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                  P(DATA_AXIS), P(), P(), P()),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS),
                   P(DATA_AXIS), P(DATA_AXIS)))


def sharded_lanes(mesh, fn, *args):
    """``fn(*args)`` shard_map'd over the data axis, every argument and
    output split on its leading axis of independent chains (the GPU chain
    kernel's lanes).  Lanes are zero-padded to the device count (a chain
    of length 0 costs no steps) and the padding is cut from the outputs.
    """
    m = len(args[0])
    pad = (-m) % mesh.devices.size
    # check_vma=False: the GPU chain kernel's pallas_call out_shapes carry
    # no vma annotation
    outs = shard_map(
        fn, mesh=mesh, in_specs=(P(DATA_AXIS),) * len(args),
        out_specs=P(DATA_AXIS), check_vma=False)(
            *(jnp.asarray(np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1)))
              for a in args))
    return tuple(o[:m] for o in outs)


def sharded_decode_entry(mesh, *, max_len: int, max_tokens: int,
                         del_mode: str, sub_mode: str, subw: int,
                         lmax: int, chan_l2: tuple | None = None,
                         max_sym: int | None = None,
                         kernel: str | None = None):
    """shard_map'd fused five-channel entry decode (single coding):
    tables replicated, the per-channel word rectangles and the chains
    sharded over the data axis (ops/decode2)."""
    from ..ops import decode2 as d2

    def step(rect_del, tag_bytes, rect_ins, rect_mrg, rect_sub, rlens,
             sids, f1, f2, types, del_char, sub_char):
        return d2.decode_entry_batch2(
            rect_del, tag_bytes, rect_ins, rect_mrg, rect_sub, rlens,
            sids, f1, f2, types, del_char, sub_char,
            max_len=max_len, max_tokens=max_tokens, del_mode=del_mode,
            sub_mode=sub_mode, subw=subw, lmax=lmax, chan_l2=chan_l2,
            max_sym=max_sym, kernel=kernel)

    # check_vma=False: the per-shard body may run the GPU chain kernel,
    # whose pallas_call out_shapes carry no vma annotation
    return shard_map(
        step, mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None),
                  P(DATA_AXIS, None), P(DATA_AXIS, None),
                  P(DATA_AXIS, None), P(DATA_AXIS), P(), P(), P(), P(),
                  P(), P()),
        out_specs=P(None, DATA_AXIS, None), check_vma=False)


def sharded_decode_entry_seg(mesh, *, seg: int, s_per: int, max_len: int,
                             max_tokens: int, del_mode: str, sub_mode: str,
                             subw: int, lmax: int,
                             chan_l2: tuple | None = None,
                             kernel: str | None = None):
    """shard_map'd checkpoint-segmented entry decode (single coding).

    Segments shard exactly like reads: rows are segment-major
    (read r, segment k) -> row r*s_per + k, so slicing the NS axis into
    equal per-device blocks keeps every read's segments on one device
    when N is a device-count multiple (the caller pads reads, and each
    pad read contributes s_per dead segment rows).  Inside the shard the
    body is the ordinary single-device step — the widen() reshape sees
    the shard-local (ns_loc, seg) -> (n_loc, s_per*seg) rows.
    """
    from ..ops import decode2 as d2

    def step(rect_del, tag_in, rect_ins, rect_mrg, rect_sub, rlens,
             seg_rlens, pos0, carr, sids, f1, f2, types, del_char,
             sub_char):
        return d2.decode_entry_batch_seg(
            rect_del, tag_in, rect_ins, rect_mrg, rect_sub, rlens,
            seg_rlens, pos0, carr, sids, f1, f2, types, del_char,
            sub_char, seg=seg, s_per=s_per, max_len=max_len,
            max_tokens=max_tokens, del_mode=del_mode, sub_mode=sub_mode,
            subw=subw, lmax=lmax, chan_l2=chan_l2, kernel=kernel)

    # tag_in is (N, TB) packed bytes in plain-del mode and (NS, Tt)
    # per-segment codes in run-del mode — both shard on axis 0.
    # check_vma=False: the per-shard body may run the GPU chain kernel,
    # whose pallas_call out_shapes carry no vma annotation
    return shard_map(
        step, mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None),
                  P(DATA_AXIS, None), P(DATA_AXIS, None),
                  P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS),
                  P(None, DATA_AXIS), P(None, DATA_AXIS),
                  P(), P(), P(), P(), P(), P()),
        out_specs=P(None, DATA_AXIS, None), check_vma=False)


def sharded_qv_encode(mesh, run_on=(True, True)):
    """shard_map'd phase B: replicated tables, sharded entries."""
    def step(streams, lengths, sym_luts, run_luts, rchars, number_lut):
        return qv_encode_step(streams, lengths, sym_luts, run_luts, rchars,
                              number_lut, run_on=run_on)

    return shard_map(
        step, mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P(DATA_AXIS),
                  P(), P(), P(), P()),
        out_specs=(P(None, DATA_AXIS, None), P(None, DATA_AXIS),
                   P(None, DATA_AXIS), P(None, DATA_AXIS), P(None, DATA_AXIS),
                   P(DATA_AXIS, None), P(DATA_AXIS)))


def sharded_twobit_encode(mesh, alphabet: str | None = "base"):
    """shard_map'd 2-bit pack (the .dexta/.dexar compute path at scale).

    The codec is purely elementwise per read (Compress_Read, DB.c:319-338),
    so reads shard over the data axis with **zero collectives** — the
    scaling limit is container assembly on the hosts, not the mesh.
    Rows are the ascii rectangle, tables replicated.  For the known
    alphabets the letter map + pack run as ops/twobit.pack_translate
    (arithmetic, gather-free); ``alphabet=None`` keeps the generic LUT
    path for arbitrary tables.
    """
    def step(ascii_rows, lengths, number_lut):
        from ..ops import twobit as tb

        if alphabet in ("base", "arrow"):
            return tb.pack_translate(ascii_rows, lengths, alphabet=alphabet)
        codes = number_lut[ascii_rows]
        return tb.pack_2bit(codes, lengths)

    return shard_map(
        step, mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P()),
        out_specs=P(DATA_AXIS, None))


def sharded_twobit_decode(mesh):
    """shard_map'd 2-bit unpack + letter map (Uncompress_Read reversed)."""
    def step(packed_rows, letter_lut):
        from ..ops import twobit as tb

        return tb.unpack_translate(packed_rows, letter_lut)

    return shard_map(
        step, mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P()),
        out_specs=P(DATA_AXIS, None))
