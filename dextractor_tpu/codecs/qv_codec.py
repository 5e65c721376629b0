""".quiva <-> .dexqv codec orchestration.

Two-pass flow matching dexqv.c:79-143: a statistics scan over the whole file
builds six histograms (with the reference's order-dependent delChar/subChar
discovery, QV.c:895-918), Huffman schemes are built once per file
(QV.c:1029-1136), then every entry's five streams are encoded.

The scan is fully vectorized; its histograms are exactly what the
``parallel`` package reduces with ``psum`` across shards before a single
table build.  Entry encoding uses the vectorized bitstream engine per
stream; the batched device path lives in ops/bitstream_jax.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.errors import FormatError
from ..formats import quiva as qv
from ..formats import dexqv as dq
from ..ops import twobit as tb
from ..ops import bitstream as bs
from ..ops.huffman import make_scheme

DEL, TAG, INS, MRG, SUB = range(5)


@dataclass
class QVStats:
    del_hist: np.ndarray
    ins_hist: np.ndarray
    mrg_hist: np.ndarray
    sub_hist: np.ndarray
    del_run: np.ndarray
    sub_run: np.ndarray
    del_char: int
    sub_char: int
    tot_char: int


def _run_hist_entries(streams_flat, offsets, r0, rchar):
    """Histogram_Runs (QV.c:702-724) over entries [r0, n) — vectorized
    over the flat region instead of a per-entry tokenize loop.

    Token semantics match bitstream.tokenize_runs: one run token (the
    rchar run length, possibly 0) before each literal, plus a trailing
    symbol-less run token when an entry ends in rchar characters."""
    lo, hi = int(offsets[r0]), int(offsets[-1])
    hist = np.zeros(256, np.int64)
    if hi <= lo:
        return hist
    seg = streams_flat[lo:hi]
    bnd = np.asarray(offsets[r0:], np.int64) - lo    # boundaries, 0..len
    try:                 # single native pass; NumPy fallback below builds
        from ..native import qv_encode_shim   # ~30x its size in temporaries
        import ctypes

        lib = qv_encode_shim()
        seg_c = np.ascontiguousarray(seg)
        bnd_c = np.ascontiguousarray(bnd)
        lib.dxt_run_hist(seg_c.ctypes.data_as(ctypes.c_void_p),
                         bnd_c.ctypes.data_as(ctypes.c_void_p),
                         len(bnd_c) - 1, int(rchar),
                         hist.ctypes.data_as(ctypes.c_void_p))
        return hist
    except OSError:
        pass
    lits = np.flatnonzero(seg != rchar)
    # nxt[i] = index of the first literal at/after boundary i — all the
    # per-entry bookkeeping is O(n_entries log n_lits); the flat side
    # stays at three linear passes (diff, two bincounts)
    nxt = np.searchsorted(lits, bnd, "left")
    has_lit = nxt[:-1] < nxt[1:]
    if len(lits):
        prev = np.concatenate([[np.int64(-1)], lits[:-1]])
        runlens = lits - prev - 1                    # gap to previous literal
        first = nxt[:-1][has_lit]                    # first literal per entry
        runlens[first] = lits[first] - bnd[:-1][has_lit]
        hist += np.bincount(np.minimum(runlens, 255), minlength=256)
    # trailing run per entry (bytes after its last literal; whole entry
    # when it has none) — zero-length entries contribute nothing
    last_end = np.where(has_lit,
                        lits[np.maximum(nxt[1:] - 1, 0)] + 1
                        if len(lits) else np.int64(0),
                        bnd[:-1])
    trail = bnd[1:] - last_end
    trail = trail[trail > 0]
    if len(trail):
        hist += np.bincount(np.minimum(trail, 255), minlength=256)
    return hist


def scan_streams(streams: np.ndarray, lengths: np.ndarray) -> QVStats:
    """QVcoding_Scan / QVcoding_Scan1 (QV.c:860-1023), vectorized with the
    reference's exact order-dependent semantics.  ``streams`` is (5, total)
    u8 with entry boundaries given by ``lengths``."""
    n_entries = len(lengths)
    off = np.zeros(n_entries + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    total = int(off[-1])

    first_n = None
    try:                             # one native pass for the four flat
        from ..native import qv_encode_shim   # histograms + first-'n' scan
        import ctypes

        lib = qv_encode_shim()
        hist4 = np.zeros((4, 256), np.int64)
        fn = np.zeros(1, np.int64)
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        rows = [np.ascontiguousarray(streams[c])
                for c in (DEL, INS, MRG, SUB, TAG)]
        lib.dxt_qv_scan_hists(*(ptr(r) for r in rows), total,
                              ptr(hist4), ptr(fn))
        del_hist, ins_hist, mrg_hist, sub_hist = hist4
        first_n = int(fn[0])
    except OSError:
        del_hist = np.bincount(streams[DEL], minlength=256).astype(np.int64)
        ins_hist = np.bincount(streams[INS], minlength=256).astype(np.int64)
        mrg_hist = np.bincount(streams[MRG], minlength=256).astype(np.int64)
        sub_hist = np.bincount(streams[SUB], minlength=256).astype(np.int64)

    # delChar: the delQV under the first 'n'/'N' delTag in file order
    # (QV.c:993-1002); run histogram covers that entry onward.
    if first_n is None:
        tagn = np.flatnonzero(
            (streams[TAG] == ord("n")) | (streams[TAG] == ord("N")))
        first_n = int(tagn[0]) if len(tagn) else -1
    del_run = np.ones(256, np.int64)                    # init to 1 (QV.c:934-935)
    if first_n >= 0:
        k = first_n
        del_char = int(streams[DEL][k])
        r0 = int(np.searchsorted(off, k, "right") - 1)
        del_run += _run_hist_entries(streams[DEL], off, r0, del_char)
    else:
        del_char = -1

    # subChar: chosen at the first entry where cumulative chars >= 100000,
    # as the mode of the substitution histogram *so far* (QV.c:1006-1017);
    # run histogram covers that entry onward.
    sub_run = np.ones(256, np.int64)
    sub_char = -1
    if total >= 100000:
        r1 = int(np.searchsorted(off[1:], 100000, "left"))
        part = np.bincount(streams[SUB][: off[r1 + 1]], minlength=256)
        sub_char = int(np.argmax(part))                  # first max, like the C scan
        sub_run += _run_hist_entries(streams[SUB], off, r1, sub_char)

    return QVStats(del_hist, ins_hist, mrg_hist, sub_hist, del_run, sub_run,
                   del_char, sub_char, total)


def scan_quiva(q: qv.QuivaFile) -> QVStats:
    return scan_streams(q.streams, q.lengths)


def create_qvcoding(stats: QVStats, prefix: bytes, lossy: bool = False) -> dq.QVCoding:
    """Create_QVcoding (QV.c:1029-1153) from (possibly psum-reduced) stats."""
    del_hist = stats.del_hist.copy()
    ins_hist = stats.ins_hist.copy()
    mrg_hist = stats.mrg_hist.copy()
    sub_hist = stats.sub_hist.copy()
    del_char, sub_char = stats.del_char, stats.sub_char

    # keep subChar only if it is at least half of all chars (QV.c:1044-1045)
    if stats.tot_char < 200000 or sub_hist[sub_char] < 0.5 * stats.tot_char:
        sub_char = -1

    if lossy:                                            # QV.c:1049-1065
        ins_hist = ins_hist.reshape(128, 2).sum(1, dtype=np.int64)
        ins_hist = np.stack([ins_hist, np.zeros(128, np.int64)], 1).reshape(256)
        mrg_hist = mrg_hist.reshape(64, 4).sum(1, dtype=np.int64)
        mrg_hist = np.concatenate(
            [mrg_hist[:, None], np.zeros((64, 3), np.int64)], 1).reshape(256)

    if del_char >= 0:
        del_hist[del_char] = 0
        del_scheme = make_scheme(del_hist)
        drun_scheme = make_scheme(stats.del_run)
    else:
        del_scheme = make_scheme(del_hist)
        drun_scheme = None

    ins_scheme = make_scheme(ins_hist)
    mrg_scheme = make_scheme(mrg_hist)

    if sub_char >= 0:
        sub_hist[sub_char] = 0
        sub_scheme = make_scheme(sub_hist)
        srun_scheme = make_scheme(stats.sub_run)
    else:
        sub_scheme = make_scheme(sub_hist)
        srun_scheme = None

    return dq.QVCoding(del_scheme, ins_scheme, mrg_scheme, sub_scheme,
                       drun_scheme, srun_scheme, del_char, sub_char, prefix)


# ---------------------------------------------------------------------------
# entry encode / decode
# ---------------------------------------------------------------------------

def encode_entry(coding: dq.QVCoding, delqv, tag, ins, mrg, sub, lossy: bool) -> bytes:
    """Compress_Next_QVentry (QV.c:1381-1426) for one entry -> payload bytes."""
    parts = []
    if coding.del_char < 0:
        parts.append(bs.encode_stream(coding.del_scheme, delqv).tobytes())
        kept = tag
    else:
        parts.append(bs.encode_run_stream(coding.del_scheme, coding.drun_scheme,
                                          delqv, coding.del_char).tobytes())
        kept = tag[delqv != coding.del_char]              # Pack_Tag (QV.c:810-819)
    codes = tb.NUMBER_BASE_LUT[kept]
    clen = len(codes)
    tlen = (clen + 3) >> 2
    if tlen:
        padded = np.zeros(4 * tlen, np.uint8)
        padded[:clen] = codes
        parts.append(tb.pack_2bit_np(padded[None, :])[0].tobytes())
    if lossy:                                             # QV.c:1406-1415
        ins = ins & 0xFE
        mrg = mrg & 0xFC
    parts.append(bs.encode_stream(coding.ins_scheme, ins).tobytes())
    parts.append(bs.encode_stream(coding.mrg_scheme, mrg).tobytes())
    if coding.sub_char < 0:
        parts.append(bs.encode_stream(coding.sub_scheme, sub).tobytes())
    else:
        parts.append(bs.encode_run_stream(coding.sub_scheme, coding.srun_scheme,
                                          sub, coding.sub_char).tobytes())
    return b"".join(parts)


def encode_quiva_to_dexqv(data: bytes, lossy: bool = False,
                          device: bool | None = None) -> bytes:
    """Encode a .quiva image.

    device=True  -> batched device pipeline;
    device=False -> native C channel encoder (falls back to the per-entry
                    NumPy path);
    device=None  -> the written policy (utils/dispatch.device_default):
                    DXT_DEVICE env override, else device iff an
                    accelerator backend is active.
    """
    from ..utils.profiling import REPORTER

    with REPORTER.stage("parse", len(data)):
        q = qv.parse_quiva(data)
    payload = int(q.lengths.sum()) * 5
    with REPORTER.stage("scan+tables", payload):
        stats = scan_quiva(q)
        coding = create_qvcoding(stats, q.prefix, lossy)
    if device is None:
        from ..utils.dispatch import device_default
        device = device_default()
    with REPORTER.stage("encode+assemble", payload):
        if device:
            return _encode_entries_device(q, coding, lossy)
        out = _encode_entries_native(q, coding, lossy)
        if out is not None:
            return out
        off = np.zeros(q.n_entries + 1, np.int64)
        np.cumsum(q.lengths, out=off[1:])
        blobs = []
        for i in range(q.n_entries):
            s, e = off[i], off[i + 1]
            blobs.append(encode_entry(
                coding,
                q.streams[DEL, s:e], q.streams[TAG, s:e],
                q.streams[INS, s:e], q.streams[MRG, s:e],
                q.streams[SUB, s:e], lossy))
        return dq.write_dexqv(coding, q.wells, q.begs, q.ends, q.qvs,
                              blobs)


def _encode_entries_native(q: qv.QuivaFile, coding: dq.QVCoding, lossy: bool):
    """All five channels through the C channel encoder (host CPU path)."""
    from ..native import qv_encode_shim

    try:
        lib = qv_encode_shim()
    except OSError:
        return None
    import ctypes

    n = q.n_entries
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(q.lengths, out=offs[1:])
    total = int(offs[-1])
    cap = 8 * total + 64 * n + 1024

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    def channel(data, scheme, run_scheme=None, rchar=-1):
        data = np.ascontiguousarray(data)
        out = np.empty(cap, np.uint8)
        out_lens = np.zeros(n, np.int64)
        bits = np.ascontiguousarray(scheme.codebits.astype(np.uint32))
        lens = np.ascontiguousarray(scheme.codelens.astype(np.int32))
        if run_scheme is None:
            r = lib.dxt_encode_plain(ptr(data), ptr(offs), n, ptr(bits),
                                     ptr(lens), int(scheme.type), ptr(out),
                                     cap, ptr(out_lens))
        else:
            rbits = np.ascontiguousarray(run_scheme.codebits.astype(np.uint32))
            rlens = np.ascontiguousarray(run_scheme.codelens.astype(np.int32))
            r = lib.dxt_encode_run(ptr(data), ptr(offs), n, ptr(bits),
                                   ptr(lens), int(scheme.type), ptr(rbits),
                                   ptr(rlens), int(rchar), ptr(out), cap,
                                   ptr(out_lens))
        if r < 0:
            raise FormatError("native encode buffer overflow")
        return out[: int(r)], out_lens

    ins_data = q.streams[INS]
    mrg_data = q.streams[MRG]
    if lossy:
        ins_data = ins_data & 0xFE
        mrg_data = mrg_data & 0xFC

    # the C calls release the GIL (plain ctypes), so the five independent
    # channel encodes run on five cores — the reference tool is single-
    # threaded by design, this is free parallelism on any host
    from concurrent.futures import ThreadPoolExecutor

    tag_out = np.empty(total // 4 + 4 * n + 16, np.uint8)
    tag_lens = np.zeros(n, np.int64)

    def tag_job():
        r = lib.dxt_pack_tags(ptr(np.ascontiguousarray(q.streams[TAG])),
                              ptr(np.ascontiguousarray(q.streams[DEL])),
                              ptr(offs), n, coding.del_char,
                              ptr(tb.NUMBER_BASE_LUT), ptr(tag_out),
                              len(tag_out), ptr(tag_lens))
        if r < 0:
            raise FormatError("native tag pack buffer overflow")
        return r

    with ThreadPoolExecutor(max_workers=5) as ex:
        f_del = ex.submit(channel, q.streams[DEL], coding.del_scheme,
                          coding.drun_scheme, coding.del_char)
        f_ins = ex.submit(channel, ins_data, coding.ins_scheme)
        f_mrg = ex.submit(channel, mrg_data, coding.mrg_scheme)
        f_sub = ex.submit(channel, q.streams[SUB], coding.sub_scheme,
                          coding.srun_scheme, coding.sub_char)
        f_tag = ex.submit(tag_job)
        del_flat, del_w = f_del.result()
        ins_flat, ins_w = f_ins.result()
        mrg_flat, mrg_w = f_mrg.result()
        sub_flat, sub_w = f_sub.result()
        r = f_tag.result()

    parts = [
        (del_flat, del_w), (tag_out[: int(r)], tag_lens),
        (ins_flat, ins_w), (mrg_flat, mrg_w), (sub_flat, sub_w),
    ]
    return dq.assemble_dexqv(coding, q.wells, q.begs, q.ends, q.qvs, parts)


def assemble_from_step(step_out, coding: dq.QVCoding, wells, begs, ends,
                       qvs, n: int) -> bytes:
    """Build the .dexqv container from qv_encode_step outputs.

    ``step_out`` = (words (4,N,M+1), raw, out, dup, zext, packed_tags,
    tag_clens) — single-device or gathered from a sharded run; rows
    beyond ``n`` are shape padding.
    """
    from ..ops import bitstream_jax as bj
    from ..formats.ragged import rows_to_flat

    words, raw, out, dup, zext, packed, clens = (np.asarray(x)
                                                 for x in step_out)
    flats = []
    lens = []
    for c in range(4):
        f, w = bj.finalize_rows(words[c], raw[c], out[c], dup[c], zext[c])
        flats.append(f.view(np.uint8))
        lens.append(4 * w[:n])
    tag_lens = ((clens.astype(np.int64) + 3) >> 2)
    tag_flat = rows_to_flat(packed, tag_lens)
    parts = [
        (flats[0], lens[0]), (tag_flat, tag_lens[:n]),
        (flats[1], lens[1]), (flats[2], lens[2]), (flats[3], lens[3]),
    ]
    return dq.assemble_dexqv(coding, wells, begs, ends, qvs, parts)


# ---------------------------------------------------------------------------
# batched device encode path
# ---------------------------------------------------------------------------

def _encode_entries_device(q: qv.QuivaFile, coding: dq.QVCoding, lossy: bool) -> bytes:
    """Encode all entries' streams as batched device programs, one per
    power-of-two row-length bucket.

    One rectangle padded to the longest read would make every row pay
    the widest read's planes (a 512 x 65536 run batch); bucketing keeps
    each program at its bucket's width, and per-channel outputs scatter
    back to entry order through the native ragged copy.  Power-of-two
    buckets bound the compiled programs to one set per doubling of the
    longest read; finer buckets pad less, but each needs its own program
    set, and a long-read file then takes minutes to compile."""
    from ..formats.ragged import (pad_rows, bucket_rows, next_pow2,
                                  rows_to_flat)
    from ..ops import bitstream_jax as bj

    n = q.n_entries
    real_lengths = q.lengths.astype(np.int64)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(real_lengths, out=off[1:])
    kb = np.array([next_pow2(max(int(L), 512)) for L in real_lengths],
                  np.int64) if n else np.zeros(0, np.int64)

    chunks = {c: [] for c in ("del", "tag", "ins", "mrg", "sub")}
    for width in np.unique(kb):
        sel = np.flatnonzero(kb == width)
        lens_b = real_lengths[sel]
        n_b = len(sel)
        n_pad = bucket_rows(n_b)
        lengths = np.zeros(n_pad, np.int64)
        lengths[:n_b] = lens_b

        def rect(s):
            idx = np.concatenate(
                [np.arange(off[i], off[i + 1]) for i in sel])                 if n_b else np.zeros(0, np.int64)
            flat = q.streams[s][idx]
            r = pad_rows(flat, lens_b, align=512, bucket=True)
            if r.shape[1] < width:
                r = np.concatenate(
                    [r, np.zeros((n_b, width - r.shape[1]), np.uint8)], 1)
            if n_pad != n_b:
                r = np.concatenate(
                    [r, np.zeros((n_pad - n_b, r.shape[1]), np.uint8)])
            return r

        del_rows = rect(DEL)
        ins_rows = rect(INS)
        mrg_rows = rect(MRG)
        sub_rows = rect(SUB)
        tag_rows = rect(TAG)
        if lossy:
            ins_rows = ins_rows & 0xFE
            mrg_rows = mrg_rows & 0xFC

        del_flat, del_w = bj.encode_rows_np(
            del_rows, lengths, coding.del_scheme, coding.drun_scheme,
            coding.del_char)
        ins_flat, ins_w = bj.encode_rows_np(ins_rows, lengths,
                                            coding.ins_scheme)
        mrg_flat, mrg_w = bj.encode_rows_np(mrg_rows, lengths,
                                            coding.mrg_scheme)
        sub_flat, sub_w = bj.encode_rows_np(
            sub_rows, lengths, coding.sub_scheme, coding.srun_scheme,
            coding.sub_char)
        packed, clens = _pack_tags_device(tag_rows, del_rows, lengths,
                                          coding.del_char)
        tag_lens = (clens + 3) >> 2
        tag_flat = rows_to_flat(packed, tag_lens)

        chunks["del"].append((sel, del_flat.view(np.uint8), 4 * del_w[:n_b]))
        chunks["tag"].append((sel, tag_flat, tag_lens[:n_b]))
        chunks["ins"].append((sel, ins_flat.view(np.uint8), 4 * ins_w[:n_b]))
        chunks["mrg"].append((sel, mrg_flat.view(np.uint8), 4 * mrg_w[:n_b]))
        chunks["sub"].append((sel, sub_flat.view(np.uint8), 4 * sub_w[:n_b]))

    def entry_order(chs):
        """Bucket-order channel chunks -> (flat, per-entry lens) in
        entry order (one native ragged memcpy per bucket)."""
        lens_full = np.zeros(n, np.int64)
        for sel, flat, lens in chs:
            # device-computed lengths feed unchecked native memcpys;
            # turn an inconsistent batch (e.g. a miscompiled program)
            # into an error instead of heap corruption
            if (np.asarray(lens) < 0).any() or int(lens.sum()) != len(flat):
                raise FormatError(
                    "device encode produced inconsistent stream lengths")
            lens_full[sel] = lens
        offs_full = np.zeros(n, np.int64)
        np.cumsum(lens_full[:-1], out=offs_full[1:])
        out = np.empty(int(lens_full.sum()), np.uint8)
        try:
            from ..native import qv_encode_shim
            import ctypes

            lib = qv_encode_shim()
            ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
            for sel, flat, lens in chs:
                lib.dxt_ragged_copy(
                    ptr(out), ptr(np.ascontiguousarray(offs_full[sel])),
                    ptr(np.ascontiguousarray(flat)),
                    ptr(np.ascontiguousarray(lens.astype(np.int64))),
                    len(sel))
        except OSError:
            for sel, flat, lens in chs:
                src = 0
                for i, e in enumerate(sel):
                    L = int(lens[i])
                    out[offs_full[e]:offs_full[e] + L] = flat[src:src + L]
                    src += L
        return out, lens_full

    parts = [entry_order(chunks[c])
             for c in ("del", "tag", "ins", "mrg", "sub")]
    return dq.assemble_dexqv(coding, q.wells, q.begs, q.ends, q.qvs, parts)


def _pack_tags_device(tag_rows, del_rows, lengths, del_char):
    """Pack_Tag + Number_Read + Compress_Read batched on device.

    Kept tag symbols (where delQV != delChar) are compacted to row starts
    with a cumsum/scatter, then 2-bit packed.
    """
    import jax.numpy as jnp

    out, clens = _pack_tags_jit(jnp.asarray(tag_rows), jnp.asarray(del_rows),
                                jnp.asarray(lengths.astype(np.int32)),
                                jnp.int32(del_char),
                                jnp.asarray(tb.NUMBER_BASE_LUT))
    return np.asarray(out), np.asarray(clens).astype(np.int64)


def _pack_tags_impl(tag_rows, del_rows, lengths, del_char, number_lut):
    from ..parallel.pipeline import _pack_tags
    return _pack_tags(tag_rows, del_rows, lengths, del_char, number_lut)


import jax as _jax  # noqa: E402
_pack_tags_jit = _jax.jit(_pack_tags_impl)


def decode_entry(coding: dq.QVCoding, buf: np.ndarray, byte_off: int, rlen: int):
    """Uncompress_Next_QVentry (QV.c:1428-1481): decode 5 streams.

    Returns (streams (5, rlen) u8, bytes_consumed).
    """
    out = np.empty((5, rlen), np.uint8)
    pos = byte_off
    flip = coding.flip

    rd = bs.BitReader(buf, pos, flip)
    if coding.del_char < 0:
        out[DEL], words = bs.decode_stream(coding.del_scheme, rd, rlen)
        clen = rlen
    else:
        out[DEL], words = bs.decode_run_stream(coding.del_scheme, coding.drun_scheme,
                                               rd, rlen, coding.del_char)
        clen = int((out[DEL] != coding.del_char).sum())   # Packed_Length
    pos += 4 * words

    tlen = (clen + 3) >> 2
    if pos + tlen > len(buf):
        raise FormatError("could not read deletions entry")
    packed = buf[pos: pos + tlen]
    pos += tlen
    kept = tb.LOWER_LUT[tb.unpack_2bit_np(packed[None, :])[0, :clen]]
    if coding.del_char < 0:
        out[TAG] = kept
    else:                                                 # Unpack_Tag (QV.c:837-847)
        mask = out[DEL] != coding.del_char
        tag = np.full(rlen, ord("n"), np.uint8)
        tag[mask] = kept
        out[TAG] = tag

    rd = bs.BitReader(buf, pos, flip)
    out[INS], words = bs.decode_stream(coding.ins_scheme, rd, rlen)
    pos += 4 * words
    rd = bs.BitReader(buf, pos, flip)
    out[MRG], words = bs.decode_stream(coding.mrg_scheme, rd, rlen)
    pos += 4 * words
    rd = bs.BitReader(buf, pos, flip)
    if coding.sub_char < 0:
        out[SUB], words = bs.decode_stream(coding.sub_scheme, rd, rlen)
    else:
        out[SUB], words = bs.decode_run_stream(coding.sub_scheme, coding.srun_scheme,
                                               rd, rlen, coding.sub_char)
    pos += 4 * words
    return out, pos - byte_off


def _index_native(data: bytes, coding: dq.QVCoding, off: int, newv: bool,
                  rlens=None):
    """Lens-only native walk: resolve the bit-serial entry chain and return
    (lib, schemes-ctx, wells, begs, ends, qvs, eoffs, elens) or None.

    The chain resolution is the only inherently sequential part of raw
    container decode (QV.c:1381-1426: every stream's byte length is known
    only after decoding it); entry payloads themselves are then N
    independent chains for the batch decoder.

    ``rlens``: headerless mode for Dazzler DB .qvs payloads
    (DB.c:2575-2621 — butted five-stream blobs with read lengths in the
    .idx): the walk takes the given lengths instead of parsing entry
    headers."""
    from ..native import qv_decode_shim

    try:
        lib = qv_decode_shim()
    except OSError:
        return None
    import ctypes

    schemes = []

    def sidx(s):
        if s is None:
            return -1
        s.with_lookup()
        schemes.append(s)
        return len(schemes) - 1

    sid = np.array([
        sidx(coding.del_scheme), sidx(coding.drun_scheme),
        sidx(coding.ins_scheme), sidx(coding.mrg_scheme),
        sidx(coding.sub_scheme), sidx(coding.srun_scheme)], np.int32)
    lookups = np.ascontiguousarray(
        np.stack([s.lookup for s in schemes]).astype(np.int32))
    lens = np.ascontiguousarray(
        np.stack([np.minimum(s.codelens, 255) for s in schemes]).astype(np.uint8))
    types = np.array([s.type for s in schemes], np.uint8)

    buf = np.frombuffer(data, np.uint8)
    size = len(buf)
    rlens_a = None if rlens is None else \
        np.ascontiguousarray(np.asarray(rlens, np.int64))
    cap_entries = len(rlens_a) if rlens_a is not None else \
        max(size // (13 if newv else 7) + 2, 16)
    cap_entries = max(cap_entries, 1)
    wells = np.zeros(cap_entries, np.int32)
    begs = np.zeros(cap_entries, np.int32)
    ends_ = np.zeros(cap_entries, np.int32)
    qvs = np.zeros(cap_entries, np.int32)
    eoffs = np.zeros(cap_entries, np.int64)
    elens = np.zeros(cap_entries, np.int64)
    coffs = np.zeros(5 * cap_entries, np.int32)
    ntoks = np.zeros(2 * cap_entries, np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    # lens-only walk: exact entry count + boundaries (incl. per-channel
    # stream offsets and RLE token counts), no materialization
    ne = lib.dxt_qv_walk(
        ptr(buf), size, off, ptr(lookups), ptr(lens), ptr(types),
        ptr(sid), coding.del_char, coding.sub_char, int(newv),
        cap_entries, 1 << 62,
        ptr(wells), ptr(begs), ptr(ends_), ptr(qvs), ptr(eoffs),
        ptr(elens), None, 0, ptr(coffs), ptr(ntoks),
        0, 0, None, None, None, None,
        ptr(rlens_a) if rlens_a is not None else None,
        len(rlens_a) if rlens_a is not None else 0)
    if ne < 0:
        raise FormatError(f"corrupt .dexqv stream (native walker: {ne})")
    ne = int(ne)
    ctx = (lookups, lens, types, sid)
    return (lib, ctx, wells[:ne], begs[:ne], ends_[:ne], qvs[:ne],
            eoffs[:ne], elens[:ne], coffs[: 5 * ne].reshape(ne, 5),
            ntoks[: 2 * ne].reshape(ne, 2))


SEG_DECODE = 2048


def _index_checkpoints(data: bytes, coding: dq.QVCoding, off: int,
                       newv: bool, idx, seg: int = SEG_DECODE,
                       rlens=None):
    """Second lens-only walk recording per-channel segment checkpoints
    (bit offsets / run-literal indices / run carries at every ``seg``
    symbols) so long reads decode as MANY short full-speed device chains
    instead of one slow long one.  Returns (seg, ck_offs (ne+1,) i64,
    ckb (4, B) i32, ckt (2, B) i32, ckc (2, B) i32), or None when no
    read crosses ``seg`` (the common short-read case: zero extra cost).
    """
    import ctypes

    lib, ctx = idx[0], idx[1]
    elens = idx[7]
    lookups, lens, types, sid = ctx
    ne = len(elens)
    rlens_a = None if rlens is None else \
        np.ascontiguousarray(np.asarray(rlens, np.int64))
    nb = np.maximum((elens.astype(np.int64) + seg - 1) // seg - 1, 0)
    btot = int(nb.sum())
    if btot == 0:
        return None
    ck_offs = np.zeros(ne + 1, np.int64)
    np.cumsum(nb, out=ck_offs[1:])
    ckb = np.zeros(4 * btot, np.int32)
    ckt = np.zeros(2 * btot, np.int32)
    ckc = np.full(2 * btot, -1, np.int32)
    buf = np.frombuffer(data, np.uint8)
    w2 = np.zeros(ne, np.int32)
    b2 = np.zeros(ne, np.int32)
    e2 = np.zeros(ne, np.int32)
    q2 = np.zeros(ne, np.int32)
    eo2 = np.zeros(ne, np.int64)
    el2 = np.zeros(ne, np.int64)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    ne2 = lib.dxt_qv_walk(
        ptr(buf), len(buf), off, ptr(lookups), ptr(lens), ptr(types),
        ptr(sid), coding.del_char, coding.sub_char, int(newv),
        ne, 1 << 62,
        ptr(w2), ptr(b2), ptr(e2), ptr(q2), ptr(eo2), ptr(el2),
        None, 0, None, None,
        seg, btot, ptr(ck_offs), ptr(ckb), ptr(ckt), ptr(ckc),
        ptr(rlens_a) if rlens_a is not None else None,
        len(rlens_a) if rlens_a is not None else 0)
    if int(ne2) != ne:
        raise FormatError("checkpoint walk entry-count mismatch")
    return (seg, ck_offs, ckb.reshape(4, btot), ckt.reshape(2, btot),
            ckc.reshape(2, btot))


def _walk_native(data: bytes, coding: dq.QVCoding, off: int, newv: bool):
    """Decode all entries with the native sequential walker (the entry
    chain is bit-serial; see native/qv_decode.c).  Returns the same tuple
    shape as the Python walker or None when unavailable.

    Single materialize pass: the output capacity is estimated from the
    ~3.4x compression factor and grown on overflow (walker rc -3), which
    halves the chain work vs an exact-sizing pre-pass; the grow-only
    shared buffer keeps steady-state allocations (and their first-touch
    page faults) at zero."""
    from ..native import qv_decode_shim

    try:
        lib = qv_decode_shim()
    except OSError:
        return None
    import ctypes

    schemes = []

    def sidx(s):
        if s is None:
            return -1
        s.with_lookup()
        schemes.append(s)
        return len(schemes) - 1

    sid = np.array([
        sidx(coding.del_scheme), sidx(coding.drun_scheme),
        sidx(coding.ins_scheme), sidx(coding.mrg_scheme),
        sidx(coding.sub_scheme), sidx(coding.srun_scheme)], np.int32)
    lookups = np.ascontiguousarray(
        np.stack([s.lookup for s in schemes]).astype(np.int32))
    lens = np.ascontiguousarray(
        np.stack([np.minimum(s.codelens, 255) for s in schemes]).astype(np.uint8))
    types = np.array([s.type for s in schemes], np.uint8)

    buf = np.frombuffer(data, np.uint8)
    size = len(buf)
    cap_entries = max(size // (13 if newv else 7) + 2, 16)
    wells = np.zeros(cap_entries, np.int32)
    begs = np.zeros(cap_entries, np.int32)
    ends_ = np.zeros(cap_entries, np.int32)
    qvs = np.zeros(cap_entries, np.int32)
    eoffs = np.zeros(cap_entries, np.int64)
    elens = np.zeros(cap_entries, np.int64)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    global _WALK_BUF
    cap_total = max(size, 1 << 20)
    if _WALK_BUF is not None:
        cap_total = max(cap_total, _WALK_BUF.size // 5)
    # information-theoretic output bound: an RLE escape token (>= 32
    # bits) expands to at most 65535 symbols, so a stream byte can never
    # decode to more than ~16K symbols — header fields claiming more are
    # corrupt, not large (keeps flipped int32 rlens from driving the
    # grow-on-overflow loop into hundred-GiB allocations)
    cap_limit = max(16384 * size, 1 << 20)
    while True:
        if _WALK_BUF is None or _WALK_BUF.size < 5 * cap_total:
            _WALK_BUF = np.empty(5 * cap_total, np.uint8)
        out = _WALK_BUF
        ne = lib.dxt_qv_walk(
            ptr(buf), size, off, ptr(lookups), ptr(lens), ptr(types),
            ptr(sid), coding.del_char, coding.sub_char, int(newv),
            cap_entries, cap_total,
            ptr(wells), ptr(begs), ptr(ends_), ptr(qvs), ptr(eoffs),
            ptr(elens), ptr(out), 1, None, None,
            0, 0, None, None, None, None, None, 0)
        if ne == -3:
            if cap_total >= cap_limit:
                raise FormatError(
                    "corrupt .dexqv stream: entry lengths exceed what the "
                    "stream could encode")
            cap_total = min(cap_total * 2, cap_limit)
            continue
        if ne < 0:
            raise FormatError(f"corrupt .dexqv stream (native walker: {ne})")
        break
    ne = int(ne)
    total = int(elens[:ne].sum())
    # NB: stream s lives at out[s*cap_total : s*cap_total+total] — a view
    # into the shared grow-only buffer, valid until the next native walk;
    # decode_dexqv_to_quiva consumes it immediately
    streams = np.lib.stride_tricks.as_strided(
        out, shape=(5, total), strides=(cap_total, 1)) if total else \
        np.empty((5, 0), np.uint8)
    return (wells[:ne], begs[:ne], ends_[:ne], qvs[:ne], elens[:ne],
            streams)


_WALK_BUF = None


def _decode_entries_device(data: bytes, coding: dq.QVCoding, off: int,
                           newv: bool, mesh=None):
    """Raw-container batch decode: the native lens-only walk resolves the
    sequential entry chain (offsets only), then every entry's five streams
    decode as independent parallel chains on the device
    (matches undexqv.c:101-208 output)."""
    from .qv_batch import fused_decode_entries
    from ..formats.ragged import rows_to_flat

    import os as _os

    res = _index_native(data, coding, off, newv)
    if res is None:
        raise RuntimeError("device .dexqv decode needs the native index "
                           "walker, which could not be built")
    _, _, wells, begs, ends_, qvs, eoffs, elens, coffs, ntoks = res
    buf = np.frombuffer(data, np.uint8)
    rlens = elens.astype(np.int64)
    # long reads: a second lens walk records segment checkpoints so each
    # read decodes as SHORT chains (a batch of long reads then has many
    # chains, each short); None when no read crosses the segment size
    # (the common short-read case).  DXT_SEG_DECODE=0 forces per-read
    # chains.
    ck = None
    if _os.environ.get("DXT_SEG_DECODE", "1") == "1":
        ck = _index_checkpoints(data, coding, off, newv, res)
    if ck is not None:
        from .qv_batch import fused_decode_entries_seg
        rows = fused_decode_entries_seg(buf, eoffs,
                                        elens.astype(np.int32), coffs,
                                        ntoks, coding, ck, mesh=mesh)
    else:
        rows = fused_decode_entries(buf, eoffs, elens.astype(np.int32),
                                    coffs, ntoks, coding, mesh=mesh)
    streams = np.stack([rows_to_flat(np.asarray(rows[s]), rlens)
                        for s in range(5)])
    return wells, begs, ends_, qvs, rlens, streams


def decode_dexqv_to_quiva(data: bytes, upper: bool = False,
                          native: bool = True,
                          device: bool | None = None, mesh=None) -> bytes:
    """Decode a .dexqv image to .quiva text (undexqv.c:101-208).

    device=True -> entry boundaries via the native lens-only walk, stream
    content via the batched device decoder (optionally shard_map'd over
    ``mesh``); it raises rather than decode on the host when it cannot
    run (a byte-flipped container, no native walker).  device=False ->
    fully native sequential walk, or the Python walker for flipped
    containers and when the native shim is missing.  device=None -> the
    written policy (utils/dispatch.device_default), same as the encoder,
    with flipped containers on the host.
    """
    import struct as _struct

    from ..utils.profiling import REPORTER

    if len(data) < 2:
        raise FormatError("not a .dexqv file (empty or truncated)")
    with REPORTER.stage("tables", len(data)):
        mv = memoryview(data)
        (key,) = _struct.unpack_from("<H", mv, 0)
        off = 2 if key in (dq.CONTAINER_KEY, 0xAA55) else 0  # legacy: no key
        coding, off = dq.parse_qvcoding(mv, off)
        newv = key in (dq.CONTAINER_KEY, 0xAA55)

    if device is None:
        from ..utils.dispatch import device_default
        device = device_default() and not coding.flip
    if device:
        if coding.flip:
            raise FormatError("device decode reads native-endian .dexqv "
                              "containers only; decode this one with "
                              "device=False")
        with REPORTER.stage("decode", len(data)):
            res = _decode_entries_device(data, coding, off, newv, mesh=mesh)
        wells, begs, ends_, qvs, lengths, streams = res
        if upper:
            streams = streams.copy()
            streams[TAG] = streams[TAG] - 32
        with REPORTER.stage("assemble",
                            int(np.asarray(lengths).sum()) * 5):
            return qv.write_quiva(coding.prefix, wells, begs, ends_,
                                  qvs, lengths, streams)

    if native and not coding.flip:
        with REPORTER.stage("decode", len(data)):
            res = _walk_native(data, coding, off, newv)
        if res is not None:
            wells, begs, ends_, qvs, lengths, streams = res
            if upper:
                streams = streams.copy()
                streams[TAG] = streams[TAG] - 32
            with REPORTER.stage("assemble",
                                int(np.asarray(lengths).sum()) * 5):
                return qv.write_quiva(coding.prefix, wells, begs, ends_,
                                      qvs, lengths, streams)

    end = ">" if coding.flip else "<"

    buf = np.frombuffer(data, np.uint8)
    size = len(buf)
    wells, begs, ends_, qvs = [], [], [], []
    streams_parts = []
    lengths = []
    well = 0
    fmt = _struct.Struct(end + ("iii" if newv else "3H"))
    while off < size:
        b = buf[off]
        off += 1
        while b == 255:
            well += 255
            if off >= size:
                raise FormatError("truncated .dexqv (well escape)")
            b = buf[off]
            off += 1
        well += int(b)
        if off + fmt.size > size:
            raise FormatError("truncated .dexqv (fields)")
        beg, endp, q_ = fmt.unpack_from(mv, off)
        off += fmt.size
        rlen = endp - beg
        entry, consumed = decode_entry(coding, buf, off, rlen)
        off += consumed
        wells.append(well)
        begs.append(beg)
        ends_.append(endp)
        qvs.append(q_)
        lengths.append(rlen)
        streams_parts.append(entry)

    n = len(wells)
    lengths = np.array(lengths, np.int64)
    streams = (np.concatenate(streams_parts, axis=1)
               if streams_parts else np.empty((5, 0), np.uint8))
    if upper:                                             # undexqv.c:198-204
        total = streams.shape[1]
        streams = streams.copy()
        streams[TAG] = streams[TAG] - 32
    return qv.write_quiva(coding.prefix, np.array(wells), np.array(begs),
                          np.array(ends_), np.array(qvs), lengths, streams)
