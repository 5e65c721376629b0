""".fasta <-> .dexta and .arrow <-> .dexar codecs.

Device data plane: ascii->code translation, padding mask, and the 2-bit
pack run as one fused jitted program over an (N, Lpad) rectangle; decode is
the mirror image.  The host control plane does text parsing and byte-exact
container framing (reference encoders dexta.c:102-205 / dexar.c:101-211).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..formats import fasta as fa
from ..formats import dexta as dx
from ..formats.ragged import pad_rows, rows_to_flat
from ..ops import twobit as tb


# ---------------------------------------------------------------------------
# fused device kernels
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("alphabet",))
def _encode_rows(ascii_rows, lengths, number_lut, alphabet: str | None = None):
    if alphabet in ("base", "arrow"):
        # arithmetic letter map + multiply pack (ops/twobit.pack_translate):
        # no gather, no compaction network — the encode mirror of
        # unpack_translate
        return tb.pack_translate(ascii_rows, lengths, alphabet=alphabet)
    codes = number_lut[ascii_rows]
    return tb.pack_2bit(codes, lengths)


@jax.jit
def _decode_rows(packed_rows, letter_lut):
    return tb.unpack_translate(packed_rows, letter_lut)


def _bucket_rows(rows: np.ndarray, lengths: np.ndarray):
    """Pad the row count to an eighth-octave bucket (shape-bucketing for
    jit reuse at <= 12.5% dead rows; pow2 padded up to 2x)."""
    from ..formats.ragged import bucket_rows

    n = rows.shape[0]
    n_pad = bucket_rows(n)
    if n_pad != n:
        rows = np.concatenate([rows, np.zeros((n_pad - n, rows.shape[1]), rows.dtype)])
        lengths = np.concatenate([lengths, np.zeros(n_pad - n, lengths.dtype)])
    return rows, lengths, n


def _ptr(a):
    import ctypes

    return a.ctypes.data_as(ctypes.c_void_p)


# threshold for the chunk-threaded host pack (tests lower it to pin the
# threaded path's byte-identity on small inputs)
_PACK_THREAD_MIN_BYTES = 8 << 20


def _pack_batch(seqs_flat, lengths, number_lut, device: bool,
                alphabet: str | None = None):
    """Pack ragged ascii symbols into per-read 2-bit payload bytes."""
    if not device:
        try:                          # single native pass over the flat —
            from ..native import twobit_host_shim   # no rectangle assembly

            lib = twobit_host_shim()
            n = len(lengths)
            offs = np.zeros(n + 1, np.int64)
            np.cumsum(lengths, out=offs[1:])
            clens = ((lengths.astype(np.int64) + 3) >> 2)
            couts = np.zeros(n + 1, np.int64)
            np.cumsum(clens, out=couts[1:])
            cap = int(couts[-1])
            out = np.empty(max(cap, 1), np.uint8)
            out_lens = np.zeros(n, np.int64)
            sf = np.ascontiguousarray(seqs_flat)
            nl = np.ascontiguousarray(number_lut)
            # packed lengths are exactly ceil(len/4), so chunk output
            # offsets are known upfront and the pack parallelizes over
            # entry ranges (ctypes releases the GIL; the reference tool
            # is single-threaded by design)
            import ctypes
            import os as _os
            from concurrent.futures import ThreadPoolExecutor

            nt = min(_os.cpu_count() or 1, 4, max(n, 1))
            if nt > 1 and cap >= _PACK_THREAD_MIN_BYTES:
                # split by output *bytes*, not entry count: skewed read
                # lengths would otherwise collapse the pack to one thread
                targets = [(i * cap) // nt for i in range(nt + 1)]
                bounds = np.searchsorted(couts, targets, "left").tolist()
                bounds[0], bounds[-1] = 0, n
                u8p = ctypes.c_void_p

                def _one(t):
                    lo, hi = bounds[t], bounds[t + 1]
                    if lo == hi:
                        return 0
                    return lib.dxt_pack_seq(
                        _ptr(sf), _ptr(offs[lo:]), hi - lo, _ptr(nl),
                        u8p(out.ctypes.data + int(couts[lo])),
                        cap - int(couts[lo]), _ptr(out_lens[lo:]))

                with ThreadPoolExecutor(nt) as ex:
                    rs = list(ex.map(_one, range(nt)))
                r = cap if all(x >= 0 for x in rs) else -1
            else:
                r = lib.dxt_pack_seq(_ptr(sf), _ptr(offs), n, _ptr(nl),
                                     _ptr(out), cap, _ptr(out_lens))
            if r >= 0:
                return out[:int(r)], clens
        except OSError:
            pass
    rows = pad_rows(seqs_flat, lengths, align=512, bucket=device)
    if device:
        rows_p, lengths_p, n = _bucket_rows(rows, lengths)
        packed = np.asarray(_encode_rows(jnp.asarray(rows_p), jnp.asarray(lengths_p),
                                         jnp.asarray(number_lut),
                                         alphabet=alphabet))[:n]
    else:
        packed = tb.pack_2bit_np(number_lut[rows], lengths)
    clens = (lengths + 3) >> 2
    payload = rows_to_flat(packed, clens)
    return payload, clens


def _native_seq_text(headers, payload, clens, rlens, letter4, width):
    """Assemble the width-wrapped text image with the native unpacker
    (one pass per read), or return None when the shim is unavailable."""
    try:
        from ..native import qv_encode_shim, twobit_host_shim

        lib = twobit_host_shim()
        qe = qv_encode_shim()
    except OSError:
        return None
    n = len(rlens)
    rlens = np.ascontiguousarray(rlens.astype(np.int64))
    w = int(width) if width > 0 else (1 << 60)
    nlines = (rlens + w - 1) // w
    hdr_lens = np.array([len(h) for h in headers], np.int64)
    blk = hdr_lens + 1 + rlens + nlines
    blk_off = np.zeros(n + 1, np.int64)
    np.cumsum(blk, out=blk_off[1:])
    out = np.full(int(blk_off[-1]), ord("\n"), np.uint8)
    hdr_flat = np.frombuffer(b"".join(headers), np.uint8)
    dst = np.ascontiguousarray(blk_off[:-1])
    qe.dxt_ragged_copy(_ptr(out), _ptr(dst), _ptr(hdr_flat),
                       _ptr(np.ascontiguousarray(hdr_lens)), n)
    pay_offs = np.zeros(n + 1, np.int64)
    np.cumsum(clens, out=pay_offs[1:])
    seq_offs = np.ascontiguousarray(blk_off[:-1] + hdr_lens + 1)
    pay = np.ascontiguousarray(payload)
    lut = np.ascontiguousarray(letter4)
    lib.dxt_unpack_text(_ptr(pay), _ptr(pay_offs), _ptr(rlens), n, w,
                        _ptr(lut), _ptr(out), _ptr(seq_offs))
    return out.tobytes()


def _unpack_batch(payload, clens, rlens, letter_lut, device: bool):
    """Unpack per-read payload bytes into an (N, Lpad) ascii rectangle."""
    rows = pad_rows(payload, clens, align=128, bucket=device)
    if device:
        rows_p, _, n = _bucket_rows(rows, clens)
        sym = np.asarray(_decode_rows(jnp.asarray(rows_p), jnp.asarray(letter_lut)))[:n]
    else:
        sym = letter_lut[tb.unpack_2bit_np(rows)]
    return sym


# ---------------------------------------------------------------------------
# .dexta
# ---------------------------------------------------------------------------

def _auto(device):
    if device is None:
        from ..utils.dispatch import device_default
        return device_default()
    return device


def encode_fasta_to_dexta(data: bytes, device: bool | None = None) -> bytes:
    from ..utils.profiling import REPORTER

    device = _auto(device)
    with REPORTER.stage("parse", len(data)):
        f = fa.parse_seq_file(data, arrow=False)
    with REPORTER.stage("encode", int(f.seqs.lengths.sum())):
        payload, clens = _pack_batch(f.seqs.flat, f.seqs.lengths,
                                     tb.NUMBER_BASE_LUT, device,
                                     alphabet="base")
    with REPORTER.stage("assemble", int(clens.sum())):
        return dx.write_dexta(f.prefix, f.wells, f.begs, f.ends, f.qvs,
                              payload, clens)


def decode_dexta_to_fasta(data: bytes, width: int = 80, upper: bool = False,
                          device: bool | None = None) -> bytes:
    from ..utils.profiling import REPORTER

    device = _auto(device)
    with REPORTER.stage("parse", len(data)):
        d = dx.read_dexta(data, arrow=False)
        rlens = (d.ends - d.begs).astype(np.int64)
        lut = tb.UPPER_LUT if upper else tb.LOWER_LUT
        headers = fa.format_headers(d.prefix, d.wells, d.begs, d.ends,
                                    qvs=d.qvs)
    total = int(rlens.sum())
    if not device:
        with REPORTER.stage("decode+assemble", total):
            txt = _native_seq_text(headers, d.payload.flat,
                                   d.payload.lengths, rlens, lut, width)
            if txt is not None:
                return txt
    with REPORTER.stage("decode", total):
        sym = _unpack_batch(d.payload.flat, d.payload.lengths, rlens, lut,
                            device)
    with REPORTER.stage("assemble", total):
        return fa.write_seq_file(headers, sym, rlens, width=width)


# ---------------------------------------------------------------------------
# .dexar
# ---------------------------------------------------------------------------

def _snr_to_cnr(snrs: np.ndarray) -> np.ndarray:
    """float SNR -> uint16 snr*100, truncated, clamped at 9999 when > 99.99
    (reference dexar.c:159-163: the comparison is in double, the cast
    truncates)."""
    s = snrs.astype(np.float64)
    return np.where(s > 99.99, 9999, (s * 100.0).astype(np.int64)).astype(np.uint16)


def encode_arrow_to_dexar(data: bytes, device: bool | None = None) -> bytes:
    device = _auto(device)
    f = fa.parse_seq_file(data, arrow=True)
    payload, clens = _pack_batch(f.seqs.flat, f.seqs.lengths,
                                 tb.NUMBER_ARROW_LUT, device,
                                 alphabet="arrow")
    cnrs = _snr_to_cnr(f.snrs)
    return dx.write_dexar(f.prefix, f.wells, f.begs, f.ends, cnrs, payload, clens)


def decode_dexar_to_arrow(data: bytes, width: int = 80,
                          device: bool | None = None) -> bytes:
    device = _auto(device)
    d = dx.read_dexta(data, arrow=True)
    rlens = (d.ends - d.begs).astype(np.int64)
    snrs = d.cnrs.astype(np.float64) / 100.0
    headers = fa.format_headers(d.prefix, d.wells, d.begs, d.ends, snrs=snrs)
    if not device:
        txt = _native_seq_text(headers, d.payload.flat, d.payload.lengths,
                               rlens, tb.ARROW_LETTER_LUT, width)
        if txt is not None:
            return txt
    sym = _unpack_batch(d.payload.flat, d.payload.lengths, rlens,
                        tb.ARROW_LETTER_LUT, device)
    return fa.write_seq_file(headers, sym, rlens, width=width)
