"""Benchmark driver: one JSON line on stdout — ALWAYS.

Measures the flagship .dexqv five-channel Huffman codec and the 2-bit
.dexta codec on the accelerator with device-resident data (steady state),
against the reference C tools running on this host over the same logical
data when their sources are present.

One process per card: the parent never initializes a device (it pins
itself to the CPU for data generation, the C baselines and the native
host paths) and runs the device metrics in worker subprocesses strictly
one after another, because a JAX process reserves most of the card's
memory when it starts and a second one would fail for want of it.  A
worker appends one JSON line per completed metric to a results file, so
a failing metric loses only itself; the parent retries the remaining
metrics once in a fresh worker, then emits the final JSON line with
whatever succeeded (nulls for the rest).

The reference publishes no throughput numbers (BASELINE.md), so the
compiled C tool is the baseline; vs_baseline = our GB/s / C GB/s.

Usage: python bench.py [--mb N]
Internal: python bench.py --worker --metrics a,b --out FILE [--mb N]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(REPO, ".jax_cache"))

import numpy as np

WORKDIR = Path(REPO) / ".bench"
DEVICE_METRICS = ("qv_encode", "qv_decode", "dexta_decode", "dexta_encode",
                  "qv_decode_long", "qv_encode_long")
READ_LEN = 2000


def lognormal_lengths(mb: int):
    """Realistic PacBio subread mix: log-normal, ~10 kb median, 60 kb
    tail (clamped), drawn until the five-channel payload reaches ~2x the
    uniform batch — the long-read envelope the round-2 verdict required
    the fast paths to cover."""
    rng = np.random.default_rng(1)
    target = 2 * mb * 1_000_000 / 5
    lens, tot = [], 0
    while tot < target:
        L = int(np.clip(rng.lognormal(np.log(10_000), 0.8), 1_500, 60_000))
        lens.append(L)
        tot += L
    return np.array(lens, np.int64)


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# shared data prep (deterministic: seed 0 and a fixed generation order, so
# every run compiles the same shapes and shares .jax_cache)
# ---------------------------------------------------------------------------

def prep_data(mb: int) -> dict:
    from dextractor_tpu.testdata import make_quiva, make_fasta
    from dextractor_tpu.codecs.qv_codec import encode_quiva_to_dexqv
    from dextractor_tpu.codecs.twobit_codec import encode_fasta_to_dexta

    n_reads = max(8, (mb * 1_000_000) // (5 * READ_LEN))
    rng = np.random.default_rng(0)
    data = make_quiva(rng, n_reads=n_reads, min_len=READ_LEN - 50,
                      max_len=READ_LEN + 50)
    fasta = make_fasta(rng, n_reads=n_reads, min_len=READ_LEN - 50,
                       max_len=READ_LEN + 50, width=80)
    rng_l = np.random.default_rng(2)
    data_long = make_quiva(rng_l, lengths=lognormal_lengths(mb))
    WORKDIR.mkdir(parents=True, exist_ok=True)
    paths = {
        "quiva": WORKDIR / "g.quiva", "fasta": WORKDIR / "g.fasta",
        "dexqv": WORKDIR / "g.dexqv", "dexta": WORKDIR / "g.dexta",
        "quiva_long": WORKDIR / "glong.quiva",
        "dexqv_long": WORKDIR / "glong.dexqv",
    }
    paths["quiva"].write_bytes(data)
    paths["fasta"].write_bytes(fasta)
    paths["dexqv"].write_bytes(encode_quiva_to_dexqv(data, device=False))
    paths["dexta"].write_bytes(encode_fasta_to_dexta(fasta, device=False))
    paths["quiva_long"].write_bytes(data_long)
    paths["dexqv_long"].write_bytes(
        encode_quiva_to_dexqv(data_long, device=False))
    return paths


# ---------------------------------------------------------------------------
# worker: device metrics, one JSON line appended per completed metric
# ---------------------------------------------------------------------------

def measure_chained(chained, dargs, label):
    """Steady-state per-step time of a K-chained jitted program.

    Runs K chained steps inside one jitted fori_loop (each iteration
    data-depends on the last via a carried checksum) and times the
    difference between two K values, so the fixed dispatch and fetch
    overhead cancels."""
    import jax.numpy as jnp

    def run_k(k):
        t = time.perf_counter()
        v = chained(*dargs, jnp.int32(k))
        _ = int(v)                   # force full execution via fetch
        return time.perf_counter() - t

    t0 = time.perf_counter()
    run_k(1)                         # compile + warm
    log(f"{label}: compile+warm {time.perf_counter()-t0:.1f}s")
    # widen K until the difference clears the timer's noise floor;
    # estimate the per-step cost first and cap total device time
    k_lo = 2
    t_lo = min(run_k(k_lo) for _ in range(3))
    est = max(t_lo / k_lo, 1e-4)     # upper bound incl. fetch overhead
    budget_s = 22.0
    dt = None
    last = None                      # (k_hi, t_hi) of the last rung
    # the rungs must reach far enough that microsecond steps clear the
    # fixed dispatch and fetch floor
    for k_hi in (12, 52, 202, 1002, 5002, 20002):
        if est * k_hi > budget_s:
            break
        t_hi = min(run_k(k_hi) for _ in range(2))
        last = (k_hi, t_hi)
        log(f"{label}: k={k_hi}: {t_hi:.3f}s (k={k_lo}: {t_lo:.3f}s)")
        if t_hi - t_lo > 0.4 or t_hi > 30:
            dt = (t_hi - t_lo) / (k_hi - k_lo)
            break
        # refine the per-step estimate from the rung DIFFERENCE — the
        # initial t_lo/k_lo is dominated by the fixed fetch floor and
        # would truncate the ladder for microsecond steps
        est = max((t_hi - t_lo) / (k_hi - k_lo), 1e-6)
    if dt is None:
        # slow step: k_lo alone is far above the noise floor, so
        # difference two small K values instead of escalating
        if est * 3 > budget_s:
            t1 = min(run_k(1) for _ in range(2))
            dt = max(t_lo - t1, 1e-9)
        else:
            k_hi = max(3, min(20002, int(budget_s / est)))
            if last is not None and last[0] == k_hi:
                t_hi = last[1]       # the escalation already ran this k
            else:
                t_hi = min(run_k(k_hi) for _ in range(2))
                log(f"{label}: k={k_hi}: {t_hi:.3f}s (capped)")
            dt = max(t_hi - t_lo, 1e-9) / (k_hi - k_lo)
    return dt


def _metric_qv_encode(paths):
    import jax
    import jax.numpy as jnp
    from dextractor_tpu.formats.quiva import parse_quiva
    from dextractor_tpu.formats.ragged import pad_rows, bucket_rows
    from dextractor_tpu.codecs.qv_codec import scan_quiva, create_qvcoding
    from dextractor_tpu.ops import bitstream_jax as bj
    from dextractor_tpu.ops.twobit import NUMBER_BASE_LUT
    from dextractor_tpu.parallel import qv_encode_step, null_run_luts

    q = parse_quiva(paths["quiva"].read_bytes())
    lengths = q.lengths.astype(np.int64)
    stats = scan_quiva(q)
    coding = create_qvcoding(stats, q.prefix, False)
    rects = [pad_rows(q.streams[s], lengths, align=512, bucket=True)
             for s in range(5)]
    streams = np.stack(rects)
    n = q.n_entries
    n_pad = bucket_rows(n)
    if n_pad != n:
        streams = np.concatenate(
            [streams, np.zeros((5, n_pad - n, streams.shape[2]), np.uint8)], 1)
        lengths = np.concatenate([lengths, np.zeros(n_pad - n, np.int64)])

    sym = np.stack([
        bj.scheme_luts(coding.del_scheme),
        bj.scheme_luts(coding.ins_scheme),
        bj.scheme_luts(coding.mrg_scheme),
        bj.scheme_luts(coding.sub_scheme),
    ])
    run = np.stack([
        bj.scheme_luts(coding.drun_scheme, run=True)
        if coding.drun_scheme else null_run_luts(),
        null_run_luts(),
        null_run_luts(),
        bj.scheme_luts(coding.srun_scheme, run=True)
        if coding.srun_scheme else null_run_luts(),
    ])
    rchars = np.array([coding.del_char, -1, -1, coding.sub_char], np.int32)

    dargs = (jnp.asarray(streams), jnp.asarray(lengths.astype(np.int32)),
             jnp.asarray(sym), jnp.asarray(run), jnp.asarray(rchars),
             jnp.asarray(NUMBER_BASE_LUT))
    jax.block_until_ready(dargs)

    # a channel with no run scheme is a plain stream (QV.c:1393-1423) —
    # route it through the half-width plain emissions, as the file path
    # does
    run_on = (coding.drun_scheme is not None, coding.srun_scheme is not None)

    @jax.jit
    def enc_chained(streams_, lengths_, sym_, run_, rchars_, nlut_, k):
        # every iteration XORs the carried checksum into the symbol data so
        # the loop body cannot be hoisted as loop-invariant; the encode cost
        # profile is identical for arbitrary u8 symbols
        def body(_, acc):
            d = streams_ ^ (acc & 0xFF).astype(jnp.uint8)
            out = qv_encode_step(d, lengths_, sym_, run_, rchars_, nlut_,
                                 run_on=run_on)
            return acc + out[2].sum().astype(jnp.int32)
        return jax.lax.fori_loop(0, k, body, jnp.int32(0))

    return measure_chained(enc_chained, dargs, "qv-encode")


def qv_enc_long_parts(data: bytes):
    """(chained_fn, dargs, label) per pow2 row-width bucket of the
    five-channel encode step over a quiva image — the encode mirror of
    qv_dec_long_parts, so the long-read ENCODE path (the round-4
    SIGSEGV site) carries a recurring driver-captured number.

    Pow2 width buckets rather than the file path's quarter-octave ones:
    the log-normal mix would need ~20 quarter-octave programs; six pow2
    programs bound the compile count while keeping every row at <= 2x
    padding (a slightly pessimistic, honest envelope)."""
    import jax
    import jax.numpy as jnp
    from dextractor_tpu.formats.quiva import parse_quiva
    from dextractor_tpu.formats.ragged import pad_rows, bucket_rows
    from dextractor_tpu.codecs.qv_codec import scan_quiva, create_qvcoding
    from dextractor_tpu.ops import bitstream_jax as bj
    from dextractor_tpu.ops.twobit import NUMBER_BASE_LUT
    from dextractor_tpu.parallel import qv_encode_step, null_run_luts

    q = parse_quiva(data)
    lengths_all = q.lengths.astype(np.int64)
    stats = scan_quiva(q)
    coding = create_qvcoding(stats, q.prefix, False)
    sym = np.stack([
        bj.scheme_luts(coding.del_scheme),
        bj.scheme_luts(coding.ins_scheme),
        bj.scheme_luts(coding.mrg_scheme),
        bj.scheme_luts(coding.sub_scheme),
    ])
    run = np.stack([
        bj.scheme_luts(coding.drun_scheme, run=True)
        if coding.drun_scheme else null_run_luts(),
        null_run_luts(),
        null_run_luts(),
        bj.scheme_luts(coding.srun_scheme, run=True)
        if coding.srun_scheme else null_run_luts(),
    ])
    rchars = np.array([coding.del_char, -1, -1, coding.sub_char], np.int32)
    run_on = (coding.drun_scheme is not None,
              coding.srun_scheme is not None)

    off = np.zeros(q.n_entries + 1, np.int64)
    np.cumsum(lengths_all, out=off[1:])
    kb = np.maximum(512, 2 ** np.ceil(np.log2(np.maximum(
        lengths_all, 1))).astype(np.int64))
    parts = []
    for width in np.unique(kb):
        sel = np.flatnonzero(kb == width)
        lens_b = lengths_all[sel]
        n_b = len(sel)
        n_pad = bucket_rows(n_b)
        rects = []
        for s in range(5):
            idx = np.concatenate(
                [np.arange(off[i], off[i + 1]) for i in sel])
            r = pad_rows(q.streams[s][idx], lens_b, align=512)
            if r.shape[1] < width:
                r = np.concatenate(
                    [r, np.zeros((n_b, width - r.shape[1]), np.uint8)], 1)
            if n_pad != n_b:
                r = np.concatenate(
                    [r, np.zeros((n_pad - n_b, r.shape[1]), np.uint8)])
            rects.append(r)
        streams = np.stack(rects)
        lengths = np.zeros(n_pad, np.int32)
        lengths[:n_b] = lens_b
        dargs = (jnp.asarray(streams), jnp.asarray(lengths),
                 jnp.asarray(sym), jnp.asarray(run), jnp.asarray(rchars),
                 jnp.asarray(NUMBER_BASE_LUT))
        jax.block_until_ready(dargs)

        def make(run_on):
            @jax.jit
            def enc_chained(streams_, lengths_, sym_, run_, rchars_,
                            nlut_, k):
                def body(_, acc):
                    d = streams_ ^ (acc & 0xFF).astype(jnp.uint8)
                    out = qv_encode_step(d, lengths_, sym_, run_,
                                         rchars_, nlut_, run_on=run_on)
                    return acc + out[2].sum().astype(jnp.int32)
                return jax.lax.fori_loop(0, k, body, jnp.int32(0))
            return enc_chained

        parts.append((make(run_on), dargs,
                      f"qv-encode-long w={width} n={n_b}"))
    return parts


def _metric_qv_encode_long(paths):
    """Realistic-lengths encode: sum of per-bucket steady-state step
    times of the five-channel encode step over the log-normal batch."""
    data = paths["quiva_long"].read_bytes()
    total = 0.0
    for fn, dargs, label in qv_enc_long_parts(data):
        total += measure_chained(fn, dargs, label)
    return total


def _qv_dec_setup(enc: bytes, sel=None):
    """Build (chained_fn, dec_args) for the fused decode step over all
    entries of ``enc`` (or the subset ``sel``)."""
    import jax
    import jax.numpy as jnp
    from dextractor_tpu.codecs.qv_codec import _index_native
    from dextractor_tpu.codecs.qv_batch import decode_tables_v2, channel_rects
    from dextractor_tpu.formats import dexqv as dqf
    from dextractor_tpu.formats.ragged import bucket_len, bucket_rows
    from dextractor_tpu.ops import decode2 as d2
    from dextractor_tpu.utils.dispatch import chain_kernel

    coding, coff = dqf.parse_qvcoding(memoryview(enc), 2)
    indexed = _index_native(enc, coding, coff, True)
    if indexed is None:
        raise RuntimeError("native shim unavailable")
    (_, _, _, _, _, _, eoffs, elens, coffs_t, ntoks_t) = indexed
    if sel is not None:
        eoffs, elens = eoffs[sel], elens[sel]
        coffs_t, ntoks_t = coffs_t[sel], ntoks_t[sel]
    n_dec = len(eoffs)
    n_decp = bucket_rows(n_dec)
    dbuf = np.frombuffer(enc, np.uint8)
    drlens = np.pad(elens.astype(np.int32), (0, n_decp - n_dec))
    dec_max_len = bucket_len(int(drlens.max(initial=0)), 512)
    dec_max_sym = bucket_len(int(drlens.max(initial=0)))
    dec_max_tokens = bucket_len(int(ntoks_t.max(initial=0)), 16)
    rects = channel_rects(dbuf, eoffs, coffs_t, dec_max_len)
    rects = tuple(
        np.concatenate([r, np.zeros((n_decp - n_dec, r.shape[1]), r.dtype)])
        for r in rects)
    sids, f1_t, f2_t, types_t, del_mode, sub_mode, subw, lmax = \
        decode_tables_v2(coding)
    chan_l2 = tuple(bool(((f1_t[sids[k]] >> 20) & 1).any())
                    for k in range(6))
    dec_args = (*(jnp.asarray(r) for r in rects), jnp.asarray(drlens),
                jnp.asarray(sids), jnp.asarray(f1_t), jnp.asarray(f2_t),
                jnp.asarray(types_t), jnp.int32(coding.del_char & 0xFF),
                jnp.int32(coding.sub_char & 0xFF))
    jax.block_until_ready(dec_args)

    @jax.jit
    def dec_chained(rd_, tg_, ri_, rm_, rs_, rlens_, sids_, f1_, f2_, ty_,
                    dc_, sc_, k):
        # decode cost is shape-determined (fixed fori chains), so XORing
        # the del rectangle keeps cost identical while defeating hoisting
        def body(_, acc):
            r = rd_ ^ acc.astype(jnp.uint32)
            rows = d2.decode_entry_batch2(
                r, tg_, ri_, rm_, rs_, rlens_, sids_, f1_, f2_, ty_, dc_,
                sc_, max_len=dec_max_len, max_tokens=dec_max_tokens,
                del_mode=del_mode, sub_mode=sub_mode, subw=subw, lmax=lmax,
                chan_l2=chan_l2, max_sym=dec_max_sym, kernel=chain_kernel())
            return acc + rows.astype(jnp.int32).sum()
        return jax.lax.fori_loop(0, k, body, jnp.int32(0))

    return dec_chained, dec_args


def _metric_qv_decode(paths):
    fn, dec_args = _qv_dec_setup(paths["dexqv"].read_bytes())
    return measure_chained(fn, dec_args, "qv-decode")


def qv_dec_long_parts(enc: bytes):
    """(chained_fn, dec_args, label) parts of the checkpoint-segmented
    decode over a log-normal batch — each read runs as short chains from
    the native walker's checkpoints.  Default: ONE flat launch over all
    live segments (qv_batch.build_seg_launch_flat); DXT_SEG_FLAT=0
    reverts to the segs-per-read buckets for A/B."""
    import jax
    import jax.numpy as jnp
    from dextractor_tpu.codecs.qv_codec import (
        _index_native, _index_checkpoints)
    from dextractor_tpu.codecs.qv_batch import (
        seg_read_buckets, build_seg_launch, build_seg_launch_flat,
        decode_tables_v2)
    from dextractor_tpu.formats import dexqv as dqf
    from dextractor_tpu.ops import decode2 as d2
    from dextractor_tpu.utils.dispatch import chain_kernel

    coding, coff = dqf.parse_qvcoding(memoryview(enc), 2)
    idx = _index_native(enc, coding, coff, True)
    if idx is None:
        raise RuntimeError("native shim unavailable")
    eoffs, elens, coffs_t, ntoks_t = idx[6], idx[7], idx[8], idx[9]
    ck = _index_checkpoints(enc, coding, coff, True, idx)
    if ck is None:
        raise RuntimeError("no long reads in the batch")
    buf = np.frombuffer(enc, np.uint8)
    rlens = elens.astype(np.int32)
    sids, f1, f2, types, del_mode, sub_mode, subw, lmax = \
        decode_tables_v2(coding)
    chan_l2 = tuple(bool(((f1[sids[k]] >> 20) & 1).any())
                    for k in range(6))
    args_rep = (jnp.asarray(sids), jnp.asarray(f1), jnp.asarray(f2),
                jnp.asarray(types), jnp.int32(coding.del_char & 0xFF),
                jnp.int32(coding.sub_char & 0xFF))

    def make(statics):
        @jax.jit
        def chained(rd_, tg_, ri_, rm_, rs_, rl_, srl_, p0_, cr_,
                    sids_, f1_, f2_, ty_, dc_, sc_, k):
            def body(_, acc):
                r = rd_ ^ acc.astype(jnp.uint32)
                rows = d2.decode_entry_batch_seg(
                    r, tg_, ri_, rm_, rs_, rl_, srl_, p0_, cr_,
                    sids_, f1_, f2_, ty_, dc_, sc_, **statics)
                return acc + rows.astype(jnp.int32).sum()
            return jax.lax.fori_loop(0, k, body, jnp.int32(0))
        return chained

    if os.environ.get("DXT_SEG_FLAT", "1") == "1":
        args, statics, rid, _ = build_seg_launch_flat(
            buf, eoffs, rlens, coffs_t, ntoks_t, coding, ck)
        statics.update(subw=subw, lmax=lmax, chan_l2=chan_l2,
                       kernel=chain_kernel())
        dargs = tuple(jnp.asarray(a) for a in args) + args_rep
        return [(make(dict(statics)), dargs,
                 f"qv-decode-long flat ns={len(rid)}")]

    parts = []
    for sel in seg_read_buckets(rlens, ck[0]):
        args, statics = build_seg_launch(buf, eoffs, rlens, coffs_t,
                                         ntoks_t, coding, ck, sel)
        statics.update(subw=subw, lmax=lmax, chan_l2=chan_l2,
                       kernel=chain_kernel())
        dargs = tuple(jnp.asarray(a) for a in args) + args_rep
        parts.append((make(dict(statics)), dargs,
                      f"qv-decode-long s={statics['s_per']} n={len(sel)}"))
    return parts


def _metric_qv_decode_long(paths):
    """Realistic-lengths decode: sum of per-bucket steady-state step
    times of the checkpoint-segmented fused step over the whole
    log-normal batch."""
    enc = paths["dexqv_long"].read_bytes()
    total = 0.0
    for fn, dargs, label in qv_dec_long_parts(enc):
        total += measure_chained(fn, dargs, label)
    return total


def _dexta_rows(paths):
    from dextractor_tpu.formats.dexta import read_dexta
    from dextractor_tpu.formats.ragged import pad_rows, bucket_rows

    df = read_dexta(paths["dexta"].read_bytes())
    frlens = (df.ends - df.begs).astype(np.int64)
    fclens = df.payload.lengths
    prow = pad_rows(df.payload.flat, fclens, align=128, bucket=True)
    npad = bucket_rows(len(frlens))
    prow = np.concatenate(
        [prow, np.zeros((npad - prow.shape[0], prow.shape[1]), np.uint8)])
    return prow, frlens, npad


def _metric_dexta_decode(paths):
    import jax
    import jax.numpy as jnp
    from dextractor_tpu.codecs.twobit_codec import _decode_rows
    from dextractor_tpu.ops.twobit import LOWER_LUT

    prow, _, _ = _dexta_rows(paths)
    dx_args = (jnp.asarray(prow), jnp.asarray(LOWER_LUT))
    jax.block_until_ready(dx_args)

    @jax.jit
    def dexta_dec_chained(rows_, lut_, k):
        def body(_, acc):
            r = rows_ ^ (acc & 0xFF).astype(jnp.uint8)
            sym = _decode_rows(r, lut_)
            return acc + sym.astype(jnp.int32).sum()
        return jax.lax.fori_loop(0, k, body, jnp.int32(0))

    return measure_chained(dexta_dec_chained, dx_args, "dexta-decode")


def _metric_dexta_encode(paths):
    import jax
    import jax.numpy as jnp
    from dextractor_tpu.codecs.twobit_codec import _decode_rows, _encode_rows
    from dextractor_tpu.ops.twobit import NUMBER_BASE_LUT as NLUT, LOWER_LUT

    prow, frlens, npad = _dexta_rows(paths)
    seq_rows = np.asarray(_decode_rows(jnp.asarray(prow),
                                       jnp.asarray(LOWER_LUT)))
    flens = np.pad(frlens, (0, npad - len(frlens))).astype(np.int32)
    ex_args = (jnp.asarray(seq_rows), jnp.asarray(flens), jnp.asarray(NLUT))
    jax.block_until_ready(ex_args)

    @jax.jit
    def dexta_enc_chained(rows_, lens_, lut_, k):
        def body(_, acc):
            # flip case bit only: stays in the LUT's alphabet, defeats hoist
            r = rows_ ^ ((acc & 0x1) << 5).astype(jnp.uint8)
            packed = _encode_rows(r, lens_, lut_, alphabet="base")
            return acc + packed.astype(jnp.int32).sum()
        return jax.lax.fori_loop(0, k, body, jnp.int32(0))

    return measure_chained(dexta_enc_chained, ex_args, "dexta-encode")


_METRIC_FNS = {
    "qv_encode": _metric_qv_encode,
    "qv_decode": _metric_qv_decode,
    "qv_decode_long": _metric_qv_decode_long,
    "qv_encode_long": _metric_qv_encode_long,
    "dexta_decode": _metric_dexta_decode,
    "dexta_encode": _metric_dexta_encode,
}


def worker_main(metrics: list[str], out_path: Path) -> None:
    import jax
    jax.config.update("jax_compilation_cache_dir",
                      os.environ["JAX_COMPILATION_CACHE_DIR"])
    platform = jax.devices()[0].platform
    log(f"worker platform={platform} metrics={metrics}")
    paths = {k: WORKDIR / f"g.{k}"
             for k in ("quiva", "fasta", "dexqv", "dexta")}
    paths["quiva_long"] = WORKDIR / "glong.quiva"
    paths["dexqv_long"] = WORKDIR / "glong.dexqv"
    with open(out_path, "a") as out:
        out.write(json.dumps({"event": "platform", "platform": platform})
                  + "\n")
        out.flush()
        for m in metrics:
            try:
                dt = _METRIC_FNS[m](paths)
                rec = {"metric": m, "dt": dt}
            except Exception as e:   # record and continue — the parent
                # retries errored metrics once in a fresh process
                rec = {"metric": m, "error": f"{type(e).__name__}: {e}"}
                log(f"{m} FAILED: {rec['error']}")
            out.write(json.dumps(rec) + "\n")
            out.flush()


# ---------------------------------------------------------------------------
# parent: C baselines, worker supervision, final JSON
# ---------------------------------------------------------------------------

def build_ref_tools() -> Path | None:
    ref = Path("/root/reference")
    if not ref.is_dir():
        return None
    build = WORKDIR / "ref"
    build.mkdir(parents=True, exist_ok=True)
    for src in ref.glob("*.[ch]"):
        (build / src.name).write_bytes(src.read_bytes())
    for tool in ("dexqv", "undexqv", "dexta", "undexta"):
        exe = build / tool
        if not exe.exists():
            r = subprocess.run(
                ["gcc", "-O3", "-fno-strict-aliasing", "-o", str(exe),
                 f"{tool}.c", "DB.c", "QV.c", "-lm"],
                cwd=build, capture_output=True)
            if r.returncode != 0:
                return None
    return build


def time_tool(build: Path, tool: str, args: list[str]) -> float | None:
    """min-of-5 wall time of a reference tool run, or None (the bench
    host is shared and noisy; min damps load spikes)."""
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        try:
            r = subprocess.run([str(build / tool)] + args,
                               capture_output=True, timeout=300)
        except subprocess.TimeoutExpired:
            continue
        if r.returncode == 0:
            times.append(time.perf_counter() - t0)
    return min(times) if times else None


def run_device_metrics(mb: int, budget_s: float, env: dict) -> dict:
    """Run worker subprocesses, one at a time, until all metrics land or
    the budget runs out.

    ``env`` is the environment snapshot taken BEFORE the parent pinned
    itself to the CPU (JAX_PLATFORMS=cpu in os.environ for the parent's
    own host-side work) — the worker must see the real device."""
    results: dict = {}
    out_path = WORKDIR / "device_metrics.jsonl"
    if out_path.exists():
        out_path.unlink()
    deadline = time.monotonic() + budget_s
    attempts = 0
    err_counts: dict = {}
    remaining = [m for m in DEVICE_METRICS]
    while remaining and attempts < 2 and time.monotonic() < deadline:
        attempts += 1
        left = deadline - time.monotonic()
        log(f"worker attempt {attempts}: metrics={remaining} "
            f"budget_left={left/60:.1f}min")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               "--mb", str(mb), "--metrics", ",".join(remaining),
               "--out", str(out_path)]
        try:
            r = subprocess.run(cmd, timeout=max(60.0, left), env=env,
                               stdout=sys.stderr, stderr=sys.stderr)
            rc = r.returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        # harvest whatever the worker managed to append before dying
        if out_path.exists():
            for line in out_path.read_text().splitlines():
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("event") == "platform":
                    results["platform"] = rec["platform"]
                elif "dt" in rec:
                    results[rec["metric"]] = rec["dt"]
                elif rec.get("metric") not in results:
                    key = (rec["metric"], rec.get("error"))
                    err_counts[key] = err_counts.get(key, 0) + 1
                    results.setdefault("errors", {})[rec["metric"]] = \
                        rec.get("error")
        # a metric failing twice with the identical error is deterministic
        # (e.g. missing native shim), not a transient worker death: drop it
        dead = {m for (m, _), c in err_counts.items() if c >= 2}
        remaining = [m for m in DEVICE_METRICS
                     if m not in results and m not in dead]
        if remaining:
            log(f"worker attempt {attempts} rc={rc}; missing {remaining}")
    return results


def main() -> None:
    mb = 16
    budget_s = float(os.environ.get("DXT_BENCH_BUDGET_S", "4200"))
    args = sys.argv[1:]
    worker = "--worker" in args
    metrics: list[str] = []
    out: Path | None = None
    for i, a in enumerate(args):
        if a == "--mb":
            mb = int(args[i + 1])
        elif a == "--metrics":
            metrics = args[i + 1].split(",")
        elif a == "--out":
            out = Path(args[i + 1])

    if worker:
        worker_main(metrics, out or (WORKDIR / "device_metrics.jsonl"))
        return

    t_start = time.monotonic()
    worker_env = dict(os.environ)    # BEFORE the parent pins itself to CPU
    os.environ["JAX_PLATFORMS"] = "cpu"
    log(f"generating {mb} MB batches + host encodes ...")
    paths = prep_data(mb)

    from dextractor_tpu.formats.quiva import parse_quiva
    from dextractor_tpu.formats.dexta import read_dexta
    data = paths["quiva"].read_bytes()
    enc = paths["dexqv"].read_bytes()
    q = parse_quiva(data)
    payload_bytes = int(q.lengths.sum()) * 5        # the five QV streams
    q_long = parse_quiva(paths["quiva_long"].read_bytes())
    payload_long = int(q_long.lengths.sum()) * 5
    df = read_dexta(paths["dexta"].read_bytes())
    total_bases = int((df.ends - df.begs).sum())

    # ---- device metrics via supervised worker subprocesses -------------
    dev = run_device_metrics(mb, budget_s - (time.monotonic() - t_start)
                             - 240.0, worker_env)   # reserve tail time

    def gbps_of(metric, payload):
        dt = dev.get(metric)
        return (payload / dt / 1e9, dt) if dt else (None, None)

    gbps, dt = gbps_of("qv_encode", payload_bytes)
    dec_gbps, _ = gbps_of("qv_decode", payload_bytes)
    dec_long_gbps, _ = gbps_of("qv_decode_long", payload_long)
    enc_long_gbps, _ = gbps_of("qv_encode_long", payload_long)
    dexta_dec_gbps, _ = gbps_of("dexta_decode", total_bases)
    dexta_enc_gbps, _ = gbps_of("dexta_encode", total_bases)

    # ---- C baselines ----------------------------------------------------
    base_dt = c_undexqv = c_dexta = c_undexta = None
    try:
        build = build_ref_tools()
    except Exception as e:
        log(f"reference build failed: {e}")
        build = None
    if build is not None:
        base_dt = time_tool(build, "dexqv", ["-k", str(paths["quiva"])])
        c_undexqv = time_tool(build, "undexqv", ["-k", str(paths["dexqv"])])
        c_dexta = time_tool(build, "dexta", ["-k", str(paths["fasta"])])
        c_undexta = time_tool(build, "undexta", ["-k", str(paths["dexta"])])
    base_gbps = payload_bytes / base_dt / 1e9 if base_dt else None
    vs = (gbps / base_gbps) if (base_gbps and gbps) else None
    c_undexqv_gbps = payload_bytes / c_undexqv / 1e9 if c_undexqv else None
    c_dexta_gbps = total_bases / c_dexta / 1e9 if c_dexta else None
    c_undexta_gbps = total_bases / c_undexta / 1e9 if c_undexta else None

    # ---- native host decode (correctness witness, no device) ------------
    # best-of-5 with spread: this host is shared and loaded, and a
    # single-shot number swung 324 -> 240 MB/s across rounds with no
    # code change (round-4 verdict weak #7) — the JSON tags every
    # host-side figure load_sensitive and carries the observed spread
    dec_mbps = dec_ok = dec_mbps_spread = None
    try:
        from dextractor_tpu.codecs.qv_codec import decode_dexqv_to_quiva
        decode_dexqv_to_quiva(enc)               # warm page/arena reuse
        dts = []
        for _ in range(5):
            t0 = time.perf_counter()
            dec = decode_dexqv_to_quiva(enc)
            dts.append(time.perf_counter() - t0)
        dec_ok = dec == data
        dec_mbps = round(len(data) / min(dts) / 1e6, 1)
        dec_mbps_spread = round(len(data) / max(dts) / 1e6, 1)
    except Exception as e:
        log(f"native decode failed: {e}")

    def rnd(x, p=4):
        return round(x, p) if x is not None else None

    print(json.dumps({
        "metric": "dexqv_encode_throughput",
        "value": rnd(gbps),
        "unit": "GB/s",
        "vs_baseline": rnd(vs, 3),
        "detail": {
            "platform": dev.get("platform"),
            "payload_MB": round(payload_bytes / 1e6, 1),
            "step_s": rnd(dt),
            "c_ref_s": rnd(base_dt, 3),
            "c_ref_GBps": rnd(base_gbps),
            "dexqv_decode_throughput": {
                "value": rnd(dec_gbps), "unit": "GB/s",
                "vs_baseline": rnd(dec_gbps / c_undexqv_gbps, 3)
                if (c_undexqv_gbps and dec_gbps) else None,
                "c_undexqv_GBps": rnd(c_undexqv_gbps)},
            "dexqv_decode_longreads_throughput": {
                "value": rnd(dec_long_gbps), "unit": "GB/s",
                "payload_MB": round(payload_long / 1e6, 1),
                "note": "log-normal ~10kb median, 60kb tail; sum of "
                        "per-bucket fused steps",
                "vs_uniform_2kb": rnd(dec_long_gbps / dec_gbps, 3)
                if (dec_gbps and dec_long_gbps) else None},
            "dexqv_encode_longreads_throughput": {
                "value": rnd(enc_long_gbps), "unit": "GB/s",
                "payload_MB": round(payload_long / 1e6, 1),
                "note": "same log-normal batch; pow2 width buckets "
                        "(compile-bounded envelope of the file path's "
                        "quarter-octave buckets)",
                "vs_uniform_2kb": rnd(enc_long_gbps / gbps, 3)
                if (gbps and enc_long_gbps) else None},
            "dexta_decode_throughput": {
                "value": rnd(dexta_dec_gbps), "unit": "GB/s",
                "vs_baseline": rnd(dexta_dec_gbps / c_undexta_gbps, 3)
                if (c_undexta_gbps and dexta_dec_gbps) else None,
                "c_undexta_GBps": rnd(c_undexta_gbps)},
            "dexta_encode_throughput": {
                "value": rnd(dexta_enc_gbps), "unit": "GB/s",
                "vs_baseline": rnd(dexta_enc_gbps / c_dexta_gbps, 3)
                if (c_dexta_gbps and dexta_enc_gbps) else None,
                "c_dexta_GBps": rnd(c_dexta_gbps)},
            "decode_native_MBps": dec_mbps,
            "decode_native_MBps_worst_of_5": dec_mbps_spread,
            "decode_roundtrip_ok": dec_ok,
            "host_side_note": "decode_native_* and c_*_GBps run on a "
                              "shared, loaded host: load_sensitive — "
                              "best-of-k damped, compare across rounds "
                              "with the spread in mind",
            "device_metric_errors": dev.get("errors") or None,
            "note": "device-resident steady-state steps",
        },
    }), flush=True)


if __name__ == "__main__":
    main()
