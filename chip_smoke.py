"""Smoke run of the codec's main path on one NVIDIA GPU (or four, sharded).

    python chip_smoke.py [--seed N]      # one card: every phase below
    python chip_smoke.py --cards 4       # the sharded data-mesh path only
    python chip_smoke.py --ab            # kernel vs plain-XLA timings

Phases (one card), each byte-compared with an in-repo reference
(tolerance zero: the codecs are lossless):

  kernels        the compiled Huffman chain kernels (ops/chain_gpu) vs the
                 XLA chains and the NumPy bitstream oracle at real width;
  dexqv_uniform  33 MB of five-channel QVs in 2 kb reads: device encode vs
                 the native encoder, device decode vs the input and the
                 native walker, a subset vs the NumPy oracle;
  dexqv_long     the log-normal long-read mix (~10 kb median, 60 kb clamp),
                 which decodes through the checkpoint-segmented launch;
  dexta, dexar   64 Mbases each, device encode/decode vs the native 2-bit
                 codec and the input;
  db             dex2DB -q over two SMRT cells (BAM) of the long-read mix,
                 33 MB of QVs, then the device QV loaders (per-cell
                 checkpoint-segmented and multi-scheme batch) vs the BAM
                 input and the host per-read decoder.

Every phase asserts that the device path ran: the GPU chain kernel for
decodes, the device encode for encodes — a host fallback cannot pass for a
device run.  Data comes from ``--seed``.  The script uses one process per
card and starts no JAX child.  It exits non-zero and prints no result when
JAX finds no GPU.  The last stdout line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

REPO = os.path.dirname(os.path.abspath(__file__))
TRACES = os.path.join(REPO, ".bench", "traces")     # --ab profiler traces

# uniform 2 kb reads (1950-2048, inside one 2048-symbol decode segment):
# 3300 x ~2000 x 5 channels = 33 MB of QV payload
UNIFORM_READS = 3300
READ_MIN, READ_MAX = 1950, 2048
LONG_PAYLOAD = 33_000_000
TWOBIT_READS = 6600          # x ~10 kb = ~66 Mbases
DB_CELLS = 2
DB_PAYLOAD = 33_000_000      # over all cells, log-normal lengths


def log(msg: str) -> None:
    print(msg, flush=True)


class Calls:
    """Counts calls of module functions (looked up at call time), so each
    phase can prove which implementation ran."""

    def __init__(self, *targets):
        self.n = collections.Counter()
        self._orig = []
        for mod, name in targets:
            fn = getattr(mod, name)
            self._orig.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def wrapped(*a, **k):
            self.n[name] += 1
            return fn(*a, **k)
        return wrapped

    def close(self):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)


@contextmanager
def phase(name: str, nbytes: int, calls: Calls):
    import jax

    jax.clear_caches()           # retrace: the call counters see each path
    calls.n.clear()
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s, {nbytes} bytes")


class Steps:
    """Wall time of the named steps inside a phase, logged as they end."""

    def __init__(self, phase_name: str):
        self.phase = phase_name

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        log(f"  {self.phase}.{name}: {time.perf_counter() - t0:.3f} s")


def _same(a, b, what: str) -> None:
    if a != b:
        raise AssertionError(f"{what}: mismatch")


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def lognormal_lengths(rng, payload: int):
    """Log-normal PacBio subread lengths (~10 kb median, 1.5-60 kb) until
    the five-channel payload reaches ``payload`` bytes."""
    import numpy as np

    lens, tot = [], 0
    while tot * 5 < payload:
        L = int(np.clip(rng.lognormal(np.log(10_000), 0.8), 1_500, 60_000))
        lens.append(L)
        tot += L
    return np.array(lens, np.int64)


# ---------------------------------------------------------------------------
# kernel check (also the body of tests/test_chain_gpu's gpu-marked test)
# ---------------------------------------------------------------------------

def check_chain_kernels(seed: int, n_chains: int, max_len: int,
                        interpret: bool = False) -> None:
    """Chain kernels vs the XLA chains and the NumPy oracle: plain chains
    over an L2-table scheme and a type-2 escape scheme, run chains with
    16-bit run literals, at ``max_len`` symbols per chain."""
    import numpy as np
    import jax.numpy as jnp
    from dextractor_tpu.ops import bitstream as bs
    from dextractor_tpu.ops import chain_gpu as cg
    from dextractor_tpu.ops import decode2 as d2
    from dextractor_tpu.ops.huffman import make_scheme

    rng = np.random.default_rng(seed)
    hists = []
    h = np.zeros(256, np.int64)
    h[:6] = rng.integers(50_000, 200_000, 6)
    h[6:44] = rng.integers(1, 3, 38)
    hists.append(h)
    h = np.zeros(256, np.int64)
    h[:40] = 2 ** np.arange(40, 0, -1, dtype=np.int64)
    hists.append(h)
    rh = rng.integers(1, 50, 256).astype(np.int64)
    rh[255] = 60
    rscheme = make_scheme(rh)
    n_oracle = min(n_chains, 24)
    for hist in hists:
        scheme = make_scheme(hist)
        syms = np.flatnonzero(scheme.codelens > 0).astype(np.uint8)
        f1, f2, subw, lmax = d2.scheme_tables2([scheme, rscheme])
        sig = 255 if scheme.type == 2 else 256
        rlens = rng.integers(0, max_len + 1, n_chains).astype(np.int32)
        rlens[-1] = max_len
        rchar = int(syms[len(syms) // 2])
        for run in (False, True):
            datas = []
            for r in rlens:
                d = rng.choice(syms, r)
                if run:
                    d[rng.random(r) < 0.97] = rchar
                datas.append(d)
            if run:                   # one run past 255: a 16-bit literal
                datas[-1][:-1] = rchar
            streams = [(bs.encode_run_stream(scheme, rscheme, d, rchar)
                        if run else bs.encode_stream(scheme, d)).tobytes()
                       for d in datas]
            k = 1 << (max(len(s) for s in streams) // 4 + 12).bit_length()
            rect8 = np.zeros((n_chains, 4 * k), np.uint8)
            for i, s in enumerate(streams):
                rect8[i, :len(s)] = np.frombuffer(s, np.uint8)
            rect = jnp.asarray(rect8.view(np.uint32))
            rl = jnp.asarray(rlens)
            z = jnp.zeros(n_chains, jnp.int32)
            if run:
                t = max_len + 2
                runs, lits, _, _ = cg.run_chains_gpu(
                    rect, rl, z + 1, z, z + sig, z, z - 1, jnp.asarray(f1),
                    jnp.asarray(f2), max_tokens=t, subw=subw, lmax=lmax,
                    interpret=interpret)
                xr, xl = d2.run_chain(
                    rect, rl, jnp.asarray(f1[1]), jnp.asarray(f1[0]),
                    jnp.asarray(f2), jnp.int32(sig), max_tokens=t,
                    subw=subw, lmax=lmax)
                _need((np.asarray(runs) == np.asarray(xr)[:, :t]).all()
                      and (np.asarray(lits) == np.asarray(xl)[:, :t]).all(),
                      "run chain kernel != XLA run chain")
                _need(int(np.asarray(runs).max()) > 255,
                      "run check did not reach 16-bit run literals")
                rows = np.asarray(d2.expand_runs2(
                    runs, lits, jnp.uint8(rchar), max_len=max_len))
            else:
                rows, _, _ = cg.plain_chains_gpu(
                    rect, rl, z, z + sig, z, jnp.asarray(f1),
                    jnp.asarray(f2), max_len=max_len, subw=subw, lmax=lmax,
                    interpret=interpret)
                xla = d2.plain_chain(rect, rl, jnp.asarray(f1[0]),
                                     jnp.asarray(f2), jnp.int32(sig),
                                     max_len=max_len, subw=subw, lmax=lmax)
                rows = np.asarray(rows)
                _need((rows == np.asarray(xla)).all(),
                      "plain chain kernel != XLA plain chain")
            for i in range(n_chains):
                _need((rows[i, :rlens[i]] == datas[i]).all(),
                      f"chain {i} does not round-trip")
            for i in range(n_oracle):
                buf = np.frombuffer(streams[i] + bytes(8), np.uint8)
                rd = bs.BitReader(buf, 0)
                ref = (bs.decode_run_stream(scheme, rscheme, rd,
                                            int(rlens[i]), rchar)[0]
                       if run else bs.decode_stream(scheme, rd,
                                                    int(rlens[i]))[0])
                _need((rows[i, :rlens[i]] == ref).all(),
                      f"chain {i} != NumPy oracle")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _qv_oracle_subset(quiva: bytes, enc: bytes, dec_streams, k: int):
    """Compare k entries spread over the batch with the NumPy oracle:
    encode_entry bytes at the entry's container offset, and decode_entry
    symbols."""
    import numpy as np
    from dextractor_tpu.codecs import qv_codec
    from dextractor_tpu.formats import dexqv as dq
    from dextractor_tpu.formats.quiva import parse_quiva

    q = parse_quiva(quiva)
    coding, coff = dq.parse_qvcoding(memoryview(enc), 2)
    idx = qv_codec._index_native(enc, coding, coff, True)
    eoffs, elens = idx[6], idx[7]
    buf = np.frombuffer(enc, np.uint8)
    off = np.zeros(q.n_entries + 1, np.int64)
    np.cumsum(q.lengths, out=off[1:])
    for i in np.linspace(0, q.n_entries - 1, k).astype(int):
        s, e = off[i], off[i + 1]
        blob = qv_codec.encode_entry(coding, *(q.streams[c, s:e]
                                               for c in range(5)), False)
        _same(bytes(buf[eoffs[i]:eoffs[i] + len(blob)]), blob,
              f"entry {i} vs NumPy encoder")
        ref, _ = qv_codec.decode_entry(coding, buf, int(eoffs[i]),
                                       int(elens[i]))
        _need((dec_streams[:, s:e] == ref).all(),
              f"entry {i} vs NumPy decoder")


def run_qv_phase(name: str, quiva: bytes, calls: Calls, seg: bool,
                 oracle_k: int = 48) -> None:
    import numpy as np
    from dextractor_tpu.codecs import qv_codec
    from dextractor_tpu.formats.quiva import parse_quiva

    q = parse_quiva(quiva)
    payload = int(q.lengths.sum()) * 5
    step = Steps(name)
    with phase(name, payload, calls):
        with step("encode_device"):
            enc_dev = qv_codec.encode_quiva_to_dexqv(quiva, device=True)
        _need(calls.n["_encode_entries_device"] == 1
              and calls.n["encode_rows_np"] > 0
              and calls.n["_encode_entries_native"] == 0,
              f"{name}: encode did not run on the device")
        with step("encode_device_again"):
            _same(qv_codec.encode_quiva_to_dexqv(quiva, device=True),
                  enc_dev, f"{name}: device encode is not deterministic")
        with step("encode_native"):
            enc_host = qv_codec.encode_quiva_to_dexqv(quiva, device=False)
        _same(enc_dev, enc_host, f"{name}: device container vs native")
        calls.n.clear()
        with step("decode_device"):
            dec_dev = qv_codec.decode_dexqv_to_quiva(enc_host, device=True)
        _need(calls.n["_decode_entries_device"] == 1
              and calls.n["_walk_native"] == 0
              and calls.n["plain_chains_gpu"] > 0
              and calls.n["run_chains_gpu"] > 0,
              f"{name}: decode did not run the GPU chain kernel")
        _need(calls.n["fused_decode_entries_seg"] == int(seg),
              f"{name}: segmented launch used={not seg}")
        _same(dec_dev, quiva, f"{name}: device decode vs input")
        with step("decode_device_again"):
            _same(qv_codec.decode_dexqv_to_quiva(enc_host, device=True),
                  dec_dev, f"{name}: device decode is not deterministic")
        with step("decode_native"):
            _same(qv_codec.decode_dexqv_to_quiva(enc_host, device=False),
                  quiva, f"{name}: native walker vs input")
        with step("numpy_oracle"):
            _qv_oracle_subset(quiva, enc_host, parse_quiva(dec_dev).streams,
                              oracle_k)
        log(f"  {name}: {q.n_entries} reads, container {len(enc_host)} "
            f"bytes, max read {int(q.lengths.max())}")


def run_twobit_phase(name: str, data: bytes, calls: Calls) -> None:
    from dextractor_tpu.codecs import twobit_codec as tc

    arrow = name == "dexar"
    enc_fn = tc.encode_arrow_to_dexar if arrow else tc.encode_fasta_to_dexta
    dec_fn = tc.decode_dexar_to_arrow if arrow else tc.decode_dexta_to_fasta
    with phase(name, len(data), calls):
        enc_dev = enc_fn(data, device=True)
        _need(calls.n["_encode_rows"] > 0, f"{name}: encode not on device")
        enc_host = enc_fn(data, device=False)
        _same(enc_dev, enc_host, f"{name}: device container vs native")
        dec_dev = dec_fn(enc_host, device=True)
        _need(calls.n["_decode_rows"] > 0, f"{name}: decode not on device")
        _same(dec_dev, dec_fn(enc_host, device=False),
              f"{name}: device decode vs native")
        if arrow:     # headers keep SNR x100 clamped at 99.99 (dexar.c)
            seq = lambda t: [ln for ln in t.split(b"\n")
                             if not ln.startswith(b">")]
            _same(seq(dec_dev), seq(data), f"{name}: device decode vs input")
        else:
            _same(dec_dev, data, f"{name}: device decode vs input")
        log(f"  {name}: container {len(enc_host)} bytes")


def run_db_phase(rng, calls: Calls, workdir: str) -> None:
    import numpy as np
    from dextractor_tpu.cli.dex2DB import main as dex2db_main
    from dextractor_tpu.codecs.qv_batch import batch_decode_entries
    from dextractor_tpu.db import open_db
    from dextractor_tpu.formats.ragged import rows_to_flat
    from dextractor_tpu.testdata import make_bam

    recs = []
    names = []
    lens = lognormal_lengths(rng, DB_PAYLOAD)
    for c in range(DB_CELLS):
        bam, r = make_bam(rng, lengths=lens[c::DB_CELLS],
                          movie=b"m54238_180903_%d" % c)
        fn = f"cell{c}.subreads.bam"
        with open(os.path.join(workdir, fn), "wb") as f:
            f.write(bam)
        names.append(fn)
        recs += r
    nbases = sum(e["ln"] for e in recs)
    step = Steps("db")
    with phase("db", 5 * nbases, calls):
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            with step("dex2DB"):
                rc = dex2db_main(["-q", "-eln>=0", "SMOKE", *names])
        finally:
            os.chdir(cwd)
        _need(rc == 0, f"dex2DB exited {rc}")
        db = open_db(os.path.join(workdir, "SMOKE.db"))
        db.open_qvs()
        _need(len(db._qv.codings) == DB_CELLS, "one QV coding per cell")
        calls.n.clear()
        with step("load_all_qventries"):
            streams, lengths = db.load_all_qventries(ascii_mode=1)
        _need(calls.n["plain_chains_gpu"] > 0
              and calls.n["run_chains_gpu"] > 0,
              "db: fused loader did not run the GPU chain kernel")
        _need(calls.n["fused_decode_entries_seg"] == DB_CELLS,
              "db: long reads did not take the segmented launch")
        qv = db._qv
        calls.n.clear()
        with step("batch_decode_entries"):
            rows, rl = batch_decode_entries(
                qv.data, db.reads["coff"].astype(np.int64),
                db.reads["rlen"].astype(np.int32), qv.codings, qv.table)
        _need(calls.n["plain_chains_gpu"] > 0
              and calls.n["run_chains_gpu"] > 0,
              "db: multi-scheme batch did not run the GPU chain kernel")
        multi = np.stack([rows_to_flat(rows[s], rl) for s in range(5)])
        _need((multi == streams).all(), "db: multi-scheme batch vs fused")
        off = np.zeros(len(lengths) + 1, np.int64)
        np.cumsum(lengths, out=off[1:])
        _need(len(recs) == db.nreads, "db: read count")
        for i, e in enumerate(recs):
            for c in (0, 2, 3, 4):
                _same(streams[c, off[i]:off[i + 1]].tobytes(), e["qvs"][c],
                      f"db: read {i} channel {c} vs BAM input")
        for i in np.linspace(0, db.nreads - 1, 24).astype(int):
            ref = db.load_qventry(int(i), ascii_mode=1)
            _need((streams[:, off[i]:off[i + 1]] == ref).all(),
                  f"db: read {i} vs host per-read decoder")
        log(f"  db: {db.nreads} reads in {DB_CELLS} cells, .qvs "
            f"{len(qv.data)} bytes, max read {int(lengths.max())}")


def one_card(seed: int) -> None:
    import numpy as np
    from dextractor_tpu.codecs import qv_batch, qv_codec, twobit_codec
    from dextractor_tpu.ops import bitstream_jax, chain_gpu
    from dextractor_tpu.testdata import make_arrow, make_fasta, make_quiva

    calls = Calls((chain_gpu, "plain_chains_gpu"),
                  (chain_gpu, "run_chains_gpu"),
                  (qv_codec, "_encode_entries_device"),
                  (qv_codec, "_encode_entries_native"),
                  (qv_codec, "_decode_entries_device"),
                  (qv_codec, "_walk_native"),
                  (qv_batch, "fused_decode_entries_seg"),
                  (bitstream_jax, "encode_rows_np"),
                  (twobit_codec, "_encode_rows"),
                  (twobit_codec, "_decode_rows"))
    try:
        with phase("kernels", 0, calls):
            check_chain_kernels(seed, n_chains=4096, max_len=2048)
        rng = np.random.default_rng(seed)
        quiva = make_quiva(rng, n_reads=UNIFORM_READS, min_len=READ_MIN,
                           max_len=READ_MAX)
        run_qv_phase("dexqv_uniform", quiva, calls, seg=False)
        quiva = make_quiva(rng, lengths=lognormal_lengths(rng, LONG_PAYLOAD))
        run_qv_phase("dexqv_long", quiva, calls, seg=True, oracle_k=12)
        del quiva
        fasta = make_fasta(rng, n_reads=TWOBIT_READS, min_len=8000,
                           max_len=12000)
        run_twobit_phase("dexta", fasta, calls)
        del fasta
        arrow = make_arrow(rng, n_reads=TWOBIT_READS, min_len=8000,
                           max_len=12000)
        run_twobit_phase("dexar", arrow, calls)
        del arrow
        with tempfile.TemporaryDirectory() as work:
            run_db_phase(rng, calls, work)
    finally:
        calls.close()


# ---------------------------------------------------------------------------
# four cards: the data mesh
# ---------------------------------------------------------------------------

def four_cards(seed: int, n_cards: int) -> None:
    import numpy as np
    import jax
    import jax.numpy as jnp
    from dextractor_tpu.codecs import qv_codec
    from dextractor_tpu.codecs import twobit_codec as tc
    from dextractor_tpu.formats.quiva import parse_quiva
    from dextractor_tpu.formats.ragged import pad_rows, rows_to_flat
    from dextractor_tpu.ops import bitstream_jax as bj, chain_gpu
    from dextractor_tpu.ops import twobit as tb
    from dextractor_tpu.parallel import (
        make_mesh, null_run_luts, sharded_qv_encode, sharded_twobit_decode,
        sharded_twobit_encode)
    from dextractor_tpu.parallel.pipeline import sharded_scan_to_stats
    from dextractor_tpu.testdata import make_fasta, make_quiva
    from dextractor_tpu.formats import fasta as fa

    _need(len(jax.devices()) >= n_cards, f"need {n_cards} cards")
    mesh = make_mesh(n_cards)
    calls = Calls((chain_gpu, "plain_chains_gpu"),
                  (chain_gpu, "run_chains_gpu"))
    try:
        rng = np.random.default_rng(seed)
        quiva = make_quiva(rng, n_reads=UNIFORM_READS, min_len=READ_MIN,
                           max_len=READ_MAX)
        q = parse_quiva(quiva)
        n = q.n_entries
        pad = (-n) % n_cards
        lengths = np.pad(q.lengths.astype(np.int64), (0, pad))
        streams = np.stack([pad_rows(q.streams[s], q.lengths, align=512,
                                     bucket=True) for s in range(5)])
        streams = np.pad(streams, ((0, 0), (0, pad), (0, 0)))
        payload = int(q.lengths.sum()) * 5
        with phase("mesh_scan", payload, calls):
            stats = sharded_scan_to_stats(mesh, streams, lengths)
            ref = qv_codec.scan_quiva(q)
            for f in ("del_hist", "ins_hist", "mrg_hist", "sub_hist",
                      "del_run", "sub_run"):
                _need((getattr(stats, f) == getattr(ref, f)).all(),
                      f"mesh scan: {f} differs from the one-card scan")
            for f in ("del_char", "sub_char", "tot_char"):
                _need(getattr(stats, f) == getattr(ref, f),
                      f"mesh scan: {f} differs")
        coding = qv_codec.create_qvcoding(stats, q.prefix, False)
        with phase("mesh_encode", payload, calls):
            sym = np.stack([bj.scheme_luts(s) for s in (
                coding.del_scheme, coding.ins_scheme, coding.mrg_scheme,
                coding.sub_scheme)])
            run = np.stack([
                bj.scheme_luts(coding.drun_scheme, run=True)
                if coding.drun_scheme else null_run_luts(),
                null_run_luts(), null_run_luts(),
                bj.scheme_luts(coding.srun_scheme, run=True)
                if coding.srun_scheme else null_run_luts()])
            rchars = np.array([coding.del_char, -1, -1, coding.sub_char],
                              np.int32)
            run_on = (coding.drun_scheme is not None,
                      coding.srun_scheme is not None)
            out = sharded_qv_encode(mesh, run_on=run_on)(
                jnp.asarray(streams), jnp.asarray(lengths.astype(np.int32)),
                jnp.asarray(sym), jnp.asarray(run), jnp.asarray(rchars),
                jnp.asarray(tb.NUMBER_BASE_LUT))
            enc_mesh = qv_codec.assemble_from_step(
                out, coding, q.wells, q.begs, q.ends, q.qvs, n)
            enc_host = qv_codec.encode_quiva_to_dexqv(quiva, device=False)
            _same(enc_mesh, enc_host, "mesh encode vs native")
            _same(qv_codec.encode_quiva_to_dexqv(quiva, device=True),
                  enc_host, "one-card encode vs native")
        for name, data in (("mesh_decode_uniform", quiva),
                           ("mesh_decode_long", make_quiva(
                               rng, lengths=lognormal_lengths(
                                   rng, LONG_PAYLOAD)))):
            enc = qv_codec.encode_quiva_to_dexqv(data, device=False)
            with phase(name, len(data), calls):
                dec_mesh = qv_codec.decode_dexqv_to_quiva(enc, device=True,
                                                          mesh=mesh)
                _need(calls.n["plain_chains_gpu"] > 0
                      and calls.n["run_chains_gpu"] > 0,
                      f"{name}: GPU chain kernel not used under shard_map")
                _same(dec_mesh, data, f"{name}: mesh decode vs input")
                _same(qv_codec.decode_dexqv_to_quiva(enc, device=True),
                      dec_mesh, f"{name}: one-card decode vs mesh")
                _same(qv_codec.decode_dexqv_to_quiva(enc, device=False),
                      dec_mesh, f"{name}: native walker vs mesh")
        fasta = make_fasta(rng, n_reads=TWOBIT_READS, min_len=8000,
                           max_len=12000)
        with phase("mesh_twobit", len(fasta), calls):
            f = fa.parse_seq_file(fasta, arrow=False)
            lens = f.seqs.lengths
            rows = pad_rows(f.seqs.flat, lens, align=512, bucket=True)
            npad = (-len(lens)) % n_cards
            rows_p = np.pad(rows, ((0, npad), (0, 0)))
            lens_p = np.pad(lens, (0, npad))
            packed = sharded_twobit_encode(mesh)(
                jnp.asarray(rows_p), jnp.asarray(lens_p),
                jnp.asarray(tb.NUMBER_BASE_LUT))
            packed = np.asarray(packed)[:len(lens)]
            clens = (lens + 3) >> 2
            host, hclens = tc._pack_batch(f.seqs.flat, lens,
                                          tb.NUMBER_BASE_LUT, device=False,
                                          alphabet="base")
            one = np.asarray(tc._encode_rows(
                jnp.asarray(rows), jnp.asarray(lens),
                jnp.asarray(tb.NUMBER_BASE_LUT), alphabet="base"))
            _need((packed == one).all(), "mesh 2-bit encode vs one card")
            _need((rows_to_flat(packed, clens) == host).all(),
                  "mesh 2-bit encode vs native")
            sym = np.asarray(sharded_twobit_decode(mesh)(
                jnp.asarray(np.pad(packed, ((0, npad), (0, 0)))),
                jnp.asarray(tb.LOWER_LUT)))[:len(lens)]
            _need((rows_to_flat(sym, lens) == f.seqs.flat).all(),
                  "mesh 2-bit decode vs input")
    finally:
        calls.close()


# ---------------------------------------------------------------------------
# A/B timings (not a default phase)
# ---------------------------------------------------------------------------

def _time(fn, *args, reps: int = 7) -> float:
    """Median wall time of fn(*args) to completion, after one warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _trace_top_ops(fn, args, outdir: str, top: int = 10):
    """Profile a few calls of fn and return the top device ops by summed
    duration plus the device busy share of the traced window."""
    import glob
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(outdir):
        for _ in range(3):
            jax.block_until_ready(fn(*args))
    paths = sorted(glob.glob(os.path.join(outdir, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        return [], None
    pd = ProfileData.from_file(paths[-1])
    tot = collections.Counter()
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                tot[ev.name] += ev.duration_ns
                spans.append((ev.start_ns, ev.end_ns))
    if not spans:
        return [], None
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return tot.most_common(top), busy / window if window else None


def ab(seed: int) -> dict:
    import numpy as np
    import jax
    import jax.numpy as jnp
    from dextractor_tpu.codecs.qv_batch import (
        build_seg_launch_flat, channel_rects, decode_tables_v2)
    from dextractor_tpu.codecs.qv_codec import (
        _index_checkpoints, _index_native, create_qvcoding, scan_quiva,
        encode_quiva_to_dexqv)
    from dextractor_tpu.formats import dexqv as dqf
    from dextractor_tpu.formats.quiva import parse_quiva
    from dextractor_tpu.formats.ragged import bucket_len, pad_rows
    from dextractor_tpu.ops import bitstream_jax as bj, decode2 as d2
    from dextractor_tpu.ops.twobit import NUMBER_BASE_LUT
    from dextractor_tpu.parallel import qv_encode_step, null_run_luts
    from dextractor_tpu.testdata import make_quiva
    from dextractor_tpu.utils import dispatch

    res = {}
    rng = np.random.default_rng(seed)
    uniform = make_quiva(rng, n_reads=UNIFORM_READS, min_len=READ_MIN,
                         max_len=READ_MAX)
    long_ = make_quiva(rng, lengths=lognormal_lengths(rng, LONG_PAYLOAD))

    # -- decode step: GPU chain kernel vs the XLA chains, same statics ----
    for name, quiva in (("uniform", uniform), ("long", long_)):
        enc = encode_quiva_to_dexqv(quiva, device=False)
        coding, coff = dqf.parse_qvcoding(memoryview(enc), 2)
        idx = _index_native(enc, coding, coff, True)
        eoffs, elens, coffs, ntoks = idx[6], idx[7], idx[8], idx[9]
        buf = np.frombuffer(enc, np.uint8)
        sids, f1, f2, types, del_mode, sub_mode, subw, lmax = \
            decode_tables_v2(coding)
        chan_l2 = tuple(bool(((f1[sids[k]] >> 20) & 1).any())
                        for k in range(6))
        rep = (jnp.asarray(sids), jnp.asarray(f1), jnp.asarray(f2),
               jnp.asarray(types), jnp.int32(coding.del_char & 0xFF),
               jnp.int32(coding.sub_char & 0xFF))
        ck = _index_checkpoints(enc, coding, coff, True, idx)
        if ck is None:
            max_len = bucket_len(int(elens.max()), 512)
            rects = channel_rects(buf, eoffs, coffs, max_len)
            args = tuple(jnp.asarray(r) for r in rects) + (
                jnp.asarray(elens.astype(np.int32)),) + rep
            statics = dict(max_len=max_len,
                           max_tokens=bucket_len(int(ntoks.max()), 16),
                           del_mode=del_mode, sub_mode=sub_mode, subw=subw,
                           lmax=lmax, chan_l2=chan_l2,
                           max_sym=bucket_len(int(elens.max())))
            step = d2.decode_entry_batch2
        else:
            sargs, statics, _, _ = build_seg_launch_flat(
                buf, eoffs, elens.astype(np.int32), coffs, ntoks, coding, ck)
            args = tuple(jnp.asarray(a) for a in sargs) + rep
            statics.update(subw=subw, lmax=lmax, chan_l2=chan_l2)
            step = d2.decode_entry_batch_seg
        fns = {k: jax.jit(lambda *a, k=k: step(*a, kernel=k, **statics))
               for k in (dispatch.chain_kernel(), None)}
        for kern, fn in fns.items():
            res[f"decode_step_{name}_{kern or 'xla'}_ms"] = \
                1e3 * _time(fn, *args)
        _need((np.asarray(fns[None](*args))
               == np.asarray(fns[dispatch.chain_kernel()](*args))).all(),
              f"A/B {name}: kernel and XLA decode steps differ")
        res[f"decode_step_{name}_payload_bytes"] = int(elens.sum()) * 5
        top, busy = _trace_top_ops(fns[dispatch.chain_kernel()], args,
                                   os.path.join(TRACES, f"decode_{name}"))
        res[f"decode_step_{name}_device_busy_share"] = busy
        res[f"decode_step_{name}_top_ops_ms"] = [(k[:80], v / 3e6)
                                                 for k, v in top]

    # -- XLA encode step: time and top trace ops --------------------------
    q = parse_quiva(uniform)
    stats = scan_quiva(q)
    coding = create_qvcoding(stats, q.prefix, False)
    streams = np.stack([pad_rows(q.streams[s], q.lengths, align=512,
                                 bucket=True) for s in range(5)])
    sym = np.stack([bj.scheme_luts(s) for s in (
        coding.del_scheme, coding.ins_scheme, coding.mrg_scheme,
        coding.sub_scheme)])
    run = np.stack([bj.scheme_luts(coding.drun_scheme, run=True)
                    if coding.drun_scheme else null_run_luts(),
                    null_run_luts(), null_run_luts(),
                    bj.scheme_luts(coding.srun_scheme, run=True)
                    if coding.srun_scheme else null_run_luts()])
    rchars = np.array([coding.del_char, -1, -1, coding.sub_char], np.int32)
    run_on = (coding.drun_scheme is not None, coding.srun_scheme is not None)
    eargs = (jnp.asarray(streams), jnp.asarray(q.lengths.astype(np.int32)),
             jnp.asarray(sym), jnp.asarray(run), jnp.asarray(rchars),
             jnp.asarray(NUMBER_BASE_LUT))
    enc_step = jax.jit(lambda *a: qv_encode_step(*a, run_on=run_on))
    res["encode_step_uniform_ms"] = 1e3 * _time(enc_step, *eargs)
    res["encode_step_payload_bytes"] = int(q.lengths.sum()) * 5
    top, busy = _trace_top_ops(enc_step, eargs,
                               os.path.join(TRACES, "encode"))
    res["encode_step_device_busy_share"] = busy
    res["encode_step_top_ops_ms"] = [(k[:80], v / 3e6) for k, v in top]
    return res


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--ab", action="store_true",
                    help="time the GPU kernels against plain XLA instead")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        import dextractor_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the dextractor_tpu package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform})",
              file=sys.stderr)
        return 1
    log(f"devices: {len(devs)} x {devs[0].device_kind}")
    from dextractor_tpu.utils import dispatch

    _need(dispatch.chain_kernel() == "gpu",
          "dispatch did not pick the GPU chain kernel")
    t0 = time.perf_counter()
    if args.ab:
        res = ab(args.seed)
        for k, v in res.items():
            log(f"ab {k}: {v}")
    elif args.cards == 4:
        four_cards(args.seed, 4)
    else:
        one_card(args.seed)
    log(f"total: {time.perf_counter() - t0:.3f} s")
    log(f"nvidia-smi: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
