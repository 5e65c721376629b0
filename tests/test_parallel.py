"""Sharded pipeline: 8-virtual-device CPU mesh must reproduce the
single-device encode and the file-global histograms exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import make_quiva

from dextractor_tpu.formats.quiva import parse_quiva
from dextractor_tpu.formats.ragged import pad_rows
from dextractor_tpu.codecs.qv_codec import scan_quiva, create_qvcoding
from dextractor_tpu.ops import bitstream_jax as bj
from dextractor_tpu.parallel import (
    make_mesh, qv_encode_step, sharded_qv_encode, sharded_qv_scan,
    null_run_luts,
)


def _prep(quiva_bytes, n_pad_to=None):
    q = parse_quiva(quiva_bytes)
    n = q.n_entries
    lengths = q.lengths.astype(np.int64)
    rects = [pad_rows(q.streams[s], lengths, align=512, bucket=True)
             for s in range(5)]
    streams = np.stack(rects)
    if n_pad_to and n_pad_to != n:
        pad = n_pad_to - n
        streams = np.concatenate(
            [streams, np.zeros((5, pad, streams.shape[2]), np.uint8)], axis=1)
        lengths = np.concatenate([lengths, np.zeros(pad, np.int64)])
    return q, streams, lengths


def _luts(coding):
    sym = np.stack([
        bj.scheme_luts(coding.del_scheme),
        bj.scheme_luts(coding.ins_scheme),
        bj.scheme_luts(coding.mrg_scheme),
        bj.scheme_luts(coding.sub_scheme),
    ])
    run = np.stack([
        bj.scheme_luts(coding.drun_scheme, run=True) if coding.drun_scheme else null_run_luts(),
        null_run_luts(),
        null_run_luts(),
        bj.scheme_luts(coding.srun_scheme, run=True) if coding.srun_scheme else null_run_luts(),
    ])
    rchars = np.array([coding.del_char, -1, -1, coding.sub_char], np.int32)
    return sym, run, rchars


def test_sharded_encode_matches_single():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    rng = np.random.default_rng(0)
    quiva = make_quiva(rng, n_reads=24, min_len=0, max_len=300)
    q, streams, lengths = _prep(quiva, n_pad_to=24)
    stats = scan_quiva(q)
    coding = create_qvcoding(stats, q.prefix, False)
    sym, run, rchars = _luts(coding)

    from dextractor_tpu.ops.twobit import NUMBER_BASE_LUT
    args = (jnp.asarray(streams), jnp.asarray(lengths.astype(np.int32)),
            jnp.asarray(sym), jnp.asarray(run), jnp.asarray(rchars),
            jnp.asarray(NUMBER_BASE_LUT))

    single = qv_encode_step(*args)

    mesh = make_mesh(8)
    sharded = sharded_qv_encode(mesh)(*args)
    for a, b in zip(single, sharded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sharded_scan_matches_host():
    rng = np.random.default_rng(1)
    quiva = make_quiva(rng, n_reads=16, min_len=1, max_len=400)
    q, streams, lengths = _prep(quiva, n_pad_to=16)
    stats = scan_quiva(q)

    mesh = make_mesh(8)
    hists, tot, winner, gentry, dchar = sharded_qv_scan(mesh)(
        jnp.asarray(streams), jnp.asarray(lengths.astype(np.int32)))
    hists = np.asarray(hists)
    np.testing.assert_array_equal(hists[0], stats.del_hist)
    np.testing.assert_array_equal(hists[1], stats.ins_hist)
    np.testing.assert_array_equal(hists[2], stats.mrg_hist)
    np.testing.assert_array_equal(hists[3], stats.sub_hist)
    assert int(tot) == stats.tot_char
    assert int(dchar) == stats.del_char


def test_ordered_gather_and_ranges():
    from dextractor_tpu.parallel.multihost import ordered_gather, process_read_range
    parts = [
        (np.array([1, 2, 3], np.uint8), np.array([2, 1], np.int64)),
        (np.array([4, 5], np.uint8), np.array([2], np.int64)),
    ]
    flat, lengths, offsets = ordered_gather(parts)
    np.testing.assert_array_equal(flat, [1, 2, 3, 4, 5])
    np.testing.assert_array_equal(offsets, [0, 2, 3, 5])
    beg, end = process_read_range(100, process_id=1, num_processes=3)
    assert (beg, end) == (34, 68)
    assert process_read_range(100, 2, 3) == (68, 100)


def test_profiling_reporter():
    import io
    from dextractor_tpu.utils.profiling import Reporter
    r = Reporter(enabled=True)
    with r.stage("pack", nbytes=1000):
        pass
    with r.stage("pack", nbytes=1000):
        pass
    buf = io.StringIO()
    r.report(buf)
    assert "pack" in buf.getvalue()
    assert r.stages["pack"].calls == 2


def test_sharded_scan_to_stats_exact():
    """The fully sharded phase-A scan must reproduce the sequential scan's
    QVStats exactly — including delChar/subChar discovery entries and run
    histograms (one 256-entry difference would change the stream format)."""
    from dextractor_tpu.parallel.pipeline import sharded_scan_to_stats

    rng = np.random.default_rng(7)
    # enough chars to cross both the 100k subChar threshold and, with
    # sub_heavy, the 50% modal test
    quiva = make_quiva(rng, n_reads=64, min_len=1800, max_len=2200,
                       sub_heavy=True)
    q, streams, lengths = _prep(quiva, n_pad_to=64)
    host_stats = scan_quiva(q)

    mesh = make_mesh(8)
    stats = sharded_scan_to_stats(mesh, jnp.asarray(streams),
                                  jnp.asarray(lengths.astype(np.int32)))
    np.testing.assert_array_equal(stats.del_hist, host_stats.del_hist)
    np.testing.assert_array_equal(stats.ins_hist, host_stats.ins_hist)
    np.testing.assert_array_equal(stats.mrg_hist, host_stats.mrg_hist)
    np.testing.assert_array_equal(stats.sub_hist, host_stats.sub_hist)
    np.testing.assert_array_equal(stats.del_run, host_stats.del_run)
    np.testing.assert_array_equal(stats.sub_run, host_stats.sub_run)
    assert stats.del_char == host_stats.del_char
    assert stats.sub_char == host_stats.sub_char
    assert stats.tot_char == host_stats.tot_char

    # and the codings built from them are identical byte-for-byte
    from dextractor_tpu.formats.dexqv import qvcoding_bytes
    a = create_qvcoding(host_stats, q.prefix, False)
    b = create_qvcoding(stats, q.prefix, False)
    assert qvcoding_bytes(a) == qvcoding_bytes(b)


def test_sharded_scan_to_stats_nondivisible():
    """n=17 reads on 8 shards: the scan must pad internally and still locate
    the delChar discovery entry exactly (a mislocated entry changes the run
    histogram and hence the stream format)."""
    from dextractor_tpu.parallel.pipeline import sharded_scan_to_stats

    rng = np.random.default_rng(9)
    quiva = make_quiva(rng, n_reads=17, min_len=200, max_len=600)
    q, streams, lengths = _prep(quiva)
    host_stats = scan_quiva(q)

    mesh = make_mesh(8)
    stats = sharded_scan_to_stats(mesh, jnp.asarray(streams),
                                  jnp.asarray(lengths.astype(np.int32)))
    np.testing.assert_array_equal(stats.del_run, host_stats.del_run)
    np.testing.assert_array_equal(stats.sub_run, host_stats.sub_run)
    np.testing.assert_array_equal(stats.del_hist, host_stats.del_hist)
    assert stats.del_char == host_stats.del_char
    assert stats.sub_char == host_stats.sub_char
    assert stats.tot_char == host_stats.tot_char


def test_sharded_encode_produces_identical_container(ref_tools, tmp_path):
    """Distributed phase A + phase B + host assembly == the C encoder's file."""
    from conftest import run_ref
    from dextractor_tpu.parallel.pipeline import sharded_scan_to_stats
    from dextractor_tpu.codecs.qv_codec import assemble_from_step
    from dextractor_tpu.ops.twobit import NUMBER_BASE_LUT

    rng = np.random.default_rng(8)
    quiva = make_quiva(rng, n_reads=24, min_len=200, max_len=600)
    (tmp_path / "g.quiva").write_bytes(quiva)
    run_ref(ref_tools, "dexqv", ["-k", "g.quiva"], tmp_path)
    ref_dexqv = (tmp_path / "g.dexqv").read_bytes()

    q, streams, lengths = _prep(quiva, n_pad_to=24)
    mesh = make_mesh(8)
    streams_d = jnp.asarray(streams)
    lengths_d = jnp.asarray(lengths.astype(np.int32))

    stats = sharded_scan_to_stats(mesh, streams_d, lengths_d)
    coding = create_qvcoding(stats, q.prefix, False)
    sym, run, rchars = _luts(coding)

    out = sharded_qv_encode(mesh)(
        streams_d, lengths_d, jnp.asarray(sym), jnp.asarray(run),
        jnp.asarray(rchars), jnp.asarray(NUMBER_BASE_LUT))
    ours = assemble_from_step(out, coding, q.wells, q.begs, q.ends, q.qvs,
                              q.n_entries)
    assert ours == ref_dexqv


def test_encode_step_run_routing_specialization(ref_tools, tmp_path):
    """run_on=(real flags) routes no-run-scheme channels through the
    plain kernel (half the slots); bytes must equal the default routing
    AND the C encoder (QV.c:1393-1423 encodes such channels plain)."""
    from dextractor_tpu.codecs.qv_codec import assemble_from_step
    from dextractor_tpu.ops.twobit import NUMBER_BASE_LUT
    from conftest import run_ref

    rng = np.random.default_rng(21)
    quiva = make_quiva(rng, n_reads=24, min_len=200, max_len=600)
    (tmp_path / "g.quiva").write_bytes(quiva)
    run_ref(ref_tools, "dexqv", ["-k", "g.quiva"], tmp_path)
    ref_dexqv = (tmp_path / "g.dexqv").read_bytes()

    q, streams, lengths = _prep(quiva, n_pad_to=24)
    stats = scan_quiva(q)
    coding = create_qvcoding(stats, q.prefix, False)
    sym, run, rchars = _luts(coding)
    flags = (coding.drun_scheme is not None, coding.srun_scheme is not None)
    assert not flags[1], "test premise: synthetic subQV has no run scheme"

    args = (jnp.asarray(streams), jnp.asarray(lengths.astype(np.int32)),
            jnp.asarray(sym), jnp.asarray(run), jnp.asarray(rchars),
            jnp.asarray(NUMBER_BASE_LUT))
    for run_on in ((True, True), flags, (False, False) if not any(flags)
                   else flags):
        out = qv_encode_step(*args, run_on=run_on)
        ours = assemble_from_step(out, coding, q.wells, q.begs, q.ends,
                                  q.qvs, q.n_entries)
        assert ours == ref_dexqv, f"run_on={run_on}"

    mesh = make_mesh(8)
    out = sharded_qv_encode(mesh, run_on=flags)(*args)
    ours = assemble_from_step(out, coding, q.wells, q.begs, q.ends,
                              q.qvs, q.n_entries)
    assert ours == ref_dexqv


def test_sharded_twobit_matches_single_device():
    """Sharded 2-bit pack/unpack == the single-device kernels (and the
    NumPy oracle) on ragged rows; zero collectives in the program."""
    from dextractor_tpu.parallel import (
        make_mesh, sharded_twobit_encode, sharded_twobit_decode)
    from dextractor_tpu.ops import twobit as tb

    rng = np.random.default_rng(17)
    n, L = 16, 96
    lens = rng.integers(0, L + 1, n).astype(np.int64)
    rows = np.zeros((n, L), np.uint8)
    for i, l in enumerate(lens):
        rows[i, :l] = rng.integers(0, 4, l)
    ascii_rows = np.frombuffer(b"acgt", np.uint8)[rows]
    nlut = np.zeros(256, np.uint8)
    for k, ch in enumerate(b"acgt"):
        nlut[ch] = k

    mesh = make_mesh(8)
    packed = np.asarray(sharded_twobit_encode(mesh)(
        jnp.asarray(ascii_rows), jnp.asarray(lens), jnp.asarray(nlut)))
    exp = tb.pack_2bit_np(rows, lens)
    np.testing.assert_array_equal(packed, exp)

    sym = np.asarray(sharded_twobit_decode(mesh)(
        jnp.asarray(packed), jnp.frombuffer(b"acgt", np.uint8)))
    for i, l in enumerate(lens):
        np.testing.assert_array_equal(sym[i, :l], ascii_rows[i, :l])


def test_sharded_conveyor_decode_matches_single(monkeypatch):
    """The GPU chain kernel (interpret mode on CPU) must produce identical
    decode output per shard under shard_map as single-device.  Covers the
    raw-container fused path; the next test covers the multi-coding DB
    path."""
    from conftest import make_quiva
    from dextractor_tpu.utils import dispatch
    from dextractor_tpu.codecs.qv_codec import (
        encode_quiva_to_dexqv, decode_dexqv_to_quiva)

    rng = np.random.default_rng(17)
    quiva = make_quiva(rng, n_reads=17, min_len=5, max_len=120)
    enc = encode_quiva_to_dexqv(quiva, device=False)

    monkeypatch.setattr(dispatch, "chain_kernel", lambda: "interpret")
    mesh = make_mesh(8)
    single = decode_dexqv_to_quiva(enc, device=True)
    sharded = decode_dexqv_to_quiva(enc, device=True, mesh=mesh)
    assert single == quiva
    assert sharded == quiva


def test_sharded_conveyor_db_decode_matches_single(monkeypatch):
    """Multi-coding batch decode (qv_batch.batch_decode_entries) through
    the shard_map'd GPU chain kernel — two codings, mixed schemes per
    read — equal to single-device and to the XLA chains."""
    from conftest import make_quiva
    from dextractor_tpu.utils import dispatch
    from dextractor_tpu.formats import dexqv as dqf
    from dextractor_tpu.codecs.qv_codec import (
        encode_quiva_to_dexqv, _index_native)
    from dextractor_tpu.codecs.qv_batch import batch_decode_entries

    rng = np.random.default_rng(23)
    quiva_a = make_quiva(rng, n_reads=9, min_len=5, max_len=100)
    quiva_b = make_quiva(rng, n_reads=8, min_len=5, max_len=100,
                         del_run=False)
    parts = []
    for q in (quiva_a, quiva_b):
        enc = encode_quiva_to_dexqv(q, device=False)
        coding, coff = dqf.parse_qvcoding(memoryview(enc), 2)
        res = _index_native(enc, coding, coff, True)
        if res is None:
            pytest.skip("native shim unavailable")
        eoffs, elens = res[6], res[7]
        parts.append((np.frombuffer(enc, np.uint8), eoffs,
                      elens.astype(np.int32), coding))

    # concatenate the two containers into one logical batch
    off = len(parts[0][0])
    buf = np.concatenate([parts[0][0], parts[1][0]])
    starts = np.concatenate([parts[0][1], parts[1][1] + off])
    rlens = np.concatenate([parts[0][2], parts[1][2]])
    codings = [parts[0][3], parts[1][3]]
    table = np.concatenate([np.zeros(len(parts[0][1]), np.int64),
                            np.ones(len(parts[1][1]), np.int64)])

    rows_xla, _ = batch_decode_entries(buf, starts, rlens, codings, table)
    monkeypatch.setattr(dispatch, "chain_kernel", lambda: "interpret")
    rows_single, _ = batch_decode_entries(buf, starts, rlens, codings, table)
    np.testing.assert_array_equal(np.asarray(rows_single),
                                  np.asarray(rows_xla))
    mesh = make_mesh(8)
    rows_sharded, _ = batch_decode_entries(buf, starts, rlens, codings,
                                           table, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(rows_single),
                                  np.asarray(rows_sharded))


def test_sharded_seg_decode_matches_single(monkeypatch):
    """Checkpoint-segmented decode under shard_map: segments shard like
    reads (round-3 left fused_decode_entries_seg single-device — under a
    mesh long reads silently fell back to per-read chains).  Small
    seg=256 so a modest batch has true multi-segment reads; the GPU
    chain kernel in interpret mode on the CPU mesh; read count NOT a device multiple so the
    dead-read padding path is exercised."""
    from conftest import make_quiva
    from dextractor_tpu.utils import dispatch
    from dextractor_tpu.formats import dexqv as dqf
    from dextractor_tpu.codecs.qv_codec import (
        encode_quiva_to_dexqv, _index_native, _index_checkpoints)
    from dextractor_tpu.codecs.qv_batch import fused_decode_entries_seg

    rng = np.random.default_rng(41)
    quiva = make_quiva(rng, n_reads=11, min_len=0, max_len=1500,
                       sub_heavy=True)
    enc = encode_quiva_to_dexqv(quiva, device=False)
    coding, coff = dqf.parse_qvcoding(memoryview(enc), 2)
    idx = _index_native(enc, coding, coff, True)
    if idx is None:
        pytest.skip("native shim unavailable")
    _, _, _, _, _, _, eoffs, elens, coffs, ntoks = idx
    ck = _index_checkpoints(enc, coding, coff, True, idx, seg=256)
    assert ck is not None
    buf = np.frombuffer(enc, np.uint8)
    monkeypatch.setattr(dispatch, "chain_kernel", lambda: "interpret")
    single = np.asarray(fused_decode_entries_seg(
        buf, eoffs, elens.astype(np.int32), coffs, ntoks, coding, ck))
    mesh = make_mesh(8)
    sharded = np.asarray(fused_decode_entries_seg(
        buf, eoffs, elens.astype(np.int32), coffs, ntoks, coding, ck,
        mesh=mesh))
    np.testing.assert_array_equal(single, sharded)


def test_sharded_long_read_container_roundtrip(monkeypatch):
    """End-to-end: decode_dexqv_to_quiva with a mesh on a long-read mix
    now routes through the sharded segmented step (the mesh gate is
    gone) and stays byte-exact."""
    from conftest import make_quiva
    from dextractor_tpu.codecs import qv_codec
    from dextractor_tpu.codecs.qv_codec import (
        encode_quiva_to_dexqv, decode_dexqv_to_quiva)
    from dextractor_tpu.codecs import qv_batch

    rng = np.random.default_rng(43)
    quiva = make_quiva(rng, n_reads=10, min_len=0, max_len=6000)
    enc = encode_quiva_to_dexqv(quiva, device=False)

    calls = []
    orig = qv_batch.fused_decode_entries_seg

    def spy(*a, **k):
        calls.append(k.get("mesh"))
        return orig(*a, **k)

    monkeypatch.setattr(qv_batch, "fused_decode_entries_seg", spy)
    mesh = make_mesh(8)
    assert decode_dexqv_to_quiva(enc, device=True, mesh=mesh) == quiva
    assert calls and all(m is mesh for m in calls)
