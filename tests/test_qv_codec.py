"""Golden tests for the .dexqv codec against the reference C tools."""

import numpy as np
import pytest

from conftest import make_quiva, run_ref

from dextractor_tpu.codecs.qv_codec import (
    encode_quiva_to_dexqv,
    decode_dexqv_to_quiva,
)
from dextractor_tpu.utils.errors import FormatError
from dextractor_tpu.ops import bitstream as bs
from dextractor_tpu.ops.huffman import make_scheme, HScheme, build_lookup


# ---------------------------------------------------------------------------
# bitstream engine unit tests
# ---------------------------------------------------------------------------

def _roundtrip_stream(data, hist=None):
    data = np.asarray(data, np.uint8)
    if hist is None:
        hist = np.bincount(data, minlength=256).astype(np.int64)
    scheme = make_scheme(hist)
    words = bs.encode_stream(scheme, data)
    buf = np.frombuffer(words.tobytes(), np.uint8)
    rd = bs.BitReader(buf, 0)
    out, consumed = bs.decode_stream(scheme, rd, len(data))
    assert consumed == len(words), (consumed, len(words))
    np.testing.assert_array_equal(out, data)


def test_bitstream_roundtrip_simple():
    # NB: a histogram with a single distinct symbol yields a zero-length code
    # in the reference too (Huffman of one leaf, QV.c:183-201) and cannot
    # roundtrip there either — streams here always carry >= 2 symbols.
    rng = np.random.default_rng(0)
    for n in [2, 3, 31, 32, 33, 100, 1000]:
        data = rng.integers(60, 80, size=n).astype(np.uint8)
        data[0] = 59
        _roundtrip_stream(data)


def test_bitstream_roundtrip_skewed():
    rng = np.random.default_rng(1)
    # geometric-ish distribution exercises long codes / escapes
    data = np.minimum((rng.exponential(2.0, size=5000)).astype(np.int64), 255)
    hist = np.bincount(data, minlength=256).astype(np.int64)
    hist[hist == 0] = 0
    _roundtrip_stream(data.astype(np.uint8), hist)


def test_bitstream_escape_type2():
    # force a type-2 scheme: >64 distinct symbols with extreme skew
    rng = np.random.default_rng(2)
    common = np.zeros(20000, np.int64)
    rare = np.arange(200) + 1
    data = np.concatenate([common, np.repeat(rare, 1)]).astype(np.uint8)
    rng.shuffle(data)
    hist = np.bincount(data, minlength=256).astype(np.int64)
    scheme = make_scheme(hist)
    _roundtrip_stream(data, hist)


def test_run_stream_roundtrip():
    rng = np.random.default_rng(3)
    rchar = 70
    for n in [5, 100, 2000]:
        data = np.full(n, rchar, np.uint8)
        breaks = rng.random(n) < 0.2
        data[breaks] = rng.integers(33, 60, size=int(breaks.sum())).astype(np.uint8)
        data[0] = 33               # guarantee >= 2 distinct literal symbols
        data[1] = 34
        nhist = np.bincount(data[data != rchar], minlength=256).astype(np.int64)
        runlens, _, _ = bs.tokenize_runs(data, rchar)
        rhist = np.ones(256, np.int64)
        rhist += np.bincount(np.minimum(runlens, 255), minlength=256)
        neme, reme = make_scheme(nhist), make_scheme(rhist)
        words = bs.encode_run_stream(neme, reme, data, rchar)
        buf = np.frombuffer(words.tobytes(), np.uint8)
        rd = bs.BitReader(buf, 0)
        out, consumed = bs.decode_run_stream(neme, reme, rd, n, rchar)
        assert consumed == len(words)
        np.testing.assert_array_equal(out, data)


def test_long_run_escape():
    # runs >= 255 take the 255 escape with a 16-bit literal
    data = np.full(1000, 70, np.uint8)
    data[990] = 40
    nhist = np.zeros(256, np.int64)
    nhist[40] = 1
    nhist[41] = 1
    runlens, _, _ = bs.tokenize_runs(data, 70)
    rhist = np.ones(256, np.int64) + np.bincount(np.minimum(runlens, 255), minlength=256)
    neme, reme = make_scheme(nhist), make_scheme(rhist)
    words = bs.encode_run_stream(neme, reme, data, 70)
    buf = np.frombuffer(words.tobytes(), np.uint8)
    out, consumed = bs.decode_run_stream(neme, reme, bs.BitReader(buf, 0), 1000, 70)
    assert consumed == len(words)
    np.testing.assert_array_equal(out, data)


# ---------------------------------------------------------------------------
# golden byte-identity vs the C tools
# ---------------------------------------------------------------------------

QCASES = [
    dict(n_reads=12, min_len=0, max_len=400),                     # small, delChar found
    dict(n_reads=12, min_len=0, max_len=400, del_run=False),      # no delChar
    dict(n_reads=60, min_len=1500, max_len=2500, sub_heavy=True),  # subChar active (>200k)
    dict(n_reads=30, min_len=3000, max_len=4000, spread=90),      # big alphabet, escapes
]


@pytest.mark.parametrize("case", range(len(QCASES)))
@pytest.mark.parametrize("lossy", [False, True])
def test_dexqv_golden(case, lossy, ref_tools, tmp_path):
    rng = np.random.default_rng(300 + case)
    quiva = make_quiva(rng, **QCASES[case])
    (tmp_path / "g.quiva").write_bytes(quiva)
    args = ["-k", "-l", "g.quiva"] if lossy else ["-k", "g.quiva"]
    run_ref(ref_tools, "dexqv", args, tmp_path)
    ref_dexqv = (tmp_path / "g.dexqv").read_bytes()

    # batched device path and per-entry host path must both be byte-identical
    ours = encode_quiva_to_dexqv(quiva, lossy=lossy, device=True)
    assert ours == ref_dexqv, (
        f"device-encoded .dexqv differs from reference "
        f"(ours {len(ours)}B vs ref {len(ref_dexqv)}B)")
    ours_host = encode_quiva_to_dexqv(quiva, lossy=lossy, device=False)
    assert ours_host == ref_dexqv

    run_ref(ref_tools, "undexqv", ["-k", "g.dexqv"], tmp_path)
    ref_quiva = (tmp_path / "g.quiva").read_bytes()
    assert decode_dexqv_to_quiva(ref_dexqv) == ref_quiva


def test_dexqv_roundtrip_no_oracle():
    rng = np.random.default_rng(42)
    quiva = make_quiva(rng, n_reads=10, max_len=200)
    enc = encode_quiva_to_dexqv(quiva)
    assert decode_dexqv_to_quiva(enc) == quiva


def test_native_and_python_decode_agree(ref_tools, tmp_path):
    rng = np.random.default_rng(777)
    from conftest import make_quiva
    quiva = make_quiva(rng, n_reads=20, min_len=0, max_len=500)
    enc = encode_quiva_to_dexqv(quiva)
    a = decode_dexqv_to_quiva(enc, native=True)
    b = decode_dexqv_to_quiva(enc, native=False)
    assert a == b == quiva
    au = decode_dexqv_to_quiva(enc, upper=True, native=True)
    bu = decode_dexqv_to_quiva(enc, upper=True, native=False)
    assert au == bu


def test_raw_container_device_decode():
    """Raw .dexqv through the batch device decoder (native lens-only walk for
    boundaries + parallel stream chains) must equal the sequential walk."""
    rng = np.random.default_rng(55)
    quiva = make_quiva(rng, n_reads=24, min_len=0, max_len=500)
    enc = encode_quiva_to_dexqv(quiva)
    assert decode_dexqv_to_quiva(enc, device=True) == quiva
    assert decode_dexqv_to_quiva(enc, device=True, upper=True) == \
        decode_dexqv_to_quiva(enc, native=True, upper=True)


def test_raw_container_device_decode_sharded():
    """The shard_map'd decode over an 8-device mesh must be identical —
    reads are independent chains (n=21 exercises the pad path)."""
    from dextractor_tpu.parallel import make_mesh

    rng = np.random.default_rng(56)
    quiva = make_quiva(rng, n_reads=21, min_len=1, max_len=400,
                       sub_heavy=True)
    enc = encode_quiva_to_dexqv(quiva)
    mesh = make_mesh(8)
    assert decode_dexqv_to_quiva(enc, device=True, mesh=mesh) == quiva


def test_raw_container_device_decode_edge_cases():
    """Fused device decode across the hard stream shapes: plain del
    channel, heavy runs (>=255 escapes), type-2 escape schemes from a
    large skewed file."""
    cases = [
        dict(n_reads=10, min_len=0, max_len=300, del_run=False),
        dict(n_reads=6, min_len=600, max_len=900, spread=2),
        dict(n_reads=120, min_len=900, max_len=1100, sub_heavy=True),
    ]
    for i, kw in enumerate(cases):
        rng = np.random.default_rng(60 + i)
        quiva = make_quiva(rng, **kw)
        enc = encode_quiva_to_dexqv(quiva)
        assert decode_dexqv_to_quiva(enc, device=True) == quiva, kw


def test_native_walker_read_over_1mb():
    """PacBio reads exceed 1 Mbp; the native walker's lens-only pass must
    not cap the delQV scratch at a fixed size."""
    rng = np.random.default_rng(31)
    quiva = make_quiva(rng, n_reads=1, min_len=(1 << 20) + 4097,
                       max_len=(1 << 20) + 4097)
    enc = encode_quiva_to_dexqv(quiva)
    assert decode_dexqv_to_quiva(enc, native=True) == quiva


def test_dexqv_golden_large_type2_runscheme(ref_tools, tmp_path):
    """Large file: the delRun histogram grows >16-bit codes, forcing a
    type-2 RUN scheme whose merged buckets must escape exactly like the
    reference (Encode_Run tests code==255's-code unconditionally)."""
    rng = np.random.default_rng(4242)
    quiva = make_quiva(rng, n_reads=500, min_len=1900, max_len=2100)
    (tmp_path / "g.quiva").write_bytes(quiva)
    run_ref(ref_tools, "dexqv", ["-k", "g.quiva"], tmp_path)
    ref_dexqv = (tmp_path / "g.dexqv").read_bytes()
    assert encode_quiva_to_dexqv(quiva, device=True) == ref_dexqv
    assert decode_dexqv_to_quiva(ref_dexqv) == quiva


def test_legacy_dexqv_no_container_key(ref_tools, tmp_path):
    """Legacy .dexqv files lack the 0x55aa container key and use uint16
    entry fields (undexqv.c:103-110, 155-180)."""
    import struct
    from dextractor_tpu.formats.quiva import parse_quiva
    from dextractor_tpu.formats import dexqv as dq
    from dextractor_tpu.codecs.qv_codec import (
        scan_quiva, create_qvcoding, encode_entry, DEL, TAG, INS, MRG, SUB)

    rng = np.random.default_rng(606)
    quiva = make_quiva(rng, n_reads=6, min_len=1, max_len=150)
    q = parse_quiva(quiva)
    coding = create_qvcoding(scan_quiva(q), q.prefix, False)

    out = bytearray()
    out += dq.qvcoding_bytes(coding)          # no container key
    off = np.zeros(q.n_entries + 1, np.int64)
    np.cumsum(q.lengths, out=off[1:])
    lwell = 0
    for i in range(q.n_entries):
        s, e = off[i], off[i + 1]
        d = int(q.wells[i]) - lwell
        while d >= 255:
            out.append(0xFF)
            d -= 255
        out.append(d)
        lwell = int(q.wells[i])
        out += struct.pack("<HHH", int(q.begs[i]), int(q.ends[i]), int(q.qvs[i]))
        out += encode_entry(coding, q.streams[DEL, s:e], q.streams[TAG, s:e],
                            q.streams[INS, s:e], q.streams[MRG, s:e],
                            q.streams[SUB, s:e], False)

    (tmp_path / "g.dexqv").write_bytes(bytes(out))
    run_ref(ref_tools, "undexqv", ["-k", "g.dexqv"], tmp_path)
    ref_quiva = (tmp_path / "g.quiva").read_bytes()
    assert decode_dexqv_to_quiva(bytes(out)) == ref_quiva
    # native and python walkers agree on legacy too
    assert decode_dexqv_to_quiva(bytes(out), native=False) == ref_quiva


def test_dexqv_golden_well_jumps(ref_tools, tmp_path):
    """Well deltas >= 255 take 0xff escape bytes in .dexqv entry headers."""
    rng = np.random.default_rng(909)
    from conftest import make_quiva
    quiva = make_quiva(rng, n_reads=10, min_len=5, max_len=120)
    # rewrite headers with jumping well numbers
    lines = quiva.split(b"\n")
    well = 0
    out = []
    for i, l in enumerate(lines):
        if l.startswith(b"@"):
            well += int(rng.integers(200, 700))
            pre, rest = l.split(b"/", 1)
            _, tail = rest.split(b"/", 1)
            out.append(pre + b"/%d/" % well + tail)
        else:
            out.append(l)
    quiva = b"\n".join(out)
    (tmp_path / "g.quiva").write_bytes(quiva)
    run_ref(ref_tools, "dexqv", ["-k", "g.quiva"], tmp_path)
    ref = (tmp_path / "g.dexqv").read_bytes()
    assert encode_quiva_to_dexqv(quiva, device=True) == ref
    assert encode_quiva_to_dexqv(quiva, device=False) == ref
    assert decode_dexqv_to_quiva(ref) == quiva


def test_corrupt_rlen_rejected_without_huge_alloc():
    """A flipped int32 end field must raise FormatError, not drive the
    grow-on-overflow decode buffer into hundred-GiB allocations."""
    rng = np.random.default_rng(3)
    q = make_quiva(rng, n_reads=5, min_len=50, max_len=100)
    enc = bytearray(encode_quiva_to_dexqv(q, device=False))
    # find the first entry's end field: after container key + coding,
    # entry = well byte + <iii>; corrupt the high byte of `end`
    from dextractor_tpu.formats import dexqv as dqf
    _, coff = dqf.parse_qvcoding(memoryview(bytes(enc)), 2)
    enc[coff + 1 + 7] = 0x7F                 # end ~ 2^30
    with pytest.raises(FormatError):
        decode_dexqv_to_quiva(bytes(enc), device=False)


# ---------------------------------------------------------------------------
# native encoder defensive fallbacks: schemes beyond the pair-table bounds
# (foreign files; self-built schemes stay <= HUFF_CUTOFF=16) must route
# through the exact scalar emitter, matching the Python oracle bit for bit
# ---------------------------------------------------------------------------

def _unary_scheme(max_len: int, stype: int = 0):
    """Prefix-free unary-ish scheme: symbol k -> 1^k 0, len k+1 (k < max)."""
    from dextractor_tpu.ops.huffman import HScheme
    lens = np.zeros(256, np.int32)
    bits = np.zeros(256, np.uint32)
    for k in range(max_len):
        lens[k] = k + 1
        bits[k] = ((1 << k) - 1) << 1
    return HScheme(stype, lens, bits)


def _shim_ptr(a):
    import ctypes
    return a.ctypes.data_as(ctypes.c_void_p)


def test_native_plain_encoder_long_code_fallback():
    from dextractor_tpu.native import qv_encode_shim
    from dextractor_tpu.ops import bitstream as bs

    try:
        lib = qv_encode_shim()
    except OSError:
        pytest.skip("native shim unavailable")
    scheme = _unary_scheme(30)          # len 30 > 24: pair tables refuse
    rng = np.random.default_rng(5)
    entries = [rng.integers(0, 12, size=int(rng.integers(0, 200))
                            ).astype(np.uint8) for _ in range(9)]
    expected = b"".join(bs.encode_stream(scheme, e).tobytes()
                        for e in entries)
    data = np.concatenate([np.zeros(0, np.uint8)] + entries)
    offs = np.zeros(len(entries) + 1, np.int64)
    np.cumsum([len(e) for e in entries], out=offs[1:])
    out = np.empty(len(expected) * 2 + 1024, np.uint8)
    out_lens = np.zeros(len(entries), np.int64)
    r = lib.dxt_encode_plain(
        _shim_ptr(data), _shim_ptr(offs), len(entries),
        _shim_ptr(np.ascontiguousarray(scheme.codebits.astype(np.uint32))),
        _shim_ptr(np.ascontiguousarray(scheme.codelens.astype(np.int32))),
        scheme.type, _shim_ptr(out), len(out), _shim_ptr(out_lens))
    assert r == len(expected)
    assert out[:r].tobytes() == expected


def test_native_run_encoder_long_code_fallback():
    from dextractor_tpu.native import qv_encode_shim
    from dextractor_tpu.ops import bitstream as bs

    try:
        lib = qv_encode_shim()
    except OSError:
        pytest.skip("native shim unavailable")
    neme = _unary_scheme(12)
    reme = _unary_scheme(20)            # run code len 20 > 16: fast path off
    rchar = 3
    rng = np.random.default_rng(6)
    entries = []
    for _ in range(7):
        n = int(rng.integers(0, 300))
        e = rng.integers(0, 10, size=n).astype(np.uint8)
        e[rng.random(n) < 0.6] = rchar
        entries.append(e)
    expected = b"".join(bs.encode_run_stream(neme, reme, e, rchar).tobytes()
                        for e in entries)
    data = np.concatenate([np.zeros(0, np.uint8)] + entries)
    offs = np.zeros(len(entries) + 1, np.int64)
    np.cumsum([len(e) for e in entries], out=offs[1:])
    out = np.empty(len(expected) * 2 + 1024, np.uint8)
    out_lens = np.zeros(len(entries), np.int64)
    r = lib.dxt_encode_run(
        _shim_ptr(data), _shim_ptr(offs), len(entries),
        _shim_ptr(np.ascontiguousarray(neme.codebits.astype(np.uint32))),
        _shim_ptr(np.ascontiguousarray(neme.codelens.astype(np.int32))),
        neme.type,
        _shim_ptr(np.ascontiguousarray(reme.codebits.astype(np.uint32))),
        _shim_ptr(np.ascontiguousarray(reme.codelens.astype(np.int32))),
        rchar, _shim_ptr(out), len(out), _shim_ptr(out_lens))
    assert r == len(expected)
    assert out[:r].tobytes() == expected


def test_device_decode_long_read_mix_buckets(monkeypatch):
    """A batch mixing ~0..20 kb reads must decode exactly AND split into
    compressed-length buckets (one fused launch per bucket) — round 2's
    cliff demoted the whole batch to the slow path on one long read."""
    from dextractor_tpu.codecs.qv_codec import (
        encode_quiva_to_dexqv, decode_dexqv_to_quiva)
    from dextractor_tpu.ops import decode2 as d2

    rng = np.random.default_rng(29)
    data = make_quiva(rng, n_reads=40, min_len=0, max_len=20000)
    enc = encode_quiva_to_dexqv(data, device=False)

    launches = []
    orig = d2.decode_entry_batch_seg

    def spy(*a, **k):
        launches.append((k.get("s_per"), k.get("max_len")))
        return orig(*a, **k)

    monkeypatch.setattr(d2, "decode_entry_batch_seg", spy)
    dec = decode_dexqv_to_quiva(enc, device=True)
    assert dec == data
    # long reads route through the checkpoint-segmented step; the flat
    # layout runs ONE launch whose rows are the live segments (s_per 1)
    assert len(launches) == 1, f"expected one flat launch: {launches}"
    assert launches[0][0] == 1

    # the round-3 segs-per-read bucketed layout must stay exact (A/B)
    launches.clear()
    monkeypatch.setenv("DXT_SEG_FLAT", "0")
    dec_b = decode_dexqv_to_quiva(enc, device=True)
    assert dec_b == data
    assert max(sp for sp, _ in launches) >= 4     # true multi-segment reads
    monkeypatch.delenv("DXT_SEG_FLAT")

    # the per-read bucketed path must stay exact too (DB path / fallback)
    monkeypatch.setenv("DXT_SEG_DECODE", "0")
    dec2 = decode_dexqv_to_quiva(enc, device=True)
    assert dec2 == data

    # and the native sequential walker on the same long-read mix
    assert decode_dexqv_to_quiva(enc, device=False) == data

    # device encode over the same long-row rectangles must stay byte-exact
    enc_dev = encode_quiva_to_dexqv(data, device=True)
    assert enc_dev == enc



def test_seg_decode_runs_and_carries_cross_boundaries():
    """Checkpoint-segmented decode vs the per-read fused step on data
    where delChar/subChar runs cross segment boundaries (run carries,
    literal-first resumes, clamped boundary runs) — small seg=256 so a
    modest batch has many segments."""
    from dextractor_tpu.codecs.qv_codec import (
        encode_quiva_to_dexqv, _index_native, _index_checkpoints)
    from dextractor_tpu.formats import dexqv as dqf
    from dextractor_tpu.codecs.qv_batch import (
        fused_decode_entries, fused_decode_entries_seg)

    rng = np.random.default_rng(31)
    data = make_quiva(rng, n_reads=14, min_len=0, max_len=2500,
                      sub_heavy=True)
    enc = encode_quiva_to_dexqv(data, device=False)
    coding, coff = dqf.parse_qvcoding(memoryview(enc), 2)
    idx = _index_native(enc, coding, coff, True)
    if idx is None:
        pytest.skip("native shim unavailable")
    _, _, _, _, _, _, eoffs, elens, coffs, ntoks = idx
    ck = _index_checkpoints(enc, coding, coff, True, idx, seg=256)
    assert ck is not None
    buf = np.frombuffer(enc, np.uint8)
    ref = np.asarray(fused_decode_entries(
        buf, eoffs, elens.astype(np.int32), coffs, ntoks, coding))
    got = fused_decode_entries_seg(
        buf, eoffs, elens.astype(np.int32), coffs, ntoks, coding, ck)
    w = min(ref.shape[2], got.shape[2])
    np.testing.assert_array_equal(got[:, :, :w], ref[:, :, :w])
    assert not (ref[:, :, w:] != 0).any()
    assert not (got[:, :, w:] != 0).any()


def test_seg_decode_conveyor_interpret(monkeypatch):
    """The segment chains (pos0 mid-bit resume + run carries) through the
    GPU chain kernel in interpret mode."""
    from dextractor_tpu.utils import dispatch
    from dextractor_tpu.codecs.qv_codec import (
        encode_quiva_to_dexqv, _index_native, _index_checkpoints)
    from dextractor_tpu.formats import dexqv as dqf
    from dextractor_tpu.codecs.qv_batch import (
        fused_decode_entries, fused_decode_entries_seg)

    rng = np.random.default_rng(37)
    data = make_quiva(rng, n_reads=7, min_len=0, max_len=700)
    enc = encode_quiva_to_dexqv(data, device=False)
    coding, coff = dqf.parse_qvcoding(memoryview(enc), 2)
    idx = _index_native(enc, coding, coff, True)
    if idx is None:
        pytest.skip("native shim unavailable")
    _, _, _, _, _, _, eoffs, elens, coffs, ntoks = idx
    ck = _index_checkpoints(enc, coding, coff, True, idx, seg=256)
    assert ck is not None
    buf = np.frombuffer(enc, np.uint8)
    ref = np.asarray(fused_decode_entries(
        buf, eoffs, elens.astype(np.int32), coffs, ntoks, coding))
    monkeypatch.setattr(dispatch, "chain_kernel", lambda: "interpret")
    got = fused_decode_entries_seg(
        buf, eoffs, elens.astype(np.int32), coffs, ntoks, coding, ck)
    w = min(ref.shape[2], got.shape[2])
    np.testing.assert_array_equal(got[:, :, :w], ref[:, :, :w])


def test_device_decode_without_native_walker_raises(monkeypatch):
    """device=True never decodes on the host: without the native index
    walk the device path raises instead of falling back."""
    from dextractor_tpu.codecs import qv_codec

    rng = np.random.default_rng(47)
    quiva = make_quiva(rng, n_reads=3, min_len=1, max_len=50)
    enc = qv_codec.encode_quiva_to_dexqv(quiva, device=False)
    monkeypatch.setattr(qv_codec, "_index_native", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="native index walker"):
        qv_codec.decode_dexqv_to_quiva(enc, device=True)
    assert qv_codec.decode_dexqv_to_quiva(enc, device=False) == quiva
