"""GPU Huffman chain kernel (ops/chain_gpu) against the XLA chains
(ops/decode2) and the NumPy bitstream oracle (ops/bitstream).

Everything here runs the kernel in Pallas interpret mode on the CPU; the
``gpu``-marked test runs the compiled kernel and skips without a CUDA
device (``python chip_smoke.py`` runs the same check on the card).
Streams come from the host bitstream encoder, which is byte-identical to
the reference encoder, so chain-level equality pins the kernel to the
on-disk format.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dextractor_tpu.ops import bitstream as bs
from dextractor_tpu.ops import chain_gpu as cg
from dextractor_tpu.ops import decode2 as d2
from dextractor_tpu.ops.decode_jax import stream_word_counts
from dextractor_tpu.ops.huffman import make_scheme


def _scheme(kind, rng):
    """A scheme of the named shape and the symbols to draw data from."""
    hist = np.zeros(256, np.int64)
    if kind == "short":               # 16 equal symbols: 4-bit codes, L1 only
        hist[33:49] = 100
    elif kind == "l2":                # skewed QVs: codes longer than 8 bits
        hist[:6] = rng.integers(50_000, 200_000, 6)
        hist[6:44] = rng.integers(1, 3, 38)
    elif kind == "type2":             # exponential: truncated escape scheme
        hist[:40] = 2 ** np.arange(40, 0, -1, dtype=np.int64)
    elif kind == "full":              # every symbol live
        hist[:] = rng.integers(1, 1000, 256)
    s = make_scheme(hist)
    # every coded symbol; in a type-2 scheme that includes the escaped
    # (truncated) symbols and 255
    return s, np.flatnonzero(s.codelens > 0).astype(np.uint8)


def _check_kind(kind, scheme, lmax):
    if kind == "short":
        assert lmax == 8
    if kind == "l2":
        assert lmax > 8
    if kind == "type2":
        assert scheme.type == 2


def _rect(streams, k_min=16):
    """Word-aligned (N, K) u32 rectangle, pow2 K with window slack."""
    k = max(k_min, 1 << (max(len(s) for s in streams) // 4 + 12).bit_length())
    rect = np.zeros((len(streams), 4 * k), np.uint8)
    for i, s in enumerate(streams):
        rect[i, : len(s)] = np.frombuffer(bytes(s), np.uint8)
    return rect.view(np.uint32)


def _plain_case(kind, n, max_len, seed):
    rng = np.random.default_rng(seed)
    scheme, syms = _scheme(kind, rng)
    rlens = rng.integers(0, max_len + 1, n).astype(np.int32)
    rlens[0] = 0
    rlens[-1] = max_len
    datas = [rng.choice(syms, r) for r in rlens]
    streams = [bs.encode_stream(scheme, d).tobytes() for d in datas]
    f1, f2, subw, lmax = d2.scheme_tables2([scheme])
    _check_kind(kind, scheme, lmax)
    sig = 255 if scheme.type == 2 else 256
    return scheme, datas, streams, rlens, f1, f2, subw, lmax, sig


def _run_data(rng, syms, rchar, rlen, mix):
    d = rng.choice(syms, rlen)
    if mix == "short_runs":
        d[rng.random(rlen) < 0.6] = rchar
    elif mix == "long_runs":          # runs past 255: 16-bit run literals
        d[:] = rchar
        lit = rng.random(rlen) < 0.002
        d[lit] = rng.choice(syms[syms != rchar], int(lit.sum()))
    elif mix == "all_runs":
        d[:] = rchar
    elif mix == "no_runs":
        d[d == rchar] = syms[syms != rchar][0]
    return d


def _run_case(kind, mix, n, max_len, seed):
    rng = np.random.default_rng(seed)
    scheme, syms = _scheme(kind, rng)
    rhist = np.zeros(256, np.int64)
    rhist[:] = rng.integers(1, 50, 256)
    rhist[255] = 60                   # run lengths >= 255 escape
    rscheme = make_scheme(rhist)
    rchar = int(syms[len(syms) // 2])
    rlens = rng.integers(0, max_len + 1, n).astype(np.int32)
    rlens[0] = 0
    rlens[-1] = max_len
    datas = [_run_data(rng, syms, rchar, r, mix) for r in rlens]
    streams = [bs.encode_run_stream(scheme, rscheme, d, rchar).tobytes()
               for d in datas]
    f1, f2, subw, lmax = d2.scheme_tables2([scheme, rscheme])
    sig = 255 if scheme.type == 2 else 256
    return (scheme, rscheme, rchar, datas, streams, rlens, f1, f2, subw,
            lmax, sig)


def _plain_kernel(rect, rlens, f1, f2, sig, pos0=None, *, max_len, subw,
                  lmax, sid=0):
    n = len(rlens)
    z = np.zeros(n, np.int32)
    return cg.plain_chains_gpu(
        jnp.asarray(rect), jnp.asarray(rlens), jnp.asarray(z + sid),
        jnp.asarray(z + sig), jnp.asarray(z if pos0 is None else pos0),
        jnp.asarray(f1), jnp.asarray(f2), max_len=max_len, subw=subw,
        lmax=lmax, interpret=True)


def _run_kernel(rect, rlens, f1, f2, sig, pos0=None, carry=None, *,
                max_tokens, subw, lmax):
    n = len(rlens)
    z = np.zeros(n, np.int32)
    return cg.run_chains_gpu(
        jnp.asarray(rect), jnp.asarray(rlens), jnp.asarray(z + 1),
        jnp.asarray(z), jnp.asarray(z + sig),
        jnp.asarray(z if pos0 is None else pos0),
        jnp.asarray(z - 1 if carry is None else carry), jnp.asarray(f1),
        jnp.asarray(f2), max_tokens=max_tokens, subw=subw, lmax=lmax,
        interpret=True)


# ---------------------------------------------------------------------------
# plain chains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len", [8, 40, 150])
@pytest.mark.parametrize("kind", ["short", "l2", "type2", "full"])
def test_plain_chains_match_xla_and_oracle(kind, max_len):
    (scheme, datas, streams, rlens, f1, f2, subw, lmax,
     sig) = _plain_case(kind, 9, max_len, seed=max_len)
    rect = _rect(streams)
    got, bits, last = _plain_kernel(rect, rlens, f1, f2, sig,
                                    max_len=max_len, subw=subw, lmax=lmax)
    got = np.asarray(got)
    xla = np.asarray(d2.plain_chain(
        jnp.asarray(rect), jnp.asarray(rlens), jnp.asarray(f1[0]),
        jnp.asarray(f2), jnp.int32(sig), max_len=max_len, subw=subw,
        lmax=lmax))
    np.testing.assert_array_equal(got, xla)
    words = stream_word_counts(np.asarray(bits).astype(np.int64),
                               np.asarray(last).astype(np.int64))
    for i, r in enumerate(rlens):
        buf = np.frombuffer(streams[i] + bytes(8), np.uint8)
        oracle, w = bs.decode_stream(scheme, bs.BitReader(buf, 0), int(r))
        np.testing.assert_array_equal(got[i, :r], oracle)
        np.testing.assert_array_equal(got[i, :r], datas[i])
        assert not got[i, r:].any()
        assert 4 * int(words[i]) == len(streams[i]) == 4 * w


@pytest.mark.parametrize("cut", [1, 7, 31])
def test_plain_chain_resumes_mid_stream(cut):
    """Segment resume: a chain sliced at the word of bit ``pos`` with
    pos0 = pos & 31 decodes the rest of the stream (the checkpoint walk's
    contract)."""
    (scheme, datas, streams, rlens, f1, f2, subw, lmax,
     sig) = _plain_case("l2", 6, 64, seed=cut)
    rect = _rect(streams)
    head = np.minimum(rlens, cut).astype(np.int32)
    _, bits, _ = _plain_kernel(rect, head, f1, f2, sig, max_len=64,
                               subw=subw, lmax=lmax)
    bits = np.asarray(bits)
    tails = [bytes(s)[4 * (int(b) >> 5):] for s, b in zip(streams, bits)]
    got, _, _ = _plain_kernel(_rect(tails), rlens - head, f1, f2, sig,
                              pos0=(bits & 31).astype(np.int32), max_len=64,
                              subw=subw, lmax=lmax)
    got = np.asarray(got)
    for i in range(len(rlens)):
        np.testing.assert_array_equal(got[i, : rlens[i] - head[i]],
                                      datas[i][head[i]:])


@pytest.mark.parametrize("n", [1, 31, 33, 70])
def test_plain_chains_lane_padding(n):
    """Chain counts that are not a whole number of programs: the wrapper
    pads lanes with empty chains and returns exactly n rows."""
    (scheme, datas, streams, rlens, f1, f2, subw, lmax,
     sig) = _plain_case("short", n, 12, seed=n)
    got, bits, last = _plain_kernel(_rect(streams), rlens, f1, f2, sig,
                                    max_len=12, subw=subw, lmax=lmax)
    assert got.shape == (n, 12) and got.dtype == jnp.uint8
    assert bits.shape == last.shape == (n,)
    got = np.asarray(got)
    for i in range(n):
        np.testing.assert_array_equal(got[i, : rlens[i]], datas[i])
        assert not got[i, rlens[i]:].any()


def test_chains_all_empty():
    """A batch of empty reads decodes to zero rows and consumes no bits."""
    (scheme, datas, streams, rlens, f1, f2, subw, lmax,
     sig) = _plain_case("l2", 5, 16, seed=3)
    rl0 = np.zeros_like(rlens)
    got, bits, last = _plain_kernel(_rect(streams), rl0, f1, f2, sig,
                                    max_len=16, subw=subw, lmax=lmax)
    assert not np.asarray(got).any()
    assert not np.asarray(bits).any() and not np.asarray(last).any()
    runs, lits, rbits, _ = _run_kernel(_rect(streams), rl0, f1, f2, sig,
                                       max_tokens=16, subw=subw, lmax=lmax)
    assert not np.asarray(runs).any() and (np.asarray(lits) == -1).all()
    assert not np.asarray(rbits).any()


def test_plain_chains_per_lane_schemes():
    """Lanes carry their own scheme rows: two codings in one launch."""
    rng = np.random.default_rng(5)
    sa, syma = _scheme("l2", rng)
    sb, symb = _scheme("short", rng)
    f1, f2, subw, lmax = d2.scheme_tables2([sa, sb])
    rlens = rng.integers(0, 50, 10).astype(np.int32)
    sids = np.arange(10) % 2
    datas = [rng.choice(syma if s == 0 else symb, r)
             for s, r in zip(sids, rlens)]
    streams = [bs.encode_stream(sa if s == 0 else sb, d).tobytes()
               for s, d in zip(sids, datas)]
    sigs = np.where(np.array([sa.type, sb.type])[sids] == 2, 255, 256)
    got, _, _ = cg.plain_chains_gpu(
        jnp.asarray(_rect(streams)), jnp.asarray(rlens),
        jnp.asarray(sids.astype(np.int32)), jnp.asarray(sigs),
        jnp.zeros(10, jnp.int32), jnp.asarray(f1), jnp.asarray(f2),
        max_len=50, subw=subw, lmax=lmax, interpret=True)
    got = np.asarray(got)
    for i in range(10):
        np.testing.assert_array_equal(got[i, : rlens[i]], datas[i])


# ---------------------------------------------------------------------------
# run chains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix", ["short_runs", "long_runs", "all_runs",
                                 "no_runs"])
@pytest.mark.parametrize("kind", ["short", "l2", "type2"])
def test_run_chains_match_xla_and_oracle(kind, mix):
    max_len = 600 if mix == "long_runs" else 60
    (scheme, rscheme, rchar, datas, streams, rlens, f1, f2, subw, lmax,
     sig) = _run_case(kind, mix, 6, max_len, seed=len(mix))
    rect = _rect(streams)
    t = max_len + 2
    runs, lits, bits, last = _run_kernel(rect, rlens, f1, f2, sig,
                                         max_tokens=t, subw=subw, lmax=lmax)
    runs, lits = np.asarray(runs), np.asarray(lits)
    xr, xl = d2.run_chain(jnp.asarray(rect), jnp.asarray(rlens),
                          jnp.asarray(f1[1]), jnp.asarray(f1[0]),
                          jnp.asarray(f2), jnp.int32(sig), max_tokens=t,
                          subw=subw, lmax=lmax)
    np.testing.assert_array_equal(runs, np.asarray(xr)[:, :t])
    np.testing.assert_array_equal(lits, np.asarray(xl)[:, :t])
    if mix == "long_runs":
        assert runs.max() > 255           # 16-bit run literals were read
    rows = np.asarray(d2.expand_runs2(jnp.asarray(runs), jnp.asarray(lits),
                                      jnp.uint8(rchar), max_len=max_len))
    words = stream_word_counts(np.asarray(bits).astype(np.int64),
                               np.asarray(last).astype(np.int64))
    for i, r in enumerate(rlens):
        buf = np.frombuffer(streams[i] + bytes(8), np.uint8)
        oracle, w = bs.decode_run_stream(scheme, rscheme, bs.BitReader(buf, 0),
                                         int(r), rchar)
        np.testing.assert_array_equal(rows[i, :r], oracle)
        np.testing.assert_array_equal(rows[i, :r], datas[i])
        assert 4 * int(words[i]) == len(streams[i]) == 4 * w


@pytest.mark.parametrize("which", [0, 1, 2])
def test_run_chain_resumes_with_carry(which):
    """Segment resume inside a run: the chain restarts at the run's
    literal code with the leftover run length as ``carry`` — the
    checkpoint walk's contract (qv_codec._index_checkpoints)."""
    (scheme, rscheme, rchar, datas, streams, rlens, f1, f2, subw, lmax,
     sig) = _run_case("l2", "short_runs", 8, 80, seed=11)
    rect = _rect(streams)
    t = 82
    runs, lits, _, _ = _run_kernel(rect, rlens, f1, f2, sig, max_tokens=t,
                                   subw=subw, lmax=lmax)
    runs, lits = np.asarray(runs), np.asarray(lits)
    # per chain: cut one symbol into its which-th run of length >= 2
    head = np.zeros(len(rlens), np.int32)
    carry = np.full(len(rlens), -1, np.int32)
    for i in range(len(rlens)):
        starts = np.cumsum(runs[i]) - runs[i] + np.arange(t)
        long_runs = np.flatnonzero(runs[i] >= 2)
        if len(long_runs) > which:
            k = long_runs[which]
            head[i] = starts[k] + 1
            carry[i] = min(runs[i][k] - 1, rlens[i] - head[i])
    live = carry >= 0
    assert live.sum() >= 3
    # a chain cut inside a run stops right after that run's code
    _, _, bits, _ = _run_kernel(rect, head, f1, f2, sig, max_tokens=t,
                                subw=subw, lmax=lmax)
    bits = np.where(live, np.asarray(bits), 0)
    tails = [bytes(s)[4 * (int(b) >> 5):] for s, b in zip(streams, bits)]
    rl_tail = np.where(live, rlens - head, rlens).astype(np.int32)
    rtail = _rect(tails)
    p0 = (bits & 31).astype(np.int32)
    kr, kl, _, _ = _run_kernel(rtail, rl_tail, f1, f2, sig, pos0=p0,
                               carry=carry, max_tokens=t, subw=subw,
                               lmax=lmax)
    xr, xl = d2.run_chain(jnp.asarray(rtail), jnp.asarray(rl_tail),
                          jnp.asarray(f1[1]), jnp.asarray(f1[0]),
                          jnp.asarray(f2), jnp.int32(sig), max_tokens=t,
                          subw=subw, lmax=lmax, pos0=jnp.asarray(p0),
                          carry=jnp.asarray(carry))
    np.testing.assert_array_equal(np.asarray(kr), np.asarray(xr)[:, :t])
    np.testing.assert_array_equal(np.asarray(kl), np.asarray(xl)[:, :t])
    rows = np.asarray(d2.expand_runs2(kr, kl, jnp.uint8(rchar), max_len=80))
    for i in np.flatnonzero(live):
        np.testing.assert_array_equal(rows[i, : rl_tail[i]],
                                      datas[i][head[i]:])


# ---------------------------------------------------------------------------
# decode2 routing: merged launches and the choice of kernel
# ---------------------------------------------------------------------------

def _two_channel_batch(seed):
    rng = np.random.default_rng(seed)
    sa, syma = _scheme("l2", rng)
    sb, symb = _scheme("type2", rng)
    f1, f2, subw, lmax = d2.scheme_tables2([sa, sb])
    rlens = rng.integers(0, 40, 7).astype(np.int32)
    da = [rng.choice(syma, r) for r in rlens]
    db = [rng.choice(symb, r) for r in rlens]
    ra = _rect([bs.encode_stream(sa, d).tobytes() for d in da])
    rb = _rect([bs.encode_stream(sb, d).tobytes() for d in db], k_min=256)
    types = jnp.asarray(np.array([sa.type, sb.type], np.int32))
    return rlens, (ra, rb), (da, db), f1, f2, subw, lmax, types


def test_plain_chains_merged_launch_matches_per_channel():
    """decode2.plain_chains: channels of different rectangle widths and
    schemes decode in ONE kernel launch, equal to the per-channel XLA
    chains."""
    rlens, (ra, rb), (da, db), f1, f2, subw, lmax, types = \
        _two_channel_batch(21)
    specs = [("a", jnp.asarray(ra), jnp.int32(0), subw),
             ("b", jnp.asarray(rb), jnp.int32(1), subw)]
    args = (specs, jnp.asarray(rlens), jnp.asarray(f1), jnp.asarray(f2),
            types)
    calls = []
    orig = cg.plain_chains_gpu

    def spy(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    ker = d2.plain_chains(*args, max_len=40, lmax=lmax, kernel="interpret")
    xla = d2.plain_chains(*args, max_len=40, lmax=lmax)
    try:
        cg.plain_chains_gpu = spy
        d2.plain_chains(*args, max_len=40, lmax=lmax, kernel="interpret")
        d2.plain_chains(*args, max_len=40, lmax=lmax)
    finally:
        cg.plain_chains_gpu = orig
    assert calls == [(2 * len(rlens), rb.shape[1])]   # one merged launch
    for key, datas in (("a", da), ("b", db)):
        np.testing.assert_array_equal(np.asarray(ker[key]),
                                      np.asarray(xla[key]))
        for i, r in enumerate(rlens):
            np.testing.assert_array_equal(np.asarray(ker[key])[i, :r],
                                          datas[i])


def test_run_chains_merged_launch_matches_per_channel():
    (scheme, rscheme, rchar, datas, streams, rlens, f1, f2, subw, lmax,
     sig) = _run_case("l2", "short_runs", 5, 50, seed=2)
    rect = jnp.asarray(_rect(streams))
    wide = jnp.pad(rect, ((0, 0), (0, rect.shape[1])))
    types = jnp.asarray(np.array([scheme.type, rscheme.type], np.int32))
    specs = [("del", rect, jnp.int32(1), jnp.int32(0), subw, None, None),
             ("sub", wide, jnp.int32(1), jnp.int32(0), subw, None, None)]
    args = (specs, jnp.asarray(rlens), jnp.asarray(f1), jnp.asarray(f2),
            types)
    ker = d2.run_chains(*args, max_tokens=52, lmax=lmax, kernel="interpret")
    xla = d2.run_chains(*args, max_tokens=52, lmax=lmax)
    for key in ("del", "sub"):
        for a, b in zip(ker[key], xla[key]):
            np.testing.assert_array_equal(np.asarray(a),
                                          np.asarray(b)[:, :52])


@pytest.mark.parametrize("kernel", [None, "interpret"])
def test_entry_step_kernel_choice(kernel, monkeypatch):
    """decode_entry_batch2 runs its chains in the GPU kernel exactly when
    it is given one, and both choices decode the same rows."""
    from dextractor_tpu.codecs.qv_batch import channel_rects, decode_tables_v2
    from dextractor_tpu.codecs.qv_codec import (
        encode_quiva_to_dexqv, _index_native)
    from dextractor_tpu.formats import dexqv as dqf
    from dextractor_tpu.formats.ragged import bucket_len
    from dextractor_tpu.testdata import make_quiva

    rng = np.random.default_rng(29)
    quiva = make_quiva(rng, n_reads=6, min_len=0, max_len=90)
    enc = encode_quiva_to_dexqv(quiva, device=False)
    coding, coff = dqf.parse_qvcoding(memoryview(enc), 2)
    idx = _index_native(enc, coding, coff, True)
    eoffs, elens, coffs, ntoks = idx[6], idx[7], idx[8], idx[9]
    buf = np.frombuffer(enc, np.uint8)
    max_len = bucket_len(int(elens.max()), 512)
    rects = channel_rects(buf, eoffs, coffs, max_len)
    sids, f1, f2, types, del_mode, sub_mode, subw, lmax = \
        decode_tables_v2(coding)
    calls = []
    orig_p, orig_r = cg.plain_chains_gpu, cg.run_chains_gpu
    monkeypatch.setattr(cg, "plain_chains_gpu",
                        lambda *a, **k: calls.append("p") or orig_p(*a, **k))
    monkeypatch.setattr(cg, "run_chains_gpu",
                        lambda *a, **k: calls.append("r") or orig_r(*a, **k))
    # the unjitted body: every call traces, so the spies see the routing
    rows = d2.decode_entry_batch2.__wrapped__(
        *(jnp.asarray(r) for r in rects), jnp.asarray(elens.astype(np.int32)),
        jnp.asarray(sids), jnp.asarray(f1), jnp.asarray(f2),
        jnp.asarray(types), jnp.int32(coding.del_char & 0xFF),
        jnp.int32(coding.sub_char & 0xFF), max_len=max_len,
        max_tokens=bucket_len(int(ntoks.max()), 16), del_mode=del_mode,
        sub_mode=sub_mode, subw=subw, lmax=lmax, kernel=kernel)
    assert del_mode == "run"                  # one plain + one run launch
    assert calls == ([] if kernel is None else ["p", "r"])
    from dextractor_tpu.codecs.qv_codec import decode_entry
    for i in range(len(elens)):
        ref, _ = decode_entry(coding, buf, int(eoffs[i]), int(elens[i]))
        np.testing.assert_array_equal(np.asarray(rows)[:, i, : elens[i]],
                                      ref)


# ---------------------------------------------------------------------------
# launch geometry: int32 offsets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,width,launches", [
    (0, 2048, 1), (70, 16, 1),
    (1_100_000, 2048, 2),         # a few GB of .quiva in one merged launch
    (32_769, 65_536, 2)])         # one 60 kb read sets a bucket's width
def test_launches_keep_offsets_in_int32(n, width, launches):
    ranges = cg._launches(n, width)
    assert len(ranges) == launches
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    for a, b in ranges:
        assert cg._pad_lanes(b - a) * width < 2 ** 31


def test_launches_reject_a_chain_wider_than_the_offsets():
    with pytest.raises(ValueError, match="2\\^31"):
        cg._launches(10, 2 ** 31 // 16)


@pytest.mark.parametrize("run", [False, True])
def test_split_launches_decode_as_one(run, monkeypatch):
    """A batch past the offset limit decodes in several launches, equal
    row for row to the XLA chains and to the input."""
    n, max_len = 70, 12
    if run:
        (scheme, rscheme, rchar, datas, streams, rlens, f1, f2, subw, lmax,
         sig) = _run_case("short", "short_runs", n, max_len, seed=4)
    else:
        (scheme, datas, streams, rlens, f1, f2, subw, lmax,
         sig) = _plain_case("short", n, max_len, seed=4)
    rect = _rect(streams)
    width = max(rect.shape[1], max_len + 2 if run else max_len)
    # room for one 32-lane program: 70 chains take 3 launches
    monkeypatch.setattr(cg, "INDEX_LIMIT", 32 * width + 1)
    launches = []
    orig = cg._call
    monkeypatch.setattr(cg, "_call", lambda *a, **k: launches.append(a[2])
                        or orig(*a, **k))
    z = jnp.zeros(n, jnp.int32)
    args = (jnp.asarray(rect), jnp.asarray(rlens))
    if run:
        t = max_len + 2
        runs, lits, _, _ = cg.run_chains_gpu.__wrapped__(
            *args, z + 1, z, z + sig, z, z - 1, jnp.asarray(f1),
            jnp.asarray(f2), max_tokens=t, subw=subw, lmax=lmax,
            interpret=True)
        xr, xl = d2.run_chain(*args, jnp.asarray(f1[1]), jnp.asarray(f1[0]),
                              jnp.asarray(f2), jnp.int32(sig), max_tokens=t,
                              subw=subw, lmax=lmax)
        np.testing.assert_array_equal(np.asarray(runs), np.asarray(xr)[:, :t])
        np.testing.assert_array_equal(np.asarray(lits), np.asarray(xl)[:, :t])
        rows = np.asarray(d2.expand_runs2(runs, lits, jnp.uint8(rchar),
                                          max_len=max_len))
    else:
        rows, _, _ = cg.plain_chains_gpu.__wrapped__(
            *args, z, z + sig, z, jnp.asarray(f1), jnp.asarray(f2),
            max_len=max_len, subw=subw, lmax=lmax, interpret=True)
        rows = np.asarray(rows)
        np.testing.assert_array_equal(rows, np.asarray(d2.plain_chain(
            *args, jnp.asarray(f1[0]), jnp.asarray(f2), jnp.int32(sig),
            max_len=max_len, subw=subw, lmax=lmax)))
    assert launches == [32, 32, 32]       # lanes per launch, padded
    assert rows.shape == (n, max_len)
    for i in range(n):
        np.testing.assert_array_equal(rows[i, : rlens[i]], datas[i])


def test_batch_decode_buckets_take_their_own_width(monkeypatch):
    """qv_batch.batch_decode_entries: short reads beside one long read
    decode in their own rectangle bucket at their own width, not at the
    long read's."""
    from dextractor_tpu.codecs.qv_batch import batch_decode_entries
    from dextractor_tpu.codecs.qv_codec import (
        decode_entry, encode_quiva_to_dexqv, _index_native)
    from dextractor_tpu.formats import dexqv as dqf
    from dextractor_tpu.testdata import make_quiva
    from dextractor_tpu.utils import dispatch

    rng = np.random.default_rng(31)
    quiva = make_quiva(rng, lengths=[40, 7, 55, 0, 30, 2100])
    enc = encode_quiva_to_dexqv(quiva, device=False)
    coding, coff = dqf.parse_qvcoding(memoryview(enc), 2)
    idx = _index_native(enc, coding, coff, True)
    eoffs, elens = idx[6], idx[7].astype(np.int32)
    buf = np.frombuffer(enc, np.uint8)
    widths = []
    orig = cg.plain_chains_gpu
    monkeypatch.setattr(dispatch, "chain_kernel", lambda: "interpret")
    monkeypatch.setattr(cg, "plain_chains_gpu", lambda *a, **k: widths.append(
        (a[0].shape[0], k["max_len"])) or orig(*a, **k))
    rows, _ = batch_decode_entries(buf, eoffs, elens, [coding],
                                   np.zeros(len(elens), np.int64))
    # per plain channel (ins, mrg; del/sub run here): 5 short + 1 long
    assert sorted(set(widths)) == [(1, 2304), (5, 512)]
    rows = np.asarray(rows)
    assert rows.shape == (5, 6, 2304)
    for i in range(len(elens)):
        ref, _ = decode_entry(coding, buf, int(eoffs[i]), int(elens[i]))
        np.testing.assert_array_equal(rows[:, i, : elens[i]], ref)


@pytest.mark.parametrize("backend,expect", [("gpu", "gpu"), ("cpu", None)])
def test_chain_kernel_predicate(backend, expect, monkeypatch):
    from dextractor_tpu.utils import dispatch

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert dispatch.chain_kernel() == expect


@pytest.mark.gpu
def test_compiled_chain_kernels_on_card(cuda_device):
    """The compiled Triton kernels against the XLA chains and the NumPy
    oracle on the card (the chip smoke run's kernel phase)."""
    import chip_smoke

    chip_smoke.check_chain_kernels(seed=0, n_chains=256, max_len=2048)
