"""Batched XLA decoder vs the NumPy bitstream oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from dextractor_tpu.ops import bitstream as bs
from dextractor_tpu.ops import decode_jax as dj
from dextractor_tpu.ops.huffman import make_scheme


def _pack_tables(schemes):
    for s in schemes:
        s.with_lookup()
    lookups = np.stack([s.lookup for s in schemes]).astype(np.int32)
    lens = np.stack([s.codelens for s in schemes]).astype(np.int32)
    types = np.array([s.type for s in schemes], np.int32)
    return lookups, lens, types


def test_decode_plain_batch_matches_oracle():
    rng = np.random.default_rng(0)
    n = 17
    datas, rlens = [], []
    for i in range(n):
        ln = int(rng.integers(2, 200))
        d = rng.integers(33, 90, ln).astype(np.uint8)
        d[0] = 33
        d[1] = 34
        datas.append(d)
        rlens.append(ln)
    hist = np.bincount(np.concatenate(datas), minlength=256).astype(np.int64)
    scheme = make_scheme(hist)

    # encode each stream, lay out at word-aligned offsets in one buffer
    chunks, starts = [], []
    pos = 0
    for d in datas:
        w = bs.encode_stream(scheme, d)
        starts.append(pos)
        chunks.append(w.tobytes())
        pos += len(w) * 4
    buf = np.frombuffer(b"".join(chunks) + b"\x00" * 8, np.uint8)

    rlens = np.array(rlens, np.int32)
    lookups, lens, types = _pack_tables([scheme])
    out, bits, last = dj.decode_plain_batch(
        jnp.asarray(buf), jnp.asarray(np.array(starts, np.int64)),
        jnp.asarray(rlens), jnp.zeros(n, jnp.int32),
        jnp.asarray(lookups), jnp.asarray(lens), jnp.asarray(types),
        max_len=int(rlens.max()))
    out = np.asarray(out)
    words = dj.stream_word_counts(np.asarray(bits), np.asarray(last))
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(out[i, : rlens[i]], d)
        assert words[i] * 4 == len(chunks[i])


def test_decode_run_batch_matches_oracle():
    rng = np.random.default_rng(1)
    rchar = 70
    n = 11
    datas, rlens = [], []
    for i in range(n):
        ln = int(rng.integers(5, 600))
        d = np.full(ln, rchar, np.uint8)
        breaks = rng.random(ln) < 0.15
        d[breaks] = rng.integers(33, 60, int(breaks.sum())).astype(np.uint8)
        d[0] = 33
        d[1] = 34
        datas.append(d)
        rlens.append(ln)
    flat = np.concatenate(datas)
    nhist = np.bincount(flat[flat != rchar], minlength=256).astype(np.int64)
    rhist = np.ones(256, np.int64)
    for d in datas:
        runlens, _, _ = bs.tokenize_runs(d, rchar)
        rhist += np.bincount(np.minimum(runlens, 255), minlength=256)
    neme, reme = make_scheme(nhist), make_scheme(rhist)

    chunks, starts = [], []
    pos = 0
    for d in datas:
        w = bs.encode_run_stream(neme, reme, d, rchar)
        starts.append(pos)
        chunks.append(w.tobytes())
        pos += len(w) * 4
    buf = np.frombuffer(b"".join(chunks) + b"\x00" * 8, np.uint8)

    rlens = np.array(rlens, np.int32)
    lookups, lens, types = _pack_tables([neme, reme])
    runs, lits, emitted, bits, last = dj.decode_run_batch(
        jnp.asarray(buf), jnp.asarray(np.array(starts, np.int64)),
        jnp.asarray(rlens), jnp.zeros(n, jnp.int32), jnp.ones(n, jnp.int32),
        jnp.asarray(lookups), jnp.asarray(lens), jnp.asarray(types),
        max_tokens=int(rlens.max()))
    out = dj.expand_runs_np(np.asarray(runs), np.asarray(lits),
                            rlens, rchar)
    words = dj.stream_word_counts(np.asarray(bits), np.asarray(last))
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(out[i, : rlens[i]], d)
        assert words[i] * 4 == len(chunks[i]), i


def test_decode_plain_batch_type2_escapes():
    """Type-2 schemes: the lane must take the escape branch (code peek ->
    8-bit literal peek) exactly like the oracle."""
    rng = np.random.default_rng(9)
    n = 9
    # extreme skew forces >16-bit codes -> truncated scheme with escapes
    datas, rlens = [], []
    hist = np.zeros(256, np.int64)
    for k in range(24):                    # exponential counts -> deep codes
        hist[40 + k] = 1 << (24 - k)
    for i in range(n):
        ln = int(rng.integers(30, 400))
        d = (40 + rng.integers(0, 24, ln)).astype(np.uint8)
        datas.append(d)
        rlens.append(ln)
    scheme = make_scheme(hist)
    assert scheme.type == 2, "test requires a truncated scheme"

    chunks, starts = [], []
    pos = 0
    for d in datas:
        w = bs.encode_stream(scheme, d)
        starts.append(pos)
        chunks.append(w.tobytes())
        pos += len(w) * 4
    buf = np.frombuffer(b"".join(chunks) + b"\x00" * 8, np.uint8)

    rlens = np.array(rlens, np.int32)
    lookups, lens, types = _pack_tables([scheme])
    out, bits, last = dj.decode_plain_batch(
        jnp.asarray(buf), jnp.asarray(np.array(starts, np.int64)),
        jnp.asarray(rlens), jnp.zeros(n, jnp.int32),
        jnp.asarray(lookups), jnp.asarray(lens), jnp.asarray(types),
        max_len=int(rlens.max()))
    out = np.asarray(out)
    words = dj.stream_word_counts(np.asarray(bits), np.asarray(last))
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(out[i, : rlens[i]], d)
        assert words[i] * 4 == len(chunks[i])


def test_decode_run_batch_long_runs():
    """Runs >= 255 take the 255 escape + 16-bit length literal in the
    batched lane decoder."""
    rng = np.random.default_rng(11)
    rchar = 70
    n = 5
    datas, rlens = [], []
    for i in range(n):
        ln = 1200
        d = np.full(ln, rchar, np.uint8)
        d[0] = 33
        d[600] = 34          # one 599-run and one 599-run tail
        datas.append(d)
        rlens.append(ln)
    flat = np.concatenate(datas)
    nhist = np.bincount(flat[flat != rchar], minlength=256).astype(np.int64)
    rhist = np.ones(256, np.int64)
    for d in datas:
        runlens, _, _ = bs.tokenize_runs(d, rchar)
        rhist += np.bincount(np.minimum(runlens, 255), minlength=256)
    neme, reme = make_scheme(nhist), make_scheme(rhist)

    chunks, starts = [], []
    pos = 0
    for d in datas:
        w = bs.encode_run_stream(neme, reme, d, rchar)
        starts.append(pos)
        chunks.append(w.tobytes())
        pos += len(w) * 4
    buf = np.frombuffer(b"".join(chunks) + b"\x00" * 8, np.uint8)

    rlens = np.array(rlens, np.int32)
    lookups, lens, types = _pack_tables([neme, reme])
    runs, lits, emitted, bits, last = dj.decode_run_batch(
        jnp.asarray(buf), jnp.asarray(np.array(starts, np.int64)),
        jnp.asarray(rlens), jnp.zeros(n, jnp.int32), jnp.ones(n, jnp.int32),
        jnp.asarray(lookups), jnp.asarray(lens), jnp.asarray(types),
        max_tokens=16)
    out = dj.expand_runs_np(np.asarray(runs), np.asarray(lits), rlens, rchar)
    words = dj.stream_word_counts(np.asarray(bits), np.asarray(last))
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(out[i, : rlens[i]], d)
        assert words[i] * 4 == len(chunks[i])
