"""Batched decode (ops/decode2) — routing primitives and path parity.

The fused v2 decoder itself is covered end-to-end by the raw-container
roundtrip tests in test_qv_codec.py (decode_dexqv_to_quiva(device=True)
routes through it); here we pin the routing-network primitives against
reference scatters and force the GPU path (the chain kernel, in
interpret mode; CPU runs otherwise take the XLA chains) through a full
container roundtrip.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import make_quiva

from dextractor_tpu.ops import decode2 as d2


def test_expand_monotone_matches_scatter():
    """Random monotone routings == per-element reference scatter."""
    rng = np.random.default_rng(7)
    for _ in range(60):
        n, t = 5, int(rng.integers(1, 14))
        w = int(t + rng.integers(0, 25))
        disp = np.zeros((n, t), np.int32)
        for r in range(n):
            k = int(rng.integers(0, t + 1))
            if k:
                dest = np.cumsum(rng.integers(0, 3, size=k)) + np.arange(k)
                if dest[-1] >= w:
                    k = 0
                else:
                    disp[r, :k] = dest - np.arange(k)
            disp[r, k:] = w                      # parked tail
        vals = rng.integers(1, 250, (n, t)).astype(np.int32)
        (routed,), occ = d2.expand_monotone(
            (jnp.asarray(vals),), jnp.asarray(disp), w + t)
        routed, occ = np.asarray(routed), np.asarray(occ)
        ref = np.zeros((n, w + t), np.int32)
        refocc = np.zeros((n, w + t), bool)
        for r in range(n):
            for c in range(t):
                ref[r, c + disp[r, c]] = vals[r, c]
                refocc[r, c + disp[r, c]] = True
        assert (occ == refocc).all()
        assert (routed[refocc] == ref[refocc]).all()


def test_roll_rows():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 255, (6, 64)).astype(np.uint8)
    s = rng.integers(0, 64, 6).astype(np.int32)
    out = np.asarray(d2.roll_rows(jnp.asarray(x), jnp.asarray(s)))
    for r in range(6):
        assert (out[r] == np.roll(x[r], -int(s[r]))).all()


def test_expand_runs2_matches_numpy():
    from dextractor_tpu.ops.decode_jax import expand_runs_np
    rng = np.random.default_rng(11)
    n, t, max_len = 6, 20, 64
    runs = rng.integers(0, 5, (n, t)).astype(np.int32)
    lits = rng.integers(0, 200, (n, t)).astype(np.int32)
    # emulate decoder structure: valid prefix, then exhausted (-1) tail
    rlens = np.zeros(n, np.int64)
    for r in range(n):
        k = int(rng.integers(0, t))
        lits[r, k:] = -1
        pos = np.cumsum(runs[r, :k + 1]) + np.arange(k + 1)
        rlens[r] = min(pos[-1] if k else runs[r, 0], max_len)
        runs[r, k:] = 0
    out = np.asarray(d2.expand_runs2(
        jnp.asarray(runs), jnp.asarray(lits), jnp.uint8(77),
        max_len=max_len))
    ref = expand_runs_np(runs, lits,
                         np.full(n, max_len, np.int64), 77)
    assert (out[:, :ref.shape[1]] == ref).all()


def test_forced_onehot_path_roundtrip(monkeypatch):
    """The accelerator path (the GPU chain kernel, skipped on CPU by
    default) must decode byte-identically too."""
    from dextractor_tpu.codecs.qv_codec import (
        encode_quiva_to_dexqv, decode_dexqv_to_quiva)
    from dextractor_tpu.utils import dispatch

    rng = np.random.default_rng(19)
    quiva = make_quiva(rng, n_reads=10, min_len=0, max_len=300)
    enc = encode_quiva_to_dexqv(quiva)
    monkeypatch.setattr(dispatch, "chain_kernel", lambda: "interpret")
    assert decode_dexqv_to_quiva(enc, device=True) == quiva
