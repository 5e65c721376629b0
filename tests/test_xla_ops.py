"""Plain-XLA device ops against NumPy: the encoder's LUT gather and the
sharded scan's histogram.

Both are integer-only: no float matrix product remains on these paths, so
no TF32 (or other reduced-precision) matmul mode can change a result.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dextractor_tpu.ops import bitstream_jax as bj
from dextractor_tpu.parallel.pipeline import _histogram256


@pytest.mark.parametrize("shape", [(1, 1), (7, 129), (64, 2048)])
def test_lut_gather_matches_numpy(shape):
    rng = np.random.default_rng(shape[1])
    data = rng.integers(0, 256, shape).astype(np.uint8)
    lut = rng.integers(-(1 << 31), (1 << 31) - 1, 256).astype(np.int32)
    got = np.asarray(bj._lut_gather(jnp.asarray(data), jnp.asarray(lut)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, lut[data])


@pytest.mark.parametrize("shape,frac", [((1, 5), 1.0), ((33, 1000), 0.5),
                                        ((3, 70000), 0.9), ((0, 16), 1.0)])
def test_histogram256_matches_bincount(shape, frac):
    rng = np.random.default_rng(shape[1])
    data = rng.integers(0, 256, shape).astype(np.uint8)
    mask = rng.random(shape) < frac
    got = np.asarray(_histogram256(jnp.asarray(data), jnp.asarray(mask)))
    ref = np.bincount(data[mask], minlength=256)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_histogram256_broadcast_weights():
    """Weights given as a column over a (N,) data vector (the trailing-run
    histogram's call shape) count each masked element once."""
    data = np.array([3, 3, 255, 0, 7], np.uint8)
    w = np.array([[True], [False], [True], [True], [True]])
    got = np.asarray(_histogram256(jnp.asarray(data), jnp.asarray(w)))
    np.testing.assert_array_equal(got, np.bincount([3, 255, 0, 7],
                                                   minlength=256))
