"""Hamming distance matrix against a plain NumPy popcount reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gf_orb_slam2_tpu.matching.hamming import distance_matrix, distance_pairs


def popcount_reference(a, b):
    """[N,8]x[M,8] uint32 → [N,M] int: unpack every bit and count."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


@pytest.mark.parametrize("n,m", [
    (256, 512),   # block-aligned
    (100, 70),    # ragged
    (1, 1000),    # one row against many
    (800, 1000),  # the stereo frontend's feature count against a ragged set
])
def test_distance_matrix_matches_popcount(n, m):
    rng = np.random.default_rng(n * 7919 + m)
    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    d = jax.jit(distance_matrix)(jnp.asarray(a), jnp.asarray(b))
    assert d.shape == (n, m) and d.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(d), popcount_reference(a, b))


def test_distance_pairs_is_the_diagonal():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(distance_pairs(jnp.asarray(a), jnp.asarray(b))),
        np.diag(popcount_reference(a, b)))
