"""K1: the port's threefry streams against the JAX package, bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pvtrace_tpu.engine import tracer as jt  # noqa: E402
from pvtrace_tpu_torch.engine import rng  # noqa: E402

torch.set_num_threads(1)
N = 4096


def _words(seed, k):
    """k arrays of N random uint32 words."""
    gen = np.random.default_rng(seed)
    return gen.integers(0, 2 ** 32, size=(k, N), dtype=np.uint64).astype(np.uint32)


def _t(words):
    return torch.from_numpy(words.astype(np.int64))


def test_threefry2x32_bit_equal():
    k0, k1, c0, c1 = _words(0, 4)
    ref = jt._threefry2x32(*(jnp.asarray(w) for w in (k0, k1, c0, c1)))
    got = rng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64), g.numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_draw8_bit_equal(dtype):
    pk0, pk1, count = _words(1, 3)
    ref = jt._draw8(jnp.asarray(pk0), jnp.asarray(pk1), jnp.asarray(count), dtype)
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    got = rng.draw8(_t(pk0), _t(pk1), _t(count), tdtype)
    assert len(got) == 8
    for r, g in zip(ref, got):
        assert g.dtype == tdtype
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


def test_photon_keys_bit_equal():
    pids, (pk0, pk1) = jt._photon_keys(jax.random.PRNGKey(7), N, 123456)
    got = rng.photon_keys(rng.key_words(7), 123456 + torch.arange(N))
    np.testing.assert_array_equal(np.asarray(pk0).astype(np.int64), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(pk1).astype(np.int64), got[1].numpy())


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
def test_key_words_match_prngkey(seed):
    ref = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(ref, rng.key_words(seed))


@pytest.mark.parametrize("seed", [-1, 2 ** 32])
def test_key_words_reject_seeds_outside_uint32(seed):
    with pytest.raises(ValueError):
        rng.key_words(seed)
