"""The port's RNG (fspt_tpu_torch.core.rng) against the JAX package's:
threefry key data and PCG4D uniforms must agree bit for bit on every
stream the integrator draws (camera 0, shading 1..max_iters, compaction
64+it, merge shrink 64+max_iters+it), with and without the cross-sample
key_rows path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fspt_tpu.core import rng as jrng
from fspt_tpu_torch.core import rng as trng

torch.set_num_threads(1)

MAX_ITERS = 11
STREAMS = ([0] + list(range(1, MAX_ITERS + 1))
           + [64 + it for it in (0, 3, MAX_ITERS - 1)]
           + [64 + MAX_ITERS + it for it in (0, 2)])


def _kd(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2 ** 31 + 5, -3])
def test_key_bit_exact(seed):
    np.testing.assert_array_equal(trng.key(seed), _kd(jax.random.key(seed)))


@pytest.mark.parametrize("data", [0, 1, 5, 1000, 2 ** 31 + 3])
def test_fold_in_and_sample_key_bit_exact(data):
    jk, tk = jax.random.key(7), trng.key(7)
    np.testing.assert_array_equal(trng.fold_in(tk, data),
                                  _kd(jax.random.fold_in(jk, data)))
    np.testing.assert_array_equal(trng.sample_key(tk, data),
                                  _kd(jrng.sample_key(jk, data)))


def test_key_rows_for_bit_exact():
    jk = jrng.sample_key(jax.random.key(3), 11)
    tk = trng.sample_key(trng.key(3), 11)
    np.testing.assert_array_equal(trng.key_rows_for(tk, 8),
                                  np.asarray(jrng.key_rows_for(jk, 8)))


@pytest.mark.parametrize("stream", STREAMS)
def test_stream_uniforms_bit_exact(stream):
    jk = jrng.sample_key(jax.random.key(5), 2)
    tk = trng.sample_key(trng.key(5), 2)
    n = 2000
    # scalar lane offset
    a = np.asarray(jrng.stream_uniforms(jk, stream, (11, n), lane_offset=37))
    b = trng.stream_uniforms(tk, stream, (11, n), lane_offset=37).numpy()
    np.testing.assert_array_equal(a, b)
    # explicit gids + key_rows (cross-sample wavefront lanes)
    k, per = 4, 700
    gid = np.random.default_rng(stream).integers(0, k * per, n)
    gid = gid.astype(np.int32)
    a = np.asarray(jrng.stream_uniforms(
        jk, stream, (11, n), lane_offset=jnp.asarray(gid),
        key_rows=jrng.key_rows_for(jk, k), lanes_per_key=per))
    b = trng.stream_uniforms(
        tk, stream, (11, n), lane_offset=torch.from_numpy(gid),
        key_rows=trng.key_rows_tensor(trng.key_rows_for(tk, k), "cpu"),
        lanes_per_key=per).numpy()
    np.testing.assert_array_equal(a, b)
    assert b.dtype == np.float32 and (b >= 0).all() and (b < 1).all()
