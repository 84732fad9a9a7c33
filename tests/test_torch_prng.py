"""The port's reproduction of JAX's threefry draws (``utils/prng``) against
``jax.random`` on the CPU: the bits bitwise, the normals within 1e-6 (XLA's
and torch's f32 ``log1p``/``sqrt`` inside ``erf_inv`` may differ by an ulp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu_torch.utils import prng

NORMAL_TOL = 1e-6
# 0, small, above 2**31, the largest uint32, and an int64 seed masked the
# batcher's way (seed & 0xFFFFFFFF)
SEEDS = [0, 7, 2**31 + 5, 2**32 - 1, (2**40 + 3) & 0xFFFFFFFF]
SHAPES = [(8, 8, 16), (1,), (3, 5, 7)]


def _jax_key(seed):
    return jax.random.PRNGKey(np.uint32(seed))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_normal_match_jax(seed, shape):
    key = prng.prng_key(seed)
    assert key == tuple(int(k) for k in np.asarray(jax.random.key_data(_jax_key(seed))))
    bits = prng.random_bits(key, shape)
    want = np.asarray(jax.random.bits(_jax_key(seed), shape, jnp.uint32)).astype(np.int64)
    assert bits.dtype == torch.int64 and tuple(bits.shape) == shape
    np.testing.assert_array_equal(bits.numpy(), want)
    z = prng.normal(key, shape)
    assert z.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), np.asarray(jax.random.normal(_jax_key(seed), shape)),
                               rtol=0, atol=NORMAL_TOL)


def test_batched_draw_equals_per_seed_draws():
    seeds = np.array(SEEDS, np.int64)
    shape = (8, 8, 16)
    both = prng.normal_for_seeds(seeds, shape)
    assert tuple(both.shape) == (len(seeds),) + shape
    for i, s in enumerate(seeds):
        torch.testing.assert_close(both[i], prng.normal(prng.prng_key(s), shape), rtol=0, atol=0)
    # the JAX batcher's draw: vmap over uint32 seeds
    jz = jax.jit(jax.vmap(lambda s: jax.random.normal(jax.random.PRNGKey(s), shape)))(
        jnp.asarray(seeds.astype(np.uint32)))
    np.testing.assert_allclose(both.numpy(), np.asarray(jz), rtol=0, atol=NORMAL_TOL)


def test_uniform_and_seed_range():
    u = prng.uniform(prng.prng_key(11), (4, 9), -0.5, 2.0)
    ref = jax.random.uniform(_jax_key(11), (4, 9), jnp.float32, -0.5, 2.0)
    np.testing.assert_allclose(u.numpy(), np.asarray(ref), rtol=0, atol=2.5e-7)
    with pytest.raises(ValueError):
        prng.prng_key(2**32)
    with pytest.raises(ValueError):
        prng.normal_for_seeds([-1], (2,))


def _key_words(key):
    return tuple(int(k) for k in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed", [0, 7, 123456, 2**32 - 1])
def test_split_and_fold_in_match_jax(seed):
    key = prng.prng_key(seed)
    for n in (1, 2, 3, 10):
        assert prng.split(key, n) == [_key_words(k) for k in jax.random.split(_jax_key(seed), n)]
    for data in (0, 1, 11, 102, 2**31 + 9, 2**32 - 1):
        assert prng.fold_in(key, data) == _key_words(jax.random.fold_in(_jax_key(seed), data))
    # keys chain: a split of a fold_in, as the flow's init derives them
    chained = jax.random.split(jax.random.fold_in(_jax_key(seed), 100), 7)[4]
    assert prng.split(prng.fold_in(key, 100), 7)[4] == _key_words(chained)


@pytest.mark.parametrize("n", [1, 2, 16, 31, 512, 1500])
@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_permutation_matches_jax(seed, n):
    perm = prng.permutation(prng.prng_key(seed), n)
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jax.random.permutation(_jax_key(seed), n)))


def test_permutation_refuses_a_second_sort_round():
    with pytest.raises(NotImplementedError, match="sort rounds"):
        prng.permutation(prng.prng_key(0), 2**22)


def test_sliced_cpu_draws_equal_the_draw_in_one_pass(monkeypatch):
    """A large CPU draw is hashed and mapped slice by slice (``_CPU_SLICE``);
    every element comes from its own counter, so the numbers are the same
    bitwise as one pass, and JAX's."""
    key, shape = prng.fold_in(prng.prng_key(5), 3), (3, 7, 11)
    draws = {"bits": lambda: prng.random_bits(key, shape),
             "uniform": lambda: prng.uniform(key, shape, -0.5, 2.0),
             "normal": lambda: prng.normal(key, shape)}
    monkeypatch.setattr(prng, "_CPU_SLICE", 1 << 30)
    whole = {k: f() for k, f in draws.items()}
    monkeypatch.setattr(prng, "_CPU_SLICE", 16)
    for k, f in draws.items():
        assert torch.equal(f(), whole[k]), k
    jkey = jax.random.fold_in(_jax_key(5), 3)
    np.testing.assert_array_equal(whole["bits"].numpy(),
                                  np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
