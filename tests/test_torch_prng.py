"""The port's threefry2x32 PRNG (``noize_tpu_torch.prng``) bit-equal to
``jax.random`` on the CPU, as this JAX configures it (the threefry2x32
implementation with ``jax_threefry_partitionable``).  ``ErosionSim`` and
the flagship step from seeds alone are in tests/test_torch_sim.py and
tests/test_torch_flagship.py."""

import jax
import numpy as np
import pytest
import torch

from noize_tpu.erosion.particles import spawn as jax_spawn
from noize_tpu_torch import convert
from noize_tpu_torch import prng as P
from noize_tpu_torch.erosion.particles import spawn

SEEDS = (0, 1, 42, 2**31 - 1)


def _key(seed):
    return jax.random.PRNGKey(seed), P.PRNGKey(seed, device="cpu")


def test_configuration_is_the_one_held():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + (-1, 2**32 + 3))
def test_prng_key(seed):
    jk, tk = _key(seed)
    assert tk.dtype == torch.uint32 and tk.shape == (2,)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3])
def test_split(seed, num):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(P.split(tk, num).numpy(), np.asarray(jax.random.split(jk, num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed):
    jk, tk = _key(seed)
    for data in (0, 7, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(P.fold_in(tk, data).numpy(),
                                      np.asarray(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [0, 1, 7, 100_000])
@pytest.mark.parametrize("span", ["res", "symmetric"])
def test_randint(seed, shape, span):
    jk, tk = _key(seed)
    for s in (1, 3, 256, 1000, 2049):
        lo, hi = (0, s) if span == "res" else (-s, s + 1)
        want = np.asarray(jax.random.randint(jk, (shape,), lo, hi))
        got = P.randint(tk, (shape,), lo, hi)
        assert got.dtype == torch.int32 and tuple(got.shape) == (shape,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint_edges():
    jk, tk = _key(5)
    for lo, hi in ((3, 3), (5, 2), (-2**31, 2**31 - 1), (2**31 - 2, 2**31 - 1)):
        np.testing.assert_array_equal(P.randint(tk, (1000,), lo, hi).numpy(),
                                      np.asarray(jax.random.randint(jk, (1000,), lo, hi)))
    np.testing.assert_array_equal(P.randint(tk, (4, 5), 0, 9).numpy(),
                                  np.asarray(jax.random.randint(jk, (4, 5), 0, 9)))
    with pytest.raises(OverflowError):
        P.randint(tk, (3,), 0, 2**31)


def test_spawn_and_key_from_jax():
    jk = jax.random.fold_in(jax.random.PRNGKey(9), 3)
    tk = convert.key_from_jax(np.asarray(jk), device="cpu")
    got, want = spawn(tk, 1000, 2048), jax_spawn(jk, 1000, 2048)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    with pytest.raises(TypeError):
        convert.key_from_jax(np.zeros(3, np.uint32), device="cpu")


def test_cuda_key_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal path cannot be exercised")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.PRNGKey(0)


def test_stacked_keys_are_vmapped_draws():
    """A stack of keys draws each key's numbers in one hash (the port's
    batched form of ``jax.vmap``)."""
    jks = jax.random.split(jax.random.PRNGKey(3), 3)
    tks = P.split(P.PRNGKey(3, device="cpu"), 3)
    np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
    want = jax.vmap(lambda k: jax.random.randint(k, (5, 7), -3, 100))(jks)
    np.testing.assert_array_equal(P.randint(tks, (5, 7), -3, 100).numpy(), np.asarray(want))
    np.testing.assert_array_equal(P.split(tks, 2).numpy(),
                                  np.asarray(jax.vmap(jax.random.split)(jks)))


def _jax_randint_of_split(key, shape, lo, hi):
    """``jax.random.randint`` of each half of ``jax.random.split(key)``, for a
    key or a stack of keys: (..., 2, *shape)."""
    one = lambda k: jax.vmap(lambda h: jax.random.randint(h, shape, lo, hi))(  # noqa: E731
        jax.random.split(k))
    for _ in range(key.ndim - 1):
        one = jax.vmap(one)
    return np.asarray(one(key))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 2048), (-7, 2049), (-1024, -3), (5, 5), (9, 2),
                                   (-2**31, 2**31 - 1)])
def test_randint_of_split_matches_reference(seed, lo, hi):
    """The fused draw's plain path (``_randint_of_split``: the spawn's
    ``randint(split(key))``) against JAX's, int32 and as the spawn's
    float32, for spans with negative and empty ranges."""
    jk, tk = _key(seed)
    for shape in ((1000,), (4, 9), (0,)):
        want = _jax_randint_of_split(jk, shape, lo, hi)
        got = P._randint_of_split(tk, shape, lo, hi)
        assert got.dtype == torch.int32 and tuple(got.shape) == (2,) + shape
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(P._randint_of_split(tk, shape, lo, hi, torch.float32)
                                      .numpy(), want.astype(np.float32))


@pytest.mark.parametrize("stack", [(3,), (2, 2)])
def test_randint_of_split_on_stacks_of_keys(stack):
    jk = jax.random.split(jax.random.PRNGKey(17), int(np.prod(stack))).reshape(stack + (2,))
    tk = torch.from_numpy(np.asarray(jk).copy())
    assert tk.dtype == torch.uint32
    want = _jax_randint_of_split(jk, (50,), -3, 100)
    got = P._randint_of_split(tk, (50,), -3, 100)
    assert tuple(got.shape) == stack + (2, 50)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_spawn_matches_reference(seed):
    jk, tk = _key(seed)
    for n, res in ((1000, 2048), (250, 1024), (1, 7)):
        got, want = spawn(tk, n, res), jax_spawn(jk, n, res)
        for f in got._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
