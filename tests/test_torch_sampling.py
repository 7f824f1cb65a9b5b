"""Sampled decoding parity on the CPU: the port's threefry bits equal
``jax.random``'s bit for bit, and its sampler draws the JAX sampler's
tokens on the same logits, keys and offsets. The engines' seeded
streams are held against the JAX engines in test_torch_serving.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import sampler as j_sampler  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402

SEEDS = [0, 1, 12345, 2 ** 31 - 1]


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_bits_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    for data in (0, 1, 7, 255, 2 ** 31):
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(),
                                      _words(jax.random.fold_in(jk, data)))
    for shape in ((1,), (7,), (3, 5), (256204,)):
        np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(),
                                      _words(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(prng.uniform(tk, (1001,)).numpy(),
                                  np.asarray(jax.random.uniform(jk, (1001,))))


def test_batched_keys_fold_in_per_row():
    """One key per slot, one offset per slot: row i equals the single-key
    computation on key i."""
    seeds, offsets = [3, 4, 5], [0, 1, 9]
    keys = torch.stack([prng.prng_key(s) for s in seeds])
    folded = prng.fold_in(keys, torch.tensor(offsets))
    bits = prng.random_bits(folded, (50,))
    for i, (s, o) in enumerate(zip(seeds, offsets)):
        jk = jax.random.fold_in(jax.random.PRNGKey(s), o)
        np.testing.assert_array_equal(folded[i].numpy(), _words(jk))
        np.testing.assert_array_equal(bits[i].numpy(), _words(jax.random.bits(jk, (50,))))


def test_gumbel_within_one_ulp_of_jax():
    tk, jk = prng.prng_key(6), jax.random.PRNGKey(6)
    g = prng.gumbel(tk, (4096,)).numpy()
    jg = np.asarray(jax.random.gumbel(jk, (4096,)))
    np.testing.assert_allclose(g, jg, rtol=2.0 ** -22, atol=2.0 ** -22)


def test_sample_tokens_equal_jax_on_mixed_rows():
    """64 rows mixing greedy, temperature, top-k and top-p, with per-row
    keys and offsets."""
    rng = np.random.default_rng(0)
    S, V = 64, 1000
    logits = (rng.standard_normal((S, V)) * 3).astype(np.float32)
    temps = rng.choice([0.0, 0.5, 0.7, 1.0, 1.5], S).astype(np.float32)
    top_ks = rng.choice([0, 1, 5, 50], S).astype(np.int32)
    top_ps = rng.choice([1.0, 0.9, 0.5, 0.1], S).astype(np.float32)
    seeds = rng.integers(0, 2 ** 31 - 1, S)
    offsets = rng.integers(0, 40, S).astype(np.int32)
    jkeys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    want = np.asarray(j_sampler.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps), jkeys, jnp.asarray(offsets)))
    keys = torch.stack([prng.prng_key(int(s)) for s in seeds])
    got = sampler.sample_tokens(torch.from_numpy(logits), torch.from_numpy(temps),
                                torch.from_numpy(top_ks), torch.from_numpy(top_ps),
                                keys, torch.from_numpy(offsets))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = temps <= 0
    np.testing.assert_array_equal(got.numpy()[greedy], logits[greedy].argmax(-1))


def test_sampler_guard_and_pad():
    lg = torch.randn(3, 16)
    lg[1, 4] = float("nan")
    z = torch.zeros(3)
    toks = sampler.sample_tokens_scan(lg, z + 0.7, z.long(), z + 1.0,
                                      torch.zeros(3, 2, dtype=torch.int64),
                                      z.long(), torch.tensor([1, 1, 0]), pad_id=5)
    assert toks[1] == sampler.ERR_TOKEN and toks[2] == 5 and 0 <= toks[0] < 16


def test_all_greedy_shortcut_gives_the_sampled_path_tokens():
    """``all_greedy`` skips the filter and the draw; on rows that are all
    greedy it returns what the full sampler returns, guard and pad kept."""
    lg = torch.randn(6, 300, generator=torch.Generator().manual_seed(2))
    lg[4, 7] = float("inf")
    z = torch.zeros(6)
    keys = torch.stack([prng.prng_key(s) for s in range(6)])
    args = (lg, z, z.long() + 5, z + 0.9, keys, z.long() + 3)
    full = sampler.sample_tokens(*args)
    np.testing.assert_array_equal(sampler.sample_tokens(*args, all_greedy=True).numpy(),
                                  full.numpy())
    assert full[4] == sampler.ERR_TOKEN
    alive = torch.tensor([1, 1, 0, 1, 1, 0])
    np.testing.assert_array_equal(
        sampler.sample_tokens_scan(*args, alive, pad_id=9, all_greedy=True).numpy(),
        torch.where(alive > 0, full, 9).numpy())
