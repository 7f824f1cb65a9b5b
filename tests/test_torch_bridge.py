"""Bridge between the JAX package and the PyTorch port for the parity tests.

``jax_tree_to_numpy`` flattens a JAX parameter tree (QTensors included)
into the nested-dict-of-numpy form that ``repro_torch.convert`` reads;
``same_bytes`` compares a JAX array with a torch tensor byte for byte;
``exact_fp8_reference`` runs the reference with its f32 -> float8 e4m3
conversions rounded once (see there). The tests here check the bridge
itself.

A pytest run of the port's tests imports this module while it collects
(most port test files import it, and each pytest-xdist worker of a whole
run collects every test file), so it also sets torch's intra-op threads
to one for the process: the port's CPU tests run on tiny tensors in
several worker processes that share the host's cores, and torch's
default of a thread a core leaves each worker's idle OpenMP threads
spinning beside the other workers' JAX compiles and port runs (the
port's rank processes run one thread for the same reason,
``cluster.launch_ranks``).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import QTensor as JQTensor  # noqa: E402
from repro_torch.convert import from_numpy_tree, to_torch  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402

torch.set_num_threads(1)

_QT_FIELDS = ("data", "scales", "scales_q", "scales_cscale", "scales_offset",
              "lora_a", "lora_b")


def jax_tree_to_numpy(tree):
    """JAX params or optimizer state (nested dicts, arrays, QTensors, None
    leaves) -> numpy form."""
    if tree is None:
        return None
    if isinstance(tree, JQTensor):
        out = {f: None if getattr(tree, f) is None else np.asarray(getattr(tree, f))
               for f in _QT_FIELDS}
        out.update(fmt=tree.fmt, q_axis=tree.q_axis, shape=tuple(tree.shape),
                   scales_shape=tuple(tree.scales_shape), lora_alpha=tree.lora_alpha)
        return out
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_to_torch(tree, device="cpu"):
    return from_numpy_tree(jax_tree_to_numpy(tree), device)


def torch_to_jax(tree):
    """A nested dict of float32 / int tensors -> the same tree of JAX
    arrays (a port's raw parameter tree for the reference)."""
    if isinstance(tree, dict):
        return {k: torch_to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def same_bytes(jax_arr, t) -> bool:
    a = np.ascontiguousarray(np.asarray(jax_arr))
    if tuple(a.shape) != tuple(t.shape) or a.dtype.itemsize != t.element_size():
        return False
    return a.tobytes() == t.contiguous().view(torch.uint8).numpy().tobytes()


def tree_same_bytes(jax_tree, torch_tree, path=""):
    """Assert two (possibly quantized) trees are byte-identical leaf for leaf."""
    if isinstance(jax_tree, JQTensor):
        assert isinstance(torch_tree, QTensor), path
        assert (jax_tree.fmt, jax_tree.q_axis, tuple(jax_tree.shape),
                tuple(jax_tree.scales_shape)) == (
            torch_tree.fmt, torch_tree.q_axis, tuple(torch_tree.shape),
            tuple(torch_tree.scales_shape)), path
        for f in QTensor._CHILDREN:
            a, b = getattr(jax_tree, f), getattr(torch_tree, f)
            assert (a is None) == (b is None), (path, f)
            if a is not None:
                assert same_bytes(a, b), (path, f)
        return
    if isinstance(jax_tree, dict):
        assert sorted(jax_tree) == sorted(torch_tree), path
        for k in jax_tree:
            tree_same_bytes(jax_tree[k], torch_tree[k], f"{path}['{k}']")
        return
    assert same_bytes(jax_tree, torch_tree), path


def exact_fp8(y):
    """f32 -> float8 e4m3fn rounded once to nearest even, in jnp: y is
    rounded on the e4m3 grid (3 mantissa bits, subnormal step 2**-9) in
    f32, so the final cast is exact. ``|y| <= 448``."""
    _, e = jnp.frexp(y)
    step = jnp.ldexp(jnp.float32(1.0), jnp.maximum(e, -5) - 4)
    return (jnp.round(y / step) * step).astype(jnp.float8_e4m3fn)


@contextlib.contextmanager
def exact_fp8_reference():
    """The reference with its f32 -> fp8 casts (activation codes and fp8
    KV codes) rounded once, as ``astype`` defines them and as eager JAX,
    ml_dtypes and torch round. XLA's CPU backend rounds such a cast inside
    some fused loops through f16 first (two roundings), so a compiled
    reference engine parts from its own eager semantics at some fp8
    midpoints; the formulas are otherwise the reference's own."""
    import repro.core.qlinear as jql
    import repro.models.encdec as jed
    import repro.models.layers as jlayers
    import repro.models.transformer as jtf
    orig = jql.quantize_activations

    def quantize_activations(x, fmt="int8", scale=None):
        if fmt != "fp8":
            return orig(x, fmt, scale)
        if scale is None:
            absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1, keepdims=True)
            scale = jnp.where(absmax == 0, 1.0, absmax / 448.0)
        else:
            scale = jnp.asarray(scale, jnp.float32)
        q = exact_fp8(jnp.clip(x.astype(jnp.float32) / scale, -448.0, 448.0))
        return q, scale.astype(jnp.float32)

    def fp8_token_kv(t):
        absmax = jnp.max(jnp.abs(t.astype(jnp.float32)), axis=-1)
        scales = jnp.where(absmax == 0, 1.0, absmax / 448.0)
        return exact_fp8(t / scales[..., None]), scales.astype(jnp.float32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jql, "quantize_activations", quantize_activations)
        mp.setattr(jlayers, "quantize_activations", quantize_activations)
        mp.setattr(jtf, "_fp8_token_kv", fp8_token_kv)
        mp.setattr(jed, "_fp8_token_kv", fp8_token_kv)
        yield


def test_exact_fp8_rounds_once():
    """exact_fp8 equals ml_dtypes' (and torch's) direct conversion on
    values across the e4m3 range, subnormals and midpoints included."""
    import ml_dtypes
    rng = np.random.default_rng(5)
    y = rng.standard_normal(50000) * np.exp(rng.standard_normal(50000) * 3)
    grid = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    grid = np.sort(grid[np.isfinite(grid)])
    mids = (grid[1:] + grid[:-1]) / 2
    y = np.clip(np.concatenate([y, grid, mids]), -448, 448).astype(np.float32)
    want = y.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = np.asarray(jax.jit(exact_fp8)(jnp.asarray(y))).view(np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        torch.from_numpy(y).to(torch.float8_e4m3fn).view(torch.uint8).numpy(), want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.float8_e4m3fn,
                                   jnp.int8, jnp.uint8, jnp.int32])
def test_to_torch_is_bit_exact(dtype):
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((3, 5)) * 4).astype(dtype)
    t = to_torch(np.asarray(a))
    assert same_bytes(a, t)


def test_quantized_stacked_tree_round_trip():
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((2, 64, 32)), jnp.float32)
    tree = {"layers": {"w": JQTensor.quantize(w, "nf4", 32, double_quant=True),
                       "norm_scale": jnp.ones((2, 32), jnp.bfloat16)}}
    tt = jax_to_torch(tree)
    tree_same_bytes(tree, tt)
    assert tt["layers"]["w"].select(1).block_scales().shape == (2, 32)
