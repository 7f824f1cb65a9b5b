"""Bridge between the JAX package and the PyTorch port for the parity tests.

``jax_tree_to_numpy`` flattens a JAX parameter tree (QTensors included)
into the nested-dict-of-numpy form that ``repro_torch.convert`` reads;
``same_bytes`` compares a JAX array with a torch tensor byte for byte.
The tests here check the bridge itself.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import QTensor as JQTensor  # noqa: E402
from repro_torch.convert import from_numpy_tree, to_torch  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402

_QT_FIELDS = ("data", "scales", "scales_q", "scales_cscale", "scales_offset",
              "lora_a", "lora_b")


def jax_tree_to_numpy(tree):
    """JAX params (nested dicts, arrays, QTensors) -> numpy form."""
    if isinstance(tree, JQTensor):
        out = {f: None if getattr(tree, f) is None else np.asarray(getattr(tree, f))
               for f in _QT_FIELDS}
        out.update(fmt=tree.fmt, q_axis=tree.q_axis, shape=tuple(tree.shape),
                   scales_shape=tuple(tree.scales_shape))
        return out
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_to_torch(tree, device="cpu"):
    return from_numpy_tree(jax_tree_to_numpy(tree), device)


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
