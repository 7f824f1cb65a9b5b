"""Quantization parity: the port's codes and scales are byte-identical to
the JAX package's, for every format, blockwise and double-quantized, on
plain tensors and on the smoke NLLB parameter tree."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch, same_bytes, tree_same_bytes  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.core import QTensor as JQTensor  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core.spec import ALIASES as J_ALIASES  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.core import QTensor, quantize as tq  # noqa: E402
from repro_torch.core import quantize_tree, resolve_spec  # noqa: E402
from repro_torch.core.formats import FORMATS  # noqa: E402

FMTS = ["int4", "fp4", "nf4", "int8", "fp8"]


def _weights(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _ties(fmt):
    """One (64, 8) block grid whose values sit exactly on the format's
    rounding ties / codebook boundaries (absmax chosen so x/scale is exact)."""
    f = FORMATS[fmt]
    if f.kind == "codebook":
        vals = np.concatenate([f.boundaries(), f.codebook, [-0.0]])
    elif f.kind == "int":
        vals = np.arange(-f.max_code, f.max_code + 0.5, 0.5)
    else:
        vals = np.array([448.0, -448.0, 0.0, 1.0625, 3.25, -17.5])
    col = np.resize(vals.astype(np.float32), 64)
    col[0] = f.max_code                        # absmax -> scale exactly 1
    return np.tile(col[:, None], (1, 8))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("shape,block,q_axis", [
    ((128, 48), 64, -2), ((96, 32), 0, -2), ((3, 64, 40), 32, -2),
    ((40, 64), 16, -1)])
def test_blockwise_codes_and_scales_byte_equal(fmt, shape, block, q_axis):
    w = _weights(shape)
    jc, js = jq.quantize_blockwise(jnp.asarray(w), fmt, block, q_axis)
    tc, ts = tq.quantize_blockwise(torch.from_numpy(w), fmt, block, q_axis)
    assert same_bytes(jc, tc) and same_bytes(js, ts)
    jd = jq.dequantize_blockwise(jc, js, fmt, q_axis, out_dtype=jnp.float32)
    td = tq.dequantize_blockwise(tc, ts, fmt, q_axis, out_dtype=torch.float32)
    assert same_bytes(jd, td)


@pytest.mark.parametrize("fmt", FMTS)
def test_rounding_ties_byte_equal(fmt):
    """Half-to-even rounding and the searchsorted tie side agree."""
    w = _ties(fmt)
    jc, js = jq.quantize_blockwise(jnp.asarray(w), fmt, 64)
    tc, ts = tq.quantize_blockwise(torch.from_numpy(w), fmt, 64)
    assert same_bytes(jc, tc) and same_bytes(js, ts)


@pytest.mark.parametrize("shape", [(256, 96), (2, 128, 80)])
def test_nf4_double_quant_byte_equal(shape):
    w = _weights(shape, seed=3)
    jt = JQTensor.quantize(jnp.asarray(w), "nf4", 64, double_quant=True)
    tt = QTensor.quantize(torch.from_numpy(w), "nf4", 64, double_quant=True)
    tree_same_bytes(jt, tt)
    assert same_bytes(jt.block_scales(), tt.block_scales())
    if len(shape) == 3:   # a layer slice expands its own scales
        layer = jax.tree_util.tree_map(lambda a: a[1], jt)
        assert same_bytes(layer.block_scales(), tt.select(1).block_scales())


@pytest.mark.parametrize("spec", ["int4", "fp4", "nf4", "int8", "fp8", "bf16",
                                  "w8a8", "fp8e2e"])
def test_quantize_tree_smoke_nllb_byte_equal(spec):
    cfg = reduce_config(REGISTRY["nllb600m"])
    raw = j_build_model(cfg).init(jax.random.PRNGKey(0))
    jtree = j_quantize_tree(raw, J_ALIASES[spec].policy())
    ttree = quantize_tree(jax_to_torch(raw), resolve_spec(spec).policy())
    tree_same_bytes(jtree, ttree)


def test_spec_grammar_matches_reference():
    for text in ["int4", "nf4", "w4a8kv8", "wfp4kv8e8g32dq", "w8a8kv8x8",
                 "wfp8e4m3afp8kvfp8"]:
        from repro.core import resolve_spec as j_resolve
        j, t = j_resolve(text), resolve_spec(text)
        assert str(j) == str(t)
        assert (j.weights, j.act, j.kv, j.attn, j.embed, j.group,
                j.double_quant) == (t.weights, t.act, t.kv, t.attn, t.embed,
                                    t.group, t.double_quant)
