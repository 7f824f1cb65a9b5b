"""QLoRA adapters in the port: attached, carried across by the weight
bridge, merged, and served (smoke nllb600m, f32).

Parity tests start from adapters the JAX package attached (with a B made
non-zero, so the adapter term shows), converted to torch, never from a
second RNG. Tolerances: adapter tensors and byte counts equal; merged
weights within 1e-6 and adapted products within 1e-5 of the reference;
an adapted FFN input within 1e-5 of relu(x @ W + lora) — the FASST
activation never rides in qmm's epilogue for an adapted weight, since the
adapter term is added after the product; greedy streams token for token.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch, tree_same_bytes  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.core import QTensor as JQTensor  # noqa: E402
from repro.core import attach_lora as j_attach_lora  # noqa: E402
from repro.core import count_adapter_params as j_count  # noqa: E402
from repro.core import extract_adapters as j_extract  # noqa: E402
from repro.core import inject_adapters as j_inject  # noqa: E402
from repro.core import merge_lora as j_merge_lora  # noqa: E402
from repro.core import qmatmul as j_qmatmul  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core import resolve_spec as j_resolve  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro.serving import impl_routes as j_impl_routes  # noqa: E402
from repro_torch.core import (attach_lora, count_adapter_params, extract_adapters,  # noqa: E402
                              inject_adapters, merge_lora, qmatmul, quantize_tree,
                              resolve_spec, tree_nbytes)
from repro_torch.models.layers import Ctx, fuses_naf, mlp  # noqa: E402
from repro_torch.serving import SamplingParams, deploy, impl_routes  # noqa: E402

CFG = reduce_config(REGISTRY["nllb600m"])
KW = dict(smoke=True, slots=3, max_len=16, page_size=4, horizon=4, paged=True)


@pytest.fixture(scope="module")
def raw_params():
    return j_build_model(CFG).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def adapted(raw_params):
    """int4-quantized smoke params with rank-16 JAX adapters on every
    matmul, B non-zero: (JAX tree, torch tree)."""
    qj = j_quantize_tree(raw_params, j_resolve("int4").policy())
    qj = j_attach_lora(qj, jax.random.PRNGKey(1), rank=16)
    rng = np.random.default_rng(1)

    def fill(node):
        if isinstance(node, dict) and set(node) == {"a", "b"}:
            return {"a": node["a"],
                    "b": jnp.asarray(rng.standard_normal(node["b"].shape) * 0.05, jnp.float32)}
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return node
    qj = j_inject(qj, fill(j_extract(qj)))
    return qj, jax_to_torch(qj)


def test_bridge_carries_adapters(adapted):
    """Adapter tensors, alpha and byte counts cross the bridge unchanged."""
    qj, qt = adapted
    tree_same_bytes(qj, qt)
    wj, wt = qj["decoder"]["layers"]["mlp"]["w_in"], qt["decoder"]["layers"]["mlp"]["w_in"]
    assert wt.lora_alpha == wj.lora_alpha and wt.lora_a.shape[-1] == 16
    assert wt.nbytes() == wj.nbytes()
    assert tree_nbytes(qt) == sum(
        leaf.nbytes() if isinstance(leaf, JQTensor) else leaf.size * leaf.dtype.itemsize
        for leaf in jax.tree_util.tree_leaves(qj, is_leaf=lambda x: isinstance(x, JQTensor)))
    layer = wt.select(1)
    assert torch.equal(layer.lora_b, wt.lora_b[1])


def test_attach_lora_targets_and_init(raw_params):
    """The port's attach_lora adapts the reference's targets: gaussian A
    at 1/sqrt(K), zero B; extract / inject round-trip; equal counts."""
    qj = j_attach_lora(j_quantize_tree(raw_params, j_resolve("int4").policy()),
                       jax.random.PRNGKey(1), rank=8)
    qt = quantize_tree(jax_to_torch(raw_params), resolve_spec("int4").policy())
    qt = attach_lora(qt, torch.Generator().manual_seed(1), rank=8)
    ad = extract_adapters(qt)
    assert count_adapter_params(ad) == j_count(j_extract(qj))
    a = ad["encoder"]["layers"]["attn"]["wq"]["a"]
    assert a.shape == (CFG.enc_layers, CFG.d_model, 8)
    assert abs(a.std().item() * CFG.d_model ** 0.5 - 1) < 0.2
    assert not ad["decoder"]["layers"]["mlp"]["w_out"]["b"].any()
    assert ad["embedding"] is None
    back = extract_adapters(inject_adapters(qt, ad))
    assert torch.equal(back["decoder"]["layers"]["cross"]["wv"]["a"],
                       ad["decoder"]["layers"]["cross"]["wv"]["a"])


@pytest.mark.parametrize("fmt", ["int4", "nf4", "int8"])
def test_merge_lora_equals_reference(fmt):
    rng = np.random.default_rng(2)
    w = JQTensor.quantize(jnp.asarray(rng.standard_normal((64, 32)) * 0.1, jnp.float32), fmt, 32)
    w = w.with_lora(jnp.asarray(rng.standard_normal((64, 4)), jnp.float32),
                    jnp.asarray(rng.standard_normal((4, 32)) * 0.1, jnp.float32), alpha=8.0)
    got = merge_lora(jax_to_torch({"w": w})["w"], torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_merge_lora(w, jnp.float32)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("act", ["bf16", "int8"])
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_adapted_qmatmul_equals_reference(adapted, impl, act):
    """The adapter term from the unquantized x, added after the product of
    either route (the qmm kernel's plain version here)."""
    qj, qt = adapted
    wj = jax.tree_util.tree_map(lambda t: t[0], qj["decoder"]["layers"]["attn"]["wq"])
    wt = qt["decoder"]["layers"]["attn"]["wq"].select(0)
    x = np.random.default_rng(3).standard_normal((2, 3, CFG.d_model)).astype(np.float32)
    want = jax.jit(lambda v: j_qmatmul(v, wj, act=act, compute_dtype=jnp.float32,
                                       impl="pallas" if impl == "kernel" else "xla"))(
        jnp.asarray(x))
    got = qmatmul(torch.from_numpy(x), wt, act=act, compute_dtype=torch.float32, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_adapted_w_in_is_never_fused(adapted):
    """At decode rows with the FASST kernel on and the qmm route, an
    unadapted w_in fuses its NAF into qmm's epilogue; an adapted one does
    not, and the FFN computes relu(x @ W + lora) @ W_out + lora_out."""
    _, qt = adapted
    lp = {k: v.select(0) for k, v in qt["decoder"]["layers"]["mlp"].items()}
    ctx = Ctx(compute_dtype=torch.float32, matmul_impl="kernel", use_fasst_kernel=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 1, CFG.d_model))
                         .astype(np.float32))
    bare = lp["w_in"].with_lora(None, None)
    assert fuses_naf(ctx, bare, x) and not fuses_naf(ctx, lp["w_in"], x)
    got = mlp(ctx, lp, x, CFG.mlp_act, site="dec.ffn")

    def plain(x, w):                 # qmm's product (bf16 operands), then the term
        lora = (x @ w.lora_a) @ w.lora_b * (w.lora_alpha / w.lora_a.shape[-1])
        return qmatmul(x, w.with_lora(None, None), compute_dtype=torch.float32,
                       impl="kernel") + lora
    want = plain(torch.relu(plain(x, lp["w_in"])), lp["w_out"])
    assert CFG.mlp_act == "relu"
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="adapters"):
        ctx.dot(x, lp["w_in"], naf="relu")


def test_adapted_streams_equal_reference(raw_params, adapted):
    """int4 with non-zero rank-16 adapters: the port's "kernels" bundle
    streams the JAX "pallas" engine's tokens (paged)."""
    qj, qt = adapted
    rng = np.random.default_rng(0)
    prompts = [{"src_tokens": rng.integers(16, 256, (1, 6)).astype(np.int32),
                "tgt_in": np.full((1, 1), c, np.int32)} for c in (8, 1, 7)]
    jpipe = j_deploy("nllb600m", "int4", params=qj, **KW, **j_impl_routes("pallas"))
    want = [list(o.token_ids) for o in jpipe.generate(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in prompts],
        JSamplingParams(max_new_tokens=6))]
    pipe = deploy("nllb600m", "int4", params=qt, device="cpu", **KW, **impl_routes("kernels"))
    assert pipe.params["decoder"]["layers"]["mlp"]["w_in"].lora_a is not None
    outs = pipe.generate(prompts, SamplingParams(max_new_tokens=6))
    assert [o.token_ids for o in outs] == want
    unadapted = deploy("nllb600m", "int4", params=jax_to_torch(raw_params),
                       device="cpu", **KW)
    assert [o.token_ids for o in unadapted.generate(
        prompts, SamplingParams(max_new_tokens=6))] != want
