"""The port's sharding rules against the reference's (on the CPU).

``repro_torch.parallel`` gives every leaf of a parameter tree, a dense
decode cache, a paged pool and a batch the spec the reference's
``param_shardings`` / ``cache_shardings`` / ``paged_pool_shardings`` /
``batch_shardings`` give it: for every registry arch's reduced tree, on a
(data 2, model 2) and a (model 4) abstract mesh, at fsdp scopes "all" and
"none", by path. The reference trees are traced shapes
(``jax.eval_shape``), so no JAX weight is computed.

``shard_tree`` then slices one rank's shard; concatenating the shards
gives back the single-device tree byte for byte after dequantization,
including a row-parallel cut inside a quantization block (sub-blocks),
decoded double-quantized scales (nf4), a vocabulary-split int8
embedding and QKV biases that follow their weights' columns.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduce_config as j_reduce_config  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core import resolve_spec as j_resolve_spec  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.parallel import sharding as j_sharding  # noqa: E402
from repro_torch.configs import REGISTRY, get_config, reduce_config  # noqa: E402
from repro_torch.core import quantize_tree, resolve_spec  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel import (batch_axes, batch_specs, cache_specs,  # noqa: E402
                                  paged_pool_specs, param_specs, shard_tree)
from repro_torch.tree import flat_leaves  # noqa: E402

ARCHS = sorted(REGISTRY)
MESHES = {"data2-model2": ((2, 2), ("data", "model")), "model4": ((4,), ("model",))}
PAGED = ("dense", "moe", "encdec", "audio")


def _ref_specs(shardings) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return {jax.tree_util.keystr(k): tuple(s.spec) for k, s in flat}


def _port_params(arch, spec):
    cfg = reduce_config(get_config(arch))
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    return cfg, quantize_tree(params, resolve_spec(spec).policy())


def _ref_params(arch, spec):
    cfg = j_reduce_config(J_REGISTRY[arch])
    model = j_build_model(cfg)
    policy = j_resolve_spec(spec).policy()
    return model, jax.eval_shape(lambda k: j_quantize_tree(model.init(k), policy),
                                 jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    """Every leaf of the reduced tree, int4 (packed codes and f32 scales)
    and nf4 (double-quantized scales), at both fsdp scopes and expert
    modes: the same paths and the same specs."""
    jmesh = AbstractMesh(*MESHES[mesh])
    for spec in ("int4", "nf4"):
        _, tree = _port_params(arch, spec)
        _, jtree = _ref_params(arch, spec)
        for fsdp in ("all", "none"):
            for mode in ("expert", "tensor"):
                want = _ref_specs(j_sharding.param_shardings(jmesh, jtree, mode, fsdp))
                got = param_specs(tree, jmesh, expert_mode=mode, fsdp_scope=fsdp)
                assert got == want, (spec, fsdp, mode)
    assert any(s for s in want.values())        # something is split


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, mesh):
    """The dense decode cache (int8 and bf16 KV) and, for the attention
    families, the paged pool: the same paths and specs as the
    reference's ``cache_shardings`` / ``paged_pool_shardings``."""
    jmesh = AbstractMesh(*MESHES[mesh])
    cfg = reduce_config(get_config(arch))
    model = build_model(cfg, "cpu")
    jmodel = j_build_model(j_reduce_config(J_REGISTRY[arch]))
    for kv in ("int8", "bf16"):
        got = cache_specs(model.init_cache(4, 16, kv), jmesh)
        jc = jax.eval_shape(lambda: jmodel.init_cache(4, 16, kv))
        assert got == _ref_specs(j_sharding.cache_shardings(jmesh, jc)), kv
        if cfg.family in PAGED:
            got = paged_pool_specs(model.init_paged_cache(4, 4, 9, 4, kv), jmesh)
            jc = jax.eval_shape(lambda: jmodel.init_paged_cache(4, 4, 9, 4, kv))
            assert got == _ref_specs(j_sharding.paged_pool_shardings(jmesh, jc)), kv


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_equal_reference(mesh):
    jmesh = AbstractMesh(*MESHES[mesh])
    rng = np.random.default_rng(0)
    batch = {"src_tokens": rng.integers(0, 9, (4, 7)), "tgt_in": rng.integers(0, 9, (3, 5)),
             "lengths": rng.integers(0, 9, (4,)), "img_embeds": rng.standard_normal((2, 4, 8))}
    want = _ref_specs(j_sharding.batch_shardings(jmesh, {k: jax.numpy.asarray(v)
                                                         for k, v in batch.items()}))
    assert batch_specs({k: torch.as_tensor(v) for k, v in batch.items()}, jmesh) == want
    assert batch_axes(jmesh) == j_sharding.batch_axes(jmesh)


def _logical(leaf):
    """A leaf's values as the model reads them: QTensors dequantized in
    f32, a layer-stacked one layer by layer (``QTensor.select``)."""
    if not isinstance(leaf, QTensor):
        return leaf
    if leaf.data.ndim < 3:
        return leaf.dequantize(torch.float32)
    return torch.stack([leaf.select(i).dequantize(torch.float32)
                        for i in range(leaf.data.shape[0])])


def _owns_storage(leaf) -> bool:
    ts = (leaf.data, leaf.scales) if isinstance(leaf, QTensor) else (leaf,)
    return all(t.untyped_storage().nbytes() == t.numel() * t.element_size()
               for t in ts if t is not None)


def _check_round_trip(tree, specs, axes):
    """Shards of every rank concatenate back to ``tree``'s values, leaf
    for leaf, byte for byte."""
    ranks = int(np.prod(list(axes.values())))
    shards = [shard_tree(tree, specs, r, axes) for r in range(ranks)]
    names = list(axes)

    def coords(r):
        out = {}
        for n in reversed(names):
            r, out[n] = divmod(r, axes[n])
        return out

    def walk(full, parts, keys):
        if isinstance(full, dict):
            for k in full:
                walk(full[k], [p[k] for p in parts], keys + (k,))
            return
        if full is None:
            assert all(p is None for p in parts)
            return
        path = "".join(f"[{k!r}]" for k in keys)
        spec = specs.get(path + ".data" if isinstance(full, QTensor) else path, ())
        if keys[-1].startswith("bias_"):
            wspec = specs.get(path.replace("['bias_", "['w") + ".data", ())
            spec = (None,) * (full.ndim - 1) + (wspec[-1] if wspec else None,)
        want = _logical(full)
        # rebuild along every split dim: ranks in coordinate order
        spec = tuple(spec) + (None,) * (want.ndim - len(spec))
        if any(ax is not None for ax in spec):  # no view keeps the whole alive
            assert all(_owns_storage(p) for p in parts), path
        got = {}
        for r, p in enumerate(parts):
            c = coords(r)
            key = tuple(c[ax] if ax is not None else 0 for ax in spec)
            got[key] = _logical(p)
        for d in reversed(range(want.ndim)):
            if spec[d] is None:
                continue
            merged = {}
            for key in sorted(got):
                merged.setdefault(key[:d] + (0,) + key[d + 1:], []).append(got[key])
            got = {k: torch.cat(v, dim=d) for k, v in merged.items()}
        (rebuilt,) = got.values()
        assert rebuilt.dtype == want.dtype and rebuilt.shape == want.shape, path
        assert torch.equal(rebuilt.contiguous().view(torch.uint8),
                           want.contiguous().view(torch.uint8)), path

    walk(tree, shards, ())
    return shards


@pytest.mark.parametrize("spec", ["int4", "fp4", "nf4", "int8"])
@pytest.mark.parametrize("mesh", [{"model": 2}, {"model": 4}, {"data": 2, "model": 2}])
def test_shard_tree_round_trip(spec, mesh):
    """nllb600m reduced: column- and row-parallel projections, the
    vocabulary-split int8 embedding; w_out's K 96 is one int4 block, cut
    at 48 (tp2) or 24 (tp4) into sub-blocks that inherit its scale; nf4's
    double-quantized scales are decoded to f32 first."""
    cfg, tree = _port_params("nllb600m", spec)
    specs = param_specs(tree, mesh, fsdp_scope="all")
    shards = _check_round_trip(tree, specs, mesh)
    w_out = shards[0]["decoder"]["layers"]["mlp"]["w_out"]
    emb = shards[0]["embedding"]
    tp = mesh["model"]
    assert emb.shape[0] == cfg.vocab_size // tp and emb.data.shape[0] == cfg.vocab_size // tp
    assert w_out.shape[-2] == cfg.d_ff // tp
    if spec != "int8" and "data" not in mesh:   # (b): one 96-block -> sub-blocks
        assert w_out.scales_shape[-2] == 1 and w_out.shape[-2] == 96 // tp
    if spec == "nf4":                           # (c): f32 scales, no packed ones
        assert w_out.scales is not None and w_out.scales_q is None
        assert tree["decoder"]["layers"]["mlp"]["w_out"].scales is None


def test_biases_follow_their_weights():
    """qwen2.5-14b reduced (QKV biases): each rank's bias_q/k/v is the
    slice of its wq/wk/wv's columns."""
    _, tree = _port_params("qwen2.5-14b", "int4")
    layer = tree["layers"]["attn"]
    assert "bias_q" in layer
    specs = param_specs(tree, {"model": 2}, fsdp_scope="none")
    shards = _check_round_trip(tree, specs, {"model": 2})
    for name in ("q", "k", "v"):
        s = shards[1]["layers"]["attn"]
        assert s[f"bias_{name}"].shape[-1] == s[f"w{name}"].shape[-1]


def test_flat_leaves_spell_the_reference_paths():
    _, tree = _port_params("nllb600m", "nf4")
    _, jtree = _ref_params("nllb600m", "nf4")
    want = {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert {p: tuple(t.shape) for p, t in flat_leaves(tree)} == want
