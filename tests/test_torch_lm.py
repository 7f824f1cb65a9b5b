"""Decoder-only LM parity at smoke size (f32 compute, int4 weights): the
port's dense and VLM families (gemma3-1b, qwen2.5-14b, internlm2-20b,
nemotron-4-15b, llava-next-mistral-7b, reduced) against the JAX package's
on the same converted parameters, with the kernel routes on in both (the
port's wrappers run their plain versions on CPU tensors; the reference's
Pallas kernels run in interpret mode).

gemma3's sequences are longer than its reduced local window (8), so the
window truncates; llava's carry image embeddings. The reference's
compiled functions are compared (jax.jit), as its engines run them: XLA
turns the KV quantizer's division by 127 into a product with its f32
reciprocal, which is what the port computes.

Tolerance 1e-4 (``TOL`` of test_torch_model): both sides sum f32 products
in different orders; the bf16 rounding inside qmm is identical."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch, tree_same_bytes  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core.spec import ALIASES as J_ALIASES  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.serving.paged_cache import paged_insert as j_paged_insert  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.core import ALIASES, quantize_tree  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.random import prng_key  # noqa: E402
from repro_torch.serving.paged_cache import paged_insert  # noqa: E402

TOL = 1e-4
ARCHS = ["gemma3-1b", "qwen2.5-14b", "internlm2-20b", "nemotron-4-15b",
         "llava-next-mistral-7b"]
JCTX = JCtx(compute_dtype=jnp.float32, matmul_impl="pallas",
            paged_attn_impl="kernel", use_fasst_kernel=True)
CTX = Ctx(compute_dtype=torch.float32, matmul_impl="kernel",
          paged_attn_impl="kernel", use_fasst_kernel=True)
# the plain routes ("xla" / "torch") where a test holds the cache logic
JCTX_PLAIN = JCtx(compute_dtype=jnp.float32)
CTX_PLAIN = Ctx(compute_dtype=torch.float32)
B, S = 2, 12            # S > gemma3's reduced window of 8


def _cfgs(arch):
    return reduce_config(REGISTRY[arch]), t_reduce_config(get_config(arch))


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX config, port config, raw JAX params, int4 JAX params,
    int4 port params); raw params from the reference's own init."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        raw = j_build_model(jcfg).init(jax.random.PRNGKey(0))
        jp = j_quantize_tree(raw, J_ALIASES["int4"].policy())
        out[arch] = (jcfg, cfg, raw, jp, jax_to_torch(jp))
    return out


def _inputs(cfg, seed=0, S_=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32)
    img = None
    if cfg.family == "vlm":
        img = (0.1 * rng.standard_normal((B, cfg.num_patches, cfg.d_model))
               ).astype(np.float32)
    return toks, img


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_mirrors_reference(arch):
    jcfg, cfg = _cfgs(arch)
    assert cfg.__dict__.keys() == jcfg.__dict__.keys()
    assert all(getattr(cfg, k) == getattr(jcfg, k) for k in cfg.__dict__)
    assert all(getattr(get_config(arch), k) == getattr(REGISTRY[arch], k)
               for k in cfg.__dict__)
    # the enc-dec, MoE and audio configs: tests/test_torch_moe.py; the SSM
    # and hybrid configs: tests/test_torch_ssm.py
    assert set(T_REGISTRY) == set(ARCHS) | {"nllb600m", "nllb600m-moe", "olmoe-1b-7b",
                                            "moonshot-v1-16b-a3b", "whisper-base",
                                            "mamba2-780m", "recurrentgemma-9b"}
    assert list(T_REGISTRY) == list(REGISTRY)


def test_reduced_shapes():
    qwen, gemma = (t_reduce_config(get_config(a)) for a in ("qwen2.5-14b", "gemma3-1b"))
    assert (qwen.num_heads, qwen.num_kv_heads) == (4, 1)
    assert gemma.window_pattern == (8, 8, 8, 8, 8, 0)
    assert ttf.window_array(gemma) == [8, 8]
    assert ttf.window_array(dataclasses.replace(gemma, num_layers=7)) == [8] * 5 + [0, 8]
    assert ttf.window_array(qwen) == [0, 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_logits(models, arch):
    jcfg, cfg, _, jp, tp = models[arch]
    toks, img = _inputs(cfg)
    jl, _, _ = jtf.lm_forward(JCTX, jp, jcfg, jnp.asarray(toks), img_embeds=_j(img))
    tl, aux, kv = ttf.lm_forward(CTX, tp, cfg, _t(toks), img_embeds=_t(img))
    assert tl.shape == (B, S + cfg.num_patches, cfg.vocab_size) and kv is None
    assert float(aux) == 0.0
    _close(tl.numpy(), jl)


def _jit_prefill(jcfg, jctx=JCTX):
    return jax.jit(lambda p, t, c, lens: jtf.lm_prefill(jctx, p, jcfg, t, c,
                                                         lengths=lens))


def _jit_decode(jcfg, jctx=JCTX):
    return jax.jit(lambda p, t, c: jtf.lm_decode_step(jctx, p, jcfg, t, c))


def _prefill_both(models, arch, kv, max_len, lengths, seed=0, plain=False):
    jcfg, cfg, _, jp, tp = models[arch]
    jctx, ctx = (JCTX_PLAIN, CTX_PLAIN) if plain else (JCTX, CTX)
    toks, _ = _inputs(cfg, seed)
    lens = np.array(lengths, np.int32)
    jc = jtf.lm_init_cache(jcfg, B, max_len, kv)
    jc, jl = _jit_prefill(jcfg, jctx)(jp, jnp.asarray(toks), jc, jnp.asarray(lens))
    tc = ttf.lm_init_cache(cfg, B, max_len, kv, device="cpu")
    tc, tl = ttf.lm_prefill(ctx, tp, cfg, _t(toks), tc, lengths=_t(lens))
    _close(tl.numpy(), jl)
    return jc, jl, tc


def _cache_equal(tc, jc):
    """Cache leaves equal up to the f32 sum order: ``TOL`` for f32 K / V,
    one storage ulp where they round to bf16 (2^-8 relative), 1e-6 for
    the scales of int8 / fp8 codes (the codes themselves within it: equal)."""
    for key, v in jc.items():
        got = tc[key]
        tol = {torch.bfloat16: 2.0 ** -8, torch.float32: TOL}.get(got.dtype, 1e-6)
        if key.endswith("_scales") or key in ("pos", "len", "block_tables", "active"):
            tol = 1e-6
        if got.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            got = got.float()
        _close(got.numpy(), np.asarray(v).astype(np.float32), tol)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma3-1b"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_prefill_then_three_dense_decode_steps(models, arch, kv):
    """Prefill (ragged lengths) into a dense cache, then three decode
    steps fed the reference's greedy tokens; the third carries an
    ``active`` mask with slot 1 frozen. gemma3's decode positions pass
    its window. The plain routes on both sides (the kernel routes are
    held in the forward and paged tests)."""
    jcfg, cfg, _, jp, tp = models[arch]
    jc, jl, tc = _prefill_both(models, arch, kv, 16, [S, 9], plain=True)
    _cache_equal(tc, jc)
    tok = np.argmax(np.asarray(jl)[[0, 1], [S - 1, 8]], -1).astype(np.int32)[:, None]
    step = _jit_decode(jcfg, JCTX_PLAIN)
    for i in range(3):
        if i == 2:
            jc = dict(jc, active=jnp.asarray([1, 0], jnp.int32))
            tc = dict(tc, active=torch.tensor([1, 0], dtype=torch.int32))
        jc, jlog = step(jp, jnp.asarray(tok), jc)
        tc, tlog = ttf.lm_decode_step(CTX_PLAIN, tp, cfg, _t(tok), tc)
        _close(tlog.numpy(), jlog)
        _cache_equal(tc, jc)
        tok = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)[:, None]
    assert np.asarray(jc["len"]).tolist() == [S + 3, 11]


def _paged_both(models, arch, kv, lengths, seed=1, plain=False):
    """Prefill mini-caches on both sides, insert them into paged pools of
    page size 4 (slots 3, chains of 5 pages)."""
    jcfg, cfg, _, jp, tp = models[arch]
    jm, jl, tm = _prefill_both(models, arch, kv, S, lengths, seed, plain)
    slots, ps, maxp = 3, 4, 5
    jcache = jtf.lm_init_paged_cache(jcfg, slots, maxp, 12, ps, kv)
    tcache = ttf.lm_init_paged_cache(cfg, slots, maxp, 12, ps, kv, device="cpu")
    rows = np.array([[3, 4, 5, 9, 0], [7, 8, 10, 0, 0]], np.int32)
    slot_ids = np.array([2, 0], np.int32)
    jcache = j_paged_insert(jcache, jm, jnp.asarray(slot_ids), jnp.asarray(rows),
                            jnp.asarray(lengths, jnp.int32))
    paged_insert(tcache, tm, _t(slot_ids), _t(rows), torch.tensor(lengths, dtype=torch.int32))
    tok = np.zeros((slots, 1), np.int32)
    tok[[2, 0], 0] = np.argmax(np.asarray(jl)[[0, 1], [lengths[0] - 1, lengths[1] - 1]], -1)
    return jcache, tcache, tok


def _count_kernel_calls(monkeypatch):
    """Count the paged-attention wrapper's calls (LAUNCHES counts CUDA
    launches only)."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.paged_decode_attention
    monkeypatch.setattr(ops, "paged_decode_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("kv", ["int8", "f32"])
def test_paged_gather_route_equals_reference(models, kv, monkeypatch):
    """gemma3 (windowed): the paged step takes the gather route when the
    context asks for the kernel, as the reference's does; three steps
    equal the reference's, the pools too, and the paged-attention wrapper
    is never called. Plain matmul routes on both sides."""
    jcfg, cfg, _, jp, tp = models["gemma3-1b"]
    jcache, tcache, tok = _paged_both(models, "gemma3-1b", kv, [S, 7], plain=True)
    jctx = dataclasses.replace(JCTX_PLAIN, paged_attn_impl="kernel")
    ctx = dataclasses.replace(CTX_PLAIN, paged_attn_impl="kernel")
    step = _jit_decode(jcfg, jctx)
    calls = _count_kernel_calls(monkeypatch)
    for _ in range(3):
        jcache, jlog = step(jp, jnp.asarray(tok), jcache)
        tcache, tlog = ttf.lm_decode_step(ctx, tp, cfg, _t(tok), tcache)
        _close(tlog.numpy(), jlog)
        _cache_equal(tcache, jcache)
        tok = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)[:, None]
    assert not calls


def test_paged_kernel_route_equals_reference(models, monkeypatch):
    """qwen (no windows): the kernel route (write-then-attend; the plain
    version on the CPU) equals the reference's Pallas kernel route."""
    jcfg, cfg, _, jp, tp = models["qwen2.5-14b"]
    jcache, tcache, tok = _paged_both(models, "qwen2.5-14b", "int8", [10, 5])
    step = _jit_decode(jcfg)
    calls = _count_kernel_calls(monkeypatch)
    for _ in range(3):
        jcache, jlog = step(jp, jnp.asarray(tok), jcache)
        tcache, tlog = ttf.lm_decode_step(CTX, tp, cfg, _t(tok), tcache)
        _close(tlog.numpy(), jlog)
        _cache_equal(tcache, jcache)
        tok = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)[:, None]
    assert len(calls) == 3 * cfg.num_layers


@pytest.mark.parametrize("kv,tol", [("bf16", 5e-2), ("int8", 0.3)])
def test_paged_kernel_route_tracks_gather_route(models, kv, tol):
    """The counterpart of the reference's test_paged_kernel_impl_tracks_
    gather_impl (qwen): one step through the kernel route and the gather
    route from the same pools; they differ only in when the fresh token
    is quantized."""
    _, cfg, _, _, tp = models["qwen2.5-14b"]
    _, tcache, tok = _paged_both(models, "qwen2.5-14b", kv, [10, 5])
    clone = {k: v.clone() for k, v in tcache.items()}
    _, lk = ttf.lm_decode_step(CTX, tp, cfg, _t(tok), tcache)
    _, lg = ttf.lm_decode_step(dataclasses.replace(CTX, paged_attn_impl="gather"), tp,
                               cfg, _t(tok), clone)
    live = [0, 2]
    assert float((lk[live] - lg[live]).abs().max()) < tol
    assert torch.equal(lk[live, -1].argmax(-1), lg[live, -1].argmax(-1))


@pytest.mark.parametrize("num_kv_heads", [2, 4])
def test_paged_kernel_route_groups_query_heads_as_the_gather_route(num_kv_heads):
    """Grouped queries (8 heads over 2 or 4 KV heads, as qwen's 40 over 8
    at full width; the reduced configs have one KV head): on f32 pages
    the kernel route (write-then-attend) equals the gather route up to
    the f32 sum order."""
    cfg = dataclasses.replace(t_reduce_config(get_config("qwen2.5-14b")), num_heads=8,
                              num_kv_heads=num_kv_heads)
    model = build_model(cfg, "cpu")
    tp = model.init(torch.Generator().manual_seed(0))
    lens = torch.tensor([12, 7], dtype=torch.int32)
    toks = torch.from_numpy(_inputs(cfg)[0])
    mini, _ = model.prefill(CTX, tp, model.init_cache(B, S, "f32"),
                            {"tokens": toks, "lengths": lens})
    cache = model.init_paged_cache(B, 4, 9, 4, "f32")
    paged_insert(cache, mini, torch.tensor([0, 1]),
                 torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]]), lens)
    clone = {k: v.clone() for k, v in cache.items()}
    tok = torch.tensor([[3], [4]], dtype=torch.int32)
    _, lk = model.decode_step(CTX, tp, tok, cache)
    _, lg = model.decode_step(dataclasses.replace(CTX, paged_attn_impl="gather"), tp, tok,
                              clone)
    _close(lk.numpy(), lg.numpy(), 1e-5)


def test_paged_kernel_apply_applies_the_qk_norm(models):
    """The kernel route's attention of a ``qk_norm`` layer (gemma3's, with
    norm scales away from 1) equals the gather route's, which applies the
    q / k RMS norm as the reference's decode attention does (held above);
    on f32 pages the two routes differ only in the f32 sum order. It also
    equals the reference's ``_paged_attn_kernel_apply`` (its Pallas kernel
    in interpret mode) on the same layer, pages and tables. The norm
    matters: without it the output moves."""
    _, cfg, _, jp, tp = models["gemma3-1b"]
    assert cfg.qk_norm and "q_norm_scale" in tp["layers"]["attn"]
    rng = np.random.default_rng(5)
    Hkv, hd, ps, P = cfg.num_kv_heads, cfg.head_dim, 4, 6
    k = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    xn = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    tn, ln = np.array([[1, 2], [3, 4]], np.int32), np.array([5, 3], np.int32)
    x, tables, lens = _t(xn), _t(tn), _t(ln)
    cache = {"k": None, "block_tables": tables, "len": lens,
             "active": torch.ones(2, dtype=torch.int32)}
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=Hkv, head_dim=hd,
              rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
    qs = np.linspace(0.5, 1.5, hd, dtype=np.float32)
    ks = np.linspace(1.5, 0.5, hd, dtype=np.float32)
    ap = dict(ttf._layer(tp["layers"], 0)["attn"], q_norm_scale=_t(qs), k_norm_scale=_t(ks))

    def run(ap_, use_kernel):
        leaves = (torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
        view_pos, pid, off = ttf.paged_view(dict(cache, k=leaves[0][None]))
        y, _ = ttf.paged_attn(CTX, ap_, x, lens[:, None], leaves, view_pos, pid, off,
                              lens + 1, tables, use_kernel=use_kernel, **kw)
        return y

    y = run(ap, True)
    _close(y.numpy(), run(ap, False).numpy(), 1e-5)
    # the reference's function on its own layer 0 (sliced as its scan
    # slices the stacked leaves), with the same norm scales
    jap = dict(jax.tree.map(lambda a: a[0], jp["layers"]["attn"]),
               q_norm_scale=_j(qs), k_norm_scale=_j(ks))
    jcache = {"k": _j(k)[None], "block_tables": _j(tn), "len": _j(ln),
              "active": jnp.ones(2, jnp.int32)}
    _, jpid, joff = jtf.paged_view(jcache)
    jy, _ = jtf._paged_attn_kernel_apply(JCTX, jap, _j(xn), _j(ln)[:, None], (_j(k), _j(v)),
                                         jpid, joff, _j(ln) + 1, _j(tn), **kw)
    _close(y.numpy(), np.asarray(jy))
    plain = {k_: v_ for k_, v_ in ap.items() if "norm" not in k_}
    assert float((run(plain, True) - y).abs().max()) > 1e-3


def test_quantspec_aliases_give_byte_identical_lm_trees(models):
    """Every QuantSpec alias quantizes an LM tree (qwen's: GLU weights,
    QKV biases, lm_head) to the reference's bytes."""
    raw = models["qwen2.5-14b"][2]
    traw = jax_to_torch(raw)
    for name, spec in ALIASES.items():
        if spec.weights == "f32":
            continue
        tree_same_bytes(j_quantize_tree(raw, J_ALIASES[name].policy()),
                        quantize_tree(traw, spec.policy()), name)


def test_converted_lm_tree_keys(models):
    tp = models["qwen2.5-14b"][4]
    assert {"embedding", "layers", "norm_f_scale", "lm_head"} <= set(tp)
    assert {"w_gate", "w_up", "w_down"} == set(tp["layers"]["mlp"])
    assert {"bias_q", "bias_k", "bias_v"} <= set(tp["layers"]["attn"])
    gp = models["gemma3-1b"][4]
    assert "lm_head" not in gp
    assert {"q_norm_scale", "k_norm_scale"} <= set(gp["layers"]["attn"])


@pytest.mark.parametrize("arch", ARCHS)
def test_generator_init_has_the_reference_shapes(arch):
    """The port's init draws the reference init's tree: the same paths
    and shapes (the reference's traced abstractly), float32 leaves."""
    jcfg, cfg = _cfgs(arch)
    got = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    want = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))

    assert shapes(got) == shapes(want)


def test_unported_routes_raise(models):
    """Nothing is left unported: scale-out serves every family at every
    tp from 1 to 8 (a width tp does not divide replicates; the sequence
    split of dense KV caches), so no route raises ``NotImplementedError``
    and the port names no later slice. Every LM family
    inits from a key and recomputes its layers under ``remat``: qwen's key
    init is the reference's (3e-7 relative, two f32 ulps), and for qwen
    and the MoE, SSM and hybrid variants of its config ``remat`` gives
    the same logits and the LM loss is finite. A family the LM stack does
    not know raises ValueError."""
    import importlib.util
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import MoECfg, SSMCfg
    from repro_torch.train.steps import compute_loss
    from repro_torch.tree import leaves_with_path
    from repro_torch.parallel.tp import refuse_under_mesh
    assert importlib.util.find_spec("repro_torch.unported") is None
    for arch in REGISTRY:
        for tp in range(1, 9):
            refuse_under_mesh(get_config(arch), tp=tp)
    _, cfg, raw, _, _ = models["qwen2.5-14b"]
    want = dict(leaves_with_path(jax_to_torch(raw)))
    got = dict(leaves_with_path(build_model(cfg, "cpu").init(prng_key(0))))
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        assert float(((w - got[k]).abs() / w.abs().clamp(min=1e-30)).max()) <= 3e-7, k
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)),
                           dtype=torch.int32)
    for over in (dict(), dict(family="moe", moe=MoECfg(4, 2)),
                 dict(family="ssm", ssm=SSMCfg(state_dim=16, head_dim=16, chunk=8)),
                 dict(family="hybrid", d_rec=64, local_window=8)):
        model = build_model(dataclasses.replace(cfg, **over), "cpu")
        params = model.init(prng_key(0))
        plain, _ = model.forward(CTX_PLAIN, params, {"tokens": toks})
        rematted, _ = model.forward(CTX_PLAIN, params, {"tokens": toks}, remat=True)
        assert torch.equal(plain, rematted), over
        loss, _ = compute_loss(CTX_PLAIN, model, params, {"tokens": toks})
        assert torch.isfinite(loss), over
    with pytest.raises(ValueError, match="unknown decoder-only LM family"):
        ttf.lm_init(prng_key(0), dataclasses.replace(cfg, family="hybrid"))
