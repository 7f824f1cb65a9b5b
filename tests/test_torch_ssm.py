"""The port's SSM family (mamba2-780m, reduced) against the JAX package at
smoke size (CPU, f32 compute).

The SSD pieces on the same numpy-seeded inputs: ``_ssd_chunked`` at chunk
1, 3 and 8 and at a prime sequence length (one-row chunks),
``ssm_apply`` with its returned states and ``ssm_decode_step`` against
the reference's functions; the reference's chunked-equals-naive
invariant on the port. The LM's forward, and its prefill and three
decode steps, the reference's conv leaf cast to bf16 after each call
(the port's storage, and the cache's declared dtype). The reference's
functions run compiled (jax.jit), on the port's seeded init bridged to
JAX. The quantized trees of both recurrent archs byte-equal the
reference's, and the seeded inits have the reference init's shapes. The port's engine gives the JAX engine's greedy
streams (4 requests on 3 slots, Pallas routes in interpret mode) at
horizon 1: the reference's engine serves an f32 SSM at no longer horizon
(its decode step returns the conv state in f32 while the cache declares
bf16, and the horizon scan refuses the change of type).

Tolerance 1e-4 (``TOL``) where both sides sum f32 products in different
orders; 2e-4 abs / 2e-3 rel for chunked against naive (the reference's
own)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import torch_to_jax, tree_same_bytes  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core.spec import ALIASES as J_ALIASES  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro.serving import impl_routes as j_impl_routes  # noqa: E402
from repro_torch.configs import SSMCfg, get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.core import quantize_tree, resolve_spec  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import SamplingParams, deploy  # noqa: E402

TOL = 1e-4
ARCH = "mamba2-780m"
RECURRENT = ["mamba2-780m", "recurrentgemma-9b"]
# every weight-only alias, and the act-quantizing w8a8 and fp8e2e
SPECS = ["bf16", "int8", "fp8", "int4", "fp4", "nf4", "w8a8", "fp8e2e"]
JCTX = JCtx(compute_dtype=jnp.float32)
CTX = Ctx(compute_dtype=torch.float32)
B = 2
GEN = 8
LENS = [5, 11, 14, 7]             # unbucketed: a prefill shape per length
ENGINE_KW = dict(smoke=True, slots=3, max_len=32, horizon=1)


def _close(a, b, tol=TOL, rtol=None):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol if rtol is None else rtol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cfgs(arch=ARCH):
    return reduce_config(REGISTRY[arch]), t_reduce_config(get_config(arch))


@pytest.fixture(scope="module")
def raw_trees():
    """The port's seeded init of the raw parameters per arch."""
    return {arch: build_model(_cfgs(arch)[1], "cpu").init(torch.Generator().manual_seed(0))
            for arch in RECURRENT}


@pytest.fixture(scope="module")
def trees(raw_trees):
    """(JAX config, port config, JAX params, port params): mamba2's raw
    f32 parameters on both sides."""
    jcfg, cfg = _cfgs()
    return jcfg, cfg, torch_to_jax(raw_trees[ARCH]), raw_trees[ARCH]


@pytest.mark.parametrize("arch", RECURRENT)
def test_configs_mirror_reference(arch):
    """Full and reduced configs equal the reference's field for field."""
    for t, j in ((get_config(arch), REGISTRY[arch]), _cfgs(arch)[::-1]):
        assert t.__dict__.keys() == j.__dict__.keys()
        for k in t.__dict__:
            a, b = getattr(t, k), getattr(j, k)
            if k == "ssm" and a is not None:
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, k)
    cfg = _cfgs(arch)[1]
    if arch == ARCH:
        assert cfg.ssm == SSMCfg(state_dim=16, head_dim=16, expand=2, chunk=8)
    else:
        assert (cfg.num_layers, cfg.d_rec, cfg.local_window) == (4, 64, 8)


def _ssd_inputs(S, seed=0, nh=4, hp=8, ds=16):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    Bm = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, S, ds)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = -np.exp(np.log(np.linspace(1.0, 16.0, nh))).astype(np.float32)
    return xh, Bm, Cm, dt, A


@pytest.mark.parametrize("S,chunk", [(12, 1), (12, 3), (12, 8), (13, 8)],
                         ids=["chunk1", "chunk3", "chunk8", "prime13"])
def test_ssd_chunked_matches_reference(S, chunk):
    """Output and final state; chunk 8 at S 12 runs Q 6, S 13 runs Q 1."""
    args = _ssd_inputs(S)
    jy, jh = jax.jit(jssm._ssd_chunked, static_argnums=5)(*map(jnp.asarray, args), chunk)
    ty, th = tssm._ssd_chunked(*map(_t, args), chunk)
    assert ty.dtype == th.dtype == torch.float32
    _close(ty.numpy(), jy)
    _close(th.numpy(), jh)


def _layer0(trees):
    """Layer 0's SSM parameters, the reference's and the port's."""
    jl = jax.tree.map(lambda a: a[0], trees[2]["layers"]["ssm"])
    return jl, ttf._layer(trees[3]["layers"]["ssm"], 0)


def test_ssm_apply_with_state_matches_reference(trees):
    jcfg, cfg = trees[:2]
    jl, tl = _layer0(trees)
    x = 0.5 * np.random.default_rng(1).standard_normal((B, 13, cfg.d_model)).astype(
        np.float32)
    kw = dict(d_model=cfg.d_model, ssm_cfg=cfg.ssm)
    conv0 = np.zeros((B, 3, tssm._dims(cfg.d_model, cfg.ssm)[3]), np.float32)
    jy, (jconv, jh) = jax.jit(lambda p, x_, c: jssm.ssm_apply(
        JCTX, p, x_, conv_state=c, return_state=True, d_model=cfg.d_model,
        ssm_cfg=jcfg.ssm))(jl, jnp.asarray(x), jnp.asarray(conv0, jnp.bfloat16))
    ty, (tconv, th) = tssm.ssm_apply(CTX, tl, _t(x), conv_state=_t(conv0).to(torch.bfloat16),
                                     return_state=True, **kw)
    assert tconv.dtype == torch.float32          # bf16 state + f32 rows promote
    _close(ty.numpy(), jy)
    _close(tconv.numpy(), jconv)
    _close(th.numpy(), jh)
    _close(tssm.ssm_apply(CTX, tl, _t(x), **kw).numpy(), jy)


def test_ssm_decode_step_matches_reference(trees):
    jcfg, cfg = trees[:2]
    jl, tl = _layer0(trees)
    rng = np.random.default_rng(2)
    conv, h = (np.asarray(a) for a in jssm.ssm_init_state(None, B, cfg.d_model, jcfg.ssm))
    conv = rng.standard_normal(conv.shape).astype(np.float32)
    h = rng.standard_normal(h.shape).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jy, (jc, jh) = jax.jit(lambda p, x_, st: jssm.ssm_decode_step(
        JCTX, p, x_, st, d_model=cfg.d_model, ssm_cfg=jcfg.ssm))(
        jl, jnp.asarray(x), (jnp.asarray(conv, jnp.bfloat16), jnp.asarray(h)))
    ty, (tc, th) = tssm.ssm_decode_step(CTX, tl, _t(x), (_t(conv).to(torch.bfloat16), _t(h)),
                                        d_model=cfg.d_model, ssm_cfg=cfg.ssm)
    assert tc.dtype == torch.float32 and th.dtype == torch.float32
    _close(ty.numpy(), jy)
    _close(tc.numpy(), jc)
    _close(th.numpy(), jh)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_equals_naive(chunk):
    """The reference's tests/test_ssm.py invariant, on the port's seeded
    init."""
    d_model = 32
    cfg = SSMCfg(state_dim=16, head_dim=8, expand=2, chunk=chunk)
    params = ttf._layer(tssm.ssm_init(torch.Generator().manual_seed(0), d_model, cfg, 1), 0)
    x = 0.5 * torch.randn((2, 16, d_model), generator=torch.Generator().manual_seed(1))
    y_chunk = tssm.ssm_apply(CTX, params, x, d_model=d_model, ssm_cfg=cfg)
    y_naive = tssm.ssm_naive_ref(CTX, params, x, d_model=d_model, ssm_cfg=cfg)
    _close(y_chunk.numpy(), y_naive.numpy(), 2e-4, 2e-3)


def test_prefill_then_decode_matches_reference(trees):
    """lm_prefill (S 13, a prime: one-row chunks) then three decode steps
    fed the reference's greedy tokens: logits, the states and ``len``. The conv leaves are compared, and then held, in
    bf16 (the port's engine splices its prefilled state into a bf16 leaf
    and each decode step writes it there)."""
    jcfg, cfg, jp, tp = trees
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 13)).astype(np.int32)
    jc = jtf.lm_init_cache(jcfg, B, 16)
    jc, jl = jax.jit(lambda p, t, c: jtf.lm_prefill(JCTX, p, jcfg, t, c))(
        jp, jnp.asarray(toks), jc)
    tc = ttf.lm_init_cache(cfg, B, 16, device="cpu")
    assert set(tc) == set(jc) == {"conv", "ssd", "len"}
    assert tc["conv"].dtype == torch.bfloat16 and tc["ssd"].dtype == torch.float32
    tc, tl = ttf.lm_prefill(CTX, tp, cfg, _t(toks), tc)
    _close(tl.numpy(), jl)
    _close(tc["conv"].numpy(), jc["conv"])
    tc["conv"] = tc["conv"].to(torch.bfloat16)
    jc = dict(jc, conv=jc["conv"].astype(jnp.bfloat16))
    step = jax.jit(lambda p, t, c: jtf.lm_decode_step(JCTX, p, jcfg, t, c))
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(3):
        jc, jlog = step(jp, jnp.asarray(tok), jc)
        tc, tlog = ttf.lm_decode_step(CTX, tp, cfg, _t(tok), tc)
        jc = dict(jc, conv=jc["conv"].astype(jnp.bfloat16))
        assert tc["conv"].dtype == torch.bfloat16
        _close(tlog.numpy(), jlog)
        _close(tc["conv"].float().numpy(), jc["conv"].astype(jnp.float32), 2.0 ** -8)
        _close(tc["ssd"].numpy(), jc["ssd"])
        tok = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)[:, None]
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [16, 16]


def test_forward_matches_reference(trees):
    jcfg, cfg, jp, tp = trees
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    jl, jaux, _ = jax.jit(lambda p, t: jtf.lm_forward(JCTX, p, jcfg, t))(jp, jnp.asarray(toks))
    tl, aux, kv = ttf.lm_forward(CTX, tp, cfg, _t(toks))
    assert kv is None and float(aux) == float(jaux) == 0.0
    _close(tl.numpy(), jl)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("arch", RECURRENT)
def test_quantized_trees_byte_equal(raw_trees, arch, spec):
    """Byte for byte the reference's; the recurrences' own leaves
    (``a_log``, ``dt_bias``, ``conv_*``, ``D``, every ``rglru`` leaf) stay
    unquantized in the compute dtype, and the stacked ``blocks`` /
    ``tail`` QTensors keep their leading axis."""
    raw = raw_trees[arch]
    ttree = quantize_tree(raw, resolve_spec(spec).policy())
    tree_same_bytes(j_quantize_tree(torch_to_jax(raw), J_ALIASES[spec].policy()), ttree)
    if arch == ARCH:
        s = ttree["layers"]["ssm"]
        assert all(isinstance(s[k], torch.Tensor)
                   for k in ("a_log", "dt_bias", "conv_w", "conv_bias", "D"))
        assert s["in_proj"].shape[0] == 2
    else:
        assert all(isinstance(v, torch.Tensor) for v in ttree["blocks"]["r1"]["rglru"].values())
        assert ttree["blocks"]["at"]["mlp"]["w_up"].shape[0] == 1
        assert ttree["tail"]["mlp"]["w_down"].shape[0] == 1


@pytest.mark.parametrize("arch", RECURRENT)
def test_generator_init_has_the_reference_shapes(arch):
    jcfg, cfg = _cfgs(arch)
    got = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    want = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))

    assert shapes(got) == shapes(want)
    if arch == ARCH:
        a_log = got["layers"]["ssm"]["a_log"]
        np.testing.assert_allclose(a_log[1].numpy(), np.log(np.linspace(1, 16, a_log.shape[1])),
                                   rtol=1e-6)


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module")
def reference(raw_trees):
    pipe = j_deploy(ARCH, "int4", params=torch_to_jax(raw_trees[ARCH]), **ENGINE_KW,
                    **j_impl_routes("pallas"))
    outs = pipe.generate([jnp.asarray(p) for p in _prompts(pipe.cfg)],
                         JSamplingParams(max_new_tokens=GEN))
    return [(list(o.token_ids), o.finish_reason) for o in outs]


def test_greedy_streams_equal_jax_engine(raw_trees, reference):
    """4 requests of 5, 11, 14 and 7 tokens on 3 slots (a slot is reused,
    so a stale state would show): the JAX engine's streams and finish
    reasons, through the kernel routes."""
    pipe = deploy(ARCH, "int4", params=raw_trees[ARCH], device="cpu", **ENGINE_KW)
    assert pipe.ctx.matmul_impl == "kernel" and not pipe.engine._bucketed
    outs = pipe.generate(_prompts(pipe.cfg), SamplingParams(max_new_tokens=GEN))
    assert [(list(o.token_ids), o.finish_reason) for o in outs] == reference
    assert pipe.engine.cache["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", RECURRENT)
def test_paged_and_draft_raise(arch):
    """As in the reference: no paged cache, no draft arm."""
    with pytest.raises(ValueError, match="paged serving supports"):
        deploy(arch, "int4", smoke=True, device="cpu", paged=True, max_len=16)
    with pytest.raises(ValueError, match="speculative decoding supports"):
        deploy(arch, "int4", smoke=True, device="cpu", draft_spec="nf4", max_len=16)
    model = build_model(_cfgs(arch)[1], "cpu")
    with pytest.raises(ValueError, match="recurrent state"):
        model.init_paged_cache(2, 4, 9, 4)
    if arch == ARCH:
        with pytest.raises(ValueError, match="ssm states"):
            ttf.lm_init_paged_cache(model.cfg, 2, 4, 9, 4, device="cpu")


def test_engine_conv_leaf_stays_bf16_at_horizon_4(raw_trees):
    """The port keeps the declared bf16 conv leaf at any horizon (the
    reference's engine at f32 compute and horizon 4 raises a TypeError
    for the change of type)."""
    pipe = deploy(ARCH, "int4", params=raw_trees[ARCH], device="cpu",
                  **dict(ENGINE_KW, horizon=4))
    outs = pipe.generate(_prompts(pipe.cfg)[:2], SamplingParams(max_new_tokens=GEN))
    assert all(len(o.token_ids) == GEN for o in outs)
    assert pipe.engine.cache["conv"].dtype == torch.bfloat16
