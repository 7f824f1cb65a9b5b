"""The port's hybrid family (recurrentgemma-9b, reduced: one super-block
of (rglru, rglru, attn) and a one-layer recurrent tail, d_rec 64, local
window 8) against the JAX package at smoke size (CPU, f32 compute), and
both recurrent families' decode against their own forward.

The RG-LRU block with and without an initial state (the port's
log-depth doubling scan against ``jax.lax.associative_scan``) and its
decode step; ``hybrid_forward``; prefill of a prompt 3x the window and
two decode steps against the reference's (the rolling buffer, ``pos_roll``
and the states equal); the mirrors of tests/test_decode_equiv.py's
``test_long_prompt_rolling_buffer_hybrid`` and ``test_decode_matches_forward``
(mamba2-780m and recurrentgemma-9b, bf16 KV / conv states, < 5e-3); the
engine's ``_splice`` of a batch-leading ``pos_roll``; and the port's
engine against the JAX engine (4 requests of 10, 30, 12 and 9 tokens on 3
slots, 30 past the window, horizon 4, int4, Pallas routes in interpret
mode), greedy, token for token. The reference's functions run compiled
(jax.jit), on the port's seeded init bridged to JAX.

Tolerance 1e-4 (``TOL``): both sides sum f32 products in different
orders, and the scans combine in different trees (equal within f32
rounding, not bit for bit); bf16 cache leaves within one bf16 ulp."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import torch_to_jax  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import hybrid as jhy  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro.serving import impl_routes as j_impl_routes  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import hybrid as thy  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models.transformer import _layer  # noqa: E402
from repro_torch.serving import SamplingParams, ServeEngine, deploy  # noqa: E402

TOL = 1e-4
ARCH = "recurrentgemma-9b"
JCTX = JCtx(compute_dtype=jnp.float32)
CTX = Ctx(compute_dtype=torch.float32)
B = 2
GEN = 8
LENS = [10, 30, 12, 9]
ENGINE_KW = dict(smoke=True, slots=3, max_len=48, horizon=4)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cfgs(arch=ARCH):
    return reduce_config(REGISTRY[arch]), t_reduce_config(get_config(arch))


@pytest.fixture(scope="module")
def raw():
    """arch -> the port's seeded init of the raw parameters."""
    return {arch: build_model(_cfgs(arch)[1], "cpu").init(torch.Generator().manual_seed(0))
            for arch in (ARCH, "mamba2-780m")}


@pytest.fixture(scope="module")
def trees(raw):
    """(JAX config, port config, JAX params, port params), raw f32."""
    jcfg, cfg = _cfgs()
    return jcfg, cfg, torch_to_jax(raw[ARCH]), raw[ARCH]


def _toks(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_layout(trees):
    _, cfg, _, tp = trees
    assert thy.hybrid_layout(cfg) == (1, 1)
    assert thy.hybrid_layout(get_config(ARCH)) == (12, 2)
    assert tp["blocks"]["r1"]["rglru"]["w_rg"].shape == (1, 64, 64)
    assert tp["tail"]["mlp"]["w_gate"].shape == (1, cfg.d_model, cfg.d_ff)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_rglru_apply_matches_reference(trees, with_state):
    """Output and returned (conv, h) over 13 steps (not a power of two)."""
    jcfg, cfg, jp, tp = trees
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["r1"]["rglru"])
    tl = _layer(tp["blocks"]["r1"]["rglru"], 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 13, cfg.d_model)).astype(np.float32)
    st = None
    if with_state:
        st = (rng.standard_normal((B, 3, cfg.d_rec)).astype(np.float32),
              rng.standard_normal((B, cfg.d_rec)).astype(np.float32))
    jst = None if st is None else (jnp.asarray(st[0], jnp.bfloat16), jnp.asarray(st[1]))
    tst = None if st is None else (_t(st[0]).to(torch.bfloat16), _t(st[1]))
    jy, (jc, jh) = jax.jit(lambda p, x_, s: jrg.rglru_apply(JCTX, p, x_, s, return_state=True))(
        jl, jnp.asarray(x), jst)
    ty, (tc, th) = trg.rglru_apply(CTX, tl, _t(x), tst, return_state=True)
    _close(ty.numpy(), jy)
    _close(tc.numpy(), jc)
    _close(th.numpy(), jh)


def test_linear_scan_matches_associative_scan():
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32)
    b = rng.standard_normal((2, 37, 5)).astype(np.float32)
    _, want = jax.jit(lambda a_, b_: jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]), (a_, b_), axis=1))(
        jnp.asarray(a), jnp.asarray(b))
    got = trg.linear_scan(_t(a), _t(b))
    h, seq = np.zeros((2, 5), np.float32), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    _close(got.numpy(), want, 1e-5)
    _close(got.numpy(), np.stack(seq, 1), 1e-5)


def test_rglru_decode_step_matches_reference(trees):
    jcfg, cfg, jp, tp = trees
    jl = jax.tree.map(lambda a: a[0], jp["tail"]["rglru"])
    tl = _layer(tp["tail"]["rglru"], 0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, 3, cfg.d_rec)).astype(np.float32)
    h = rng.standard_normal((B, cfg.d_rec)).astype(np.float32)
    jy, (jc, jh) = jax.jit(lambda p, x_, s: jrg.rglru_decode_step(JCTX, p, x_, s))(
        jl, jnp.asarray(x), (jnp.asarray(conv, jnp.bfloat16), jnp.asarray(h)))
    ty, (tc, th) = trg.rglru_decode_step(CTX, tl, _t(x), (_t(conv).to(torch.bfloat16), _t(h)))
    assert tc.dtype == torch.float32
    _close(ty.numpy(), jy)
    _close(tc.numpy(), jc)
    _close(th.numpy(), jh)


def test_hybrid_forward_matches_reference(trees):
    """The port with the FASST activation's route on (its plain version
    on the CPU: the RG-LRU gates' and the GELU-GLU's GELU) against the
    reference's plain NAF."""
    jcfg, cfg, jp, tp = trees
    toks = _toks(cfg, 20, 4)
    jl, _ = jax.jit(lambda p, t: jhy.hybrid_forward(JCTX, p, jcfg, t))(jp, jnp.asarray(toks))
    ctx = Ctx(compute_dtype=torch.float32, matmul_impl="kernel", use_fasst_kernel=True)
    tl, aux = thy.hybrid_forward(ctx, tp, cfg, _t(toks))
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    _close(tl.numpy(), jl)
    # remat recomputes each super-block and tail layer: the same logits
    rematted, _ = thy.hybrid_forward(ctx, tp, cfg, _t(toks), remat=True)
    assert torch.equal(rematted, tl)


def _cache_equal(tc, jc):
    assert set(tc) == set(jc)
    for key, v in jc.items():
        got = tc[key]
        assert str(got.dtype).replace("torch.", "") == str(v.dtype), key
        tol = 2.0 ** -8 if got.dtype == torch.bfloat16 else TOL
        _close(got.float().numpy(), np.asarray(v).astype(np.float32), tol)


def test_long_prompt_prefill_and_decode_match_reference(trees):
    """A prompt of 3x the window (24 tokens) fills the rolling buffer with
    its last 8 rows at ``pos % W``; two decode steps wrap it again. Each
    call's logits and the whole cache equal the reference's (its bf16
    K/V and conv states within one bf16 ulp)."""
    jcfg, cfg, jp, tp = trees
    S = 3 * cfg.local_window
    toks = _toks(cfg, S + 2, 5)
    jc = jhy.hybrid_init_cache(jcfg, B, S + 2, "int8")
    tc = thy.hybrid_init_cache(cfg, B, S + 2, "int8", device="cpu")
    assert tc["b_k"].dtype == torch.bfloat16 and tc["b_k"].shape[2] == cfg.local_window
    jc, jl = jax.jit(lambda p, t, c: jhy.hybrid_prefill(JCTX, p, jcfg, t, c))(
        jp, jnp.asarray(toks[:, :S]), jc)
    tc, tl = thy.hybrid_prefill(CTX, tp, cfg, _t(toks[:, :S]), tc)
    _close(tl.numpy(), jl)
    _cache_equal(tc, jc)
    assert tc["pos_roll"][0].tolist() == [16, 17, 18, 19, 20, 21, 22, 23]
    step = jax.jit(lambda p, t, c: jhy.hybrid_decode_step(JCTX, p, jcfg, t, c))
    for t in range(S, S + 2):
        jc, jlog = step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tc, tlog = thy.hybrid_decode_step(CTX, tp, cfg, _t(toks[:, t:t + 1]), tc)
        _close(tlog.numpy(), jlog)
        _cache_equal(tc, jc)
    assert tc["pos_roll"][1].tolist() == [24, 25, 18, 19, 20, 21, 22, 23]


def test_long_prompt_rolling_buffer_hybrid(trees):
    """The mirror of the reference's test: a prompt 3x the window stays
    exact against the forward (< 5e-3)."""
    _, cfg, _, tp = trees
    model = build_model(cfg, "cpu")
    S = 3 * cfg.local_window
    toks = _t(_toks(cfg, S + 2, 6))
    full, _ = model.forward(CTX, tp, {"tokens": toks})
    cache = model.init_cache(B, S + 2, "bf16")
    cache, lg = model.prefill(CTX, tp, cache, {"tokens": toks[:, :S]})
    errs = [float((lg[:, -1] - full[:, S - 1]).abs().max())]
    for t in range(S, S + 2):
        cache, lg = model.decode_step(CTX, tp, toks[:, t:t + 1], cache)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 5e-3, errs


@pytest.mark.parametrize("arch", [ARCH, "mamba2-780m"])
def test_decode_matches_forward(raw, arch):
    """The mirror of tests/test_decode_equiv.py::test_decode_matches_forward
    (prefill 8 of 12 tokens, then 4 decode steps; bf16 KV), < 5e-3."""
    cfg = _cfgs(arch)[1]
    model = build_model(cfg, "cpu")
    params = raw[arch]
    toks = _t(_toks(cfg, 12, 7))
    full, _ = model.forward(CTX, params, {"tokens": toks})
    cache = model.init_cache(B, 16, "bf16")
    cache, lg = model.prefill(CTX, params, cache, {"tokens": toks[:, :8]})
    if arch != ARCH:      # the engine's splice: the prefilled conv state to bf16
        cache["conv"] = cache["conv"].to(torch.bfloat16)
    errs = [float((lg[:, -1] - full[:, 7]).abs().max())]
    for t in range(8, 12):
        cache, lg = model.decode_step(CTX, params, toks[:, t:t + 1], cache)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 5e-3, errs


def test_splice_writes_the_slot_row_of_pos_roll(trees):
    """``pos_roll`` (slots, W) is batch-leading: splicing a one-slot cache
    into slot 1 writes row 1 and leaves the others; the layer-stacked
    leaves take slot 1 on their second axis."""
    _, cfg, _, _ = trees
    cache = thy.hybrid_init_cache(cfg, 3, 16, device="cpu")
    cache["pos_roll"][:] = torch.arange(3 * 8, dtype=torch.int32).reshape(3, 8)
    before = cache["pos_roll"].clone()
    one = thy.hybrid_init_cache(cfg, 1, 16, device="cpu")
    one["pos_roll"][:] = 100 + torch.arange(8, dtype=torch.int32)
    one["len"][:] = 7
    one["b_h1"][:] = 1.5
    ServeEngine._splice(cache, one, 1)
    assert cache["pos_roll"][1].tolist() == list(range(100, 108))
    assert torch.equal(cache["pos_roll"][[0, 2]], before[[0, 2]])
    assert cache["len"].tolist() == [0, 7, 0]
    assert cache["b_h1"][:, 1].eq(1.5).all() and cache["b_h1"][:, [0, 2]].eq(0).all()


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module")
def reference(raw):
    pipe = j_deploy(ARCH, "int4", params=torch_to_jax(raw[ARCH]), **ENGINE_KW,
                    **j_impl_routes("pallas"))
    outs = pipe.generate([jnp.asarray(p) for p in _prompts(pipe.cfg)],
                         JSamplingParams(max_new_tokens=GEN))
    return [(list(o.token_ids), o.finish_reason) for o in outs]


def test_greedy_streams_equal_jax_engine(raw, reference):
    """The JAX engine's streams and finish reasons (the 30-token prompt
    wraps the rolling buffer in prefill, the others in decode; a slot is
    reused), through the qmm route."""
    pipe = deploy(ARCH, "int4", params=raw[ARCH], device="cpu", **ENGINE_KW)
    assert pipe.ctx.matmul_impl == "kernel" and not pipe.engine._bucketed
    outs = pipe.generate(_prompts(pipe.cfg), SamplingParams(max_new_tokens=GEN))
    assert [(list(o.token_ids), o.finish_reason) for o in outs] == reference
    assert pipe.engine.cache["b_k"].dtype == torch.bfloat16    # int4's int8 KV ignored
