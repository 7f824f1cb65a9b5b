"""The quantization routes of the port against the JAX package: activation
quantization (w8a8's integer matmul, the a8 / afp8 fake quant, the x<fmt>
attention operands), per-site calibration and the act-quantizing engines
(smoke nllb600m, f32, JAX-initialised weights).

Tolerances: activation codes and scales are byte-equal to the compiled
reference's (jax.jit: XLA divides by a constant as a product with its f32
reciprocal, and the port computes that); matmul outputs agree within
1e-5 absolute, teacher-forced logits within 1e-4, calibrated scales
within rtol 1e-5 over the same site set, and greedy streams token for
token. The reference engines run with their fp8 casts rounded once
(``exact_fp8_reference``) and the calibrated arms of the port take the
reference's scales, so a code flip at a rounding boundary cannot hide a
real difference. The JAX engines are built once per module: a dense
"xla" engine per spec holds the port's dense and gathered paged engines
(the reference's paged engine streams its dense engine's tokens), and a
paged "pallas" engine holds the port's kernel route of the fp8 arm (fp8
pages through the paged-attention kernel's plain version).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import exact_fp8_reference, jax_to_torch, same_bytes  # noqa: E402

import repro.core.qlinear as jql  # noqa: E402
from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.core import QTensor as JQTensor  # noqa: E402
from repro.core.calibration import calibrate_act_scales as j_calibrate  # noqa: E402
from repro.data import SyntheticTranslation as JSynthetic  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree, resolve_spec as j_resolve  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro.serving import impl_routes as j_impl_routes  # noqa: E402
import repro_torch.core.qlinear as tql  # noqa: E402
from repro_torch.core import calibrate_act_scales  # noqa: E402
from repro_torch.data import SyntheticTranslation  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.serving import SamplingParams, deploy, impl_routes  # noqa: E402

CFG = reduce_config(REGISTRY["nllb600m"])
STREAM_SPECS = ["w8a8", "fp8e2e", "w4a8kv8", "w8a8kv8x8"]
KERNEL_SPECS = ["fp8e2e"]
CALIBRATED = {"w8a8", "w4a8kv8", "w8a8kv8x8"}
ROUTES = {"dense": dict(paged=False, bundle="torch"),
          "paged": dict(paged=True, bundle="torch"),
          "paged-kernels": dict(paged=True, bundle="kernels")}
KW = dict(smoke=True, slots=3, max_len=16, page_size=4, horizon=4)
GEN = 6


def prompts():
    """Three requests of one source length (one prefill shape a layout)."""
    rng = np.random.default_rng(0)
    return [{"src_tokens": rng.integers(16, 256, (1, 6)).astype(np.int32),
             "tgt_in": np.full((1, 1), c, np.int32)} for c in (8, 1, 7)]


def calib_batches(n=2, batch=4):
    """The reference's calibration batches (a fresh generator each call)."""
    ds = JSynthetic(CFG.vocab_size, CFG.enc_len, seed=0)
    return [{k: v for k, v in ds.sample(batch).items() if not isinstance(v, str)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def raw_params():
    return j_build_model(CFG).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def torch_params(raw_params):
    return jax_to_torch(raw_params)


@pytest.fixture(scope="module")
def reference(raw_params):
    """The JAX engines' greedy streams per spec ("dense": the "xla"
    bundle; "paged-kernels": the "pallas" bundle's paged engine), and the
    calibrated arms' scales."""
    out, scales = {}, {}
    runs = [(spec, "dense") for spec in STREAM_SPECS] + \
        [(spec, "paged-kernels") for spec in KERNEL_SPECS]
    with exact_fp8_reference(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for spec, route in runs:
            cal = [{k: jnp.asarray(v) for k, v in b.items()}
                   for b in calib_batches()] if spec in CALIBRATED else None
            impl = "xla" if route == "dense" else "pallas"
            pipe = j_deploy("nllb600m", spec, params=raw_params, calib_batches=cal,
                            paged=route != "dense", **KW, **j_impl_routes(impl))
            outs = pipe.generate([{k: jnp.asarray(v) for k, v in p.items()}
                                  for p in prompts()], JSamplingParams(max_new_tokens=GEN))
            out[spec, route] = [list(o.token_ids) for o in outs]
            scales[spec] = pipe.ctx.act_scales
    return out, scales


# -- activation quantization ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_activations_byte_equal(fmt, static, dtype):
    """Codes and scales byte-equal to the compiled reference's. In bf16
    with a 0-d static scale torch would divide in bf16 (a 0-d tensor takes
    no part in type promotion) where JAX divides in f32: the port casts
    first."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((48, 160)) * np.exp(rng.standard_normal((48, 1)))).astype(np.float32)
    x[3] = 0.0                                    # an all-zero row: scale 1
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    scale = (0.0123 if fmt == "int8" else 0.00731) if static else None
    jc, js = jax.jit(lambda v: jql.quantize_activations(v, fmt, scale))(jx)
    tc, ts = tql.quantize_activations(tx, fmt, scale)
    assert same_bytes(jc, tc)
    assert np.asarray(js).shape == tuple(ts.shape)
    assert np.asarray(js).tobytes() == ts.numpy().tobytes()


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_path_equals_reference(static):
    """w8a8's integer route (torch._int_mm, rows padded) at decode and
    prefill rows, against the reference's int32 dot_general."""
    rng = np.random.default_rng(2)
    w = JQTensor.quantize(jnp.asarray(rng.standard_normal((64, 96)) * 0.1, jnp.float32),
                          "int8", 2 ** 20)
    tw = jax_to_torch({"w": w})["w"]
    scale = 0.021 if static else None
    for rows in (3, 40):
        x = rng.standard_normal((rows, 64)).astype(np.float32)
        want = jax.jit(lambda v: jql._int8_path(v, w, jnp.float32, scale))(jnp.asarray(x))
        got = tql._int8_path(torch.from_numpy(x), tw, torch.float32, scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("act", ["int8", "fp8"])
@pytest.mark.parametrize("wfmt", ["int4", "nf4", "fp8", "int8"])
def test_fake_quant_route_equals_reference(wfmt, act, impl):
    """qmatmul's a8 / afp8 routes (fake-quantized activations, then the
    qmm kernel's plain version or the dequantize route); blockwise int8
    with int8 activations fake-quantizes too."""
    rng = np.random.default_rng(3)
    w = JQTensor.quantize(jnp.asarray(rng.standard_normal((128, 64)) * 0.1, jnp.float32),
                          wfmt, 64)
    tw = jax_to_torch({"w": w})["w"]
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    j_impl = "pallas" if impl == "kernel" else "xla"
    with exact_fp8_reference():
        want = jax.jit(lambda v: jql.qmatmul(v, w, act=act, compute_dtype=jnp.float32,
                                             impl=j_impl))(jnp.asarray(x))
    got = tql.qmatmul(torch.from_numpy(x), tw, act=act, compute_dtype=torch.float32,
                      impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("subscripts", ["bqhgd,bkhd->bhgqk", "bhgqk,bkhd->bqhgd"],
                         ids=["qk", "pv"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"], ids=["x8", "xfp8"])
def test_attn_dot_equals_reference(fmt, subscripts):
    """Ctx.attn_dot fake-quantizes both operands and contracts in f32."""
    rng = np.random.default_rng(4)
    if subscripts.startswith("bqhgd"):
        a, b = rng.standard_normal((2, 3, 2, 2, 16)), rng.standard_normal((2, 7, 2, 16))
    else:
        a, b = rng.random((2, 2, 2, 3, 7)), rng.standard_normal((2, 7, 2, 16))
    a, b = a.astype(np.float32), b.astype(np.float32)
    with exact_fp8_reference():
        want = jax.jit(lambda u, v: JCtx(attn_act_fmt=fmt).attn_dot(subscripts, u, v, site="s"))(
            jnp.asarray(a), jnp.asarray(b))
    got = Ctx(attn_act_fmt=fmt).attn_dot(subscripts, torch.from_numpy(a),
                                         torch.from_numpy(b), site="s")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_bf16_attn_dot_is_unchanged():
    """The bf16 attention route stays one f32 einsum, bit for bit."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((2, 3, 2, 2, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 7, 2, 16)).astype(np.float32))
    got = Ctx().attn_dot("bqhgd,bkhd->bhgqk", a, b, site="s")
    assert torch.equal(got, torch.einsum("bqhgd,bkhd->bhgqk", a, b))


@pytest.mark.parametrize("spec", ["int4", "w8a8", "w4a8kv8", "w8a8kv8x8"])
def test_encdec_forward_logits(raw_params, spec):
    """The teacher-forced pass (what calibration runs) within 1e-4."""
    s = j_resolve(spec)
    qj = j_quantize_tree(raw_params, s.policy())
    batch = calib_batches(1, 3)[0]
    jctx = JCtx(compute_dtype=jnp.float32, act_fmt=s.act, attn_act_fmt=s.attn)
    want, _ = jax.jit(lambda p, b: j_build_model(CFG).forward(jctx, p, b))(
        qj, {k: jnp.asarray(v) for k, v in batch.items()})
    ctx = Ctx(compute_dtype=torch.float32, act_fmt=s.act, attn_act_fmt=s.attn)
    got, aux = build_model(CFG, "cpu").forward(ctx, jax_to_torch(qj), batch)
    assert got.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


# -- calibration -------------------------------------------------------------

@pytest.mark.parametrize("spec", ["w8a8", "w8a8kv8x8"])
def test_calibrated_scales_equal_reference(raw_params, spec):
    """Same batches, same quantized tree: the same site set (x8 adds the
    QK / PV operand sites) and the same scales within rtol 1e-5."""
    s = j_resolve(spec)
    qj = j_quantize_tree(raw_params, s.policy())
    want = j_calibrate(j_build_model(CFG),
                       qj, JCtx(compute_dtype=jnp.float32, attn_act_fmt=s.attn),
                       [{k: jnp.asarray(v) for k, v in b.items()} for b in calib_batches()])
    got = calibrate_act_scales(build_model(CFG, "cpu"), jax_to_torch(qj),
                               Ctx(compute_dtype=torch.float32, attn_act_fmt=s.attn),
                               calib_batches())
    assert sorted(got) == sorted(want)
    assert {"enc.attn.qkv", "dec.ffn.in", "dec.cross.kv"} <= set(got)
    assert ("dec.attn.qk.a" in got) == (s.attn != "bf16")
    np.testing.assert_allclose([got[k] for k in sorted(want)],
                               [want[k] for k in sorted(want)], rtol=1e-5)


def test_act_stats_equal_reference():
    """The generic statistics: ActStats / calibrate (absmax and the median
    of per-batch 99.9th percentiles) and ActSiteStats merges equal the
    reference's on the same data (rtol 1e-6)."""
    from repro.core.calibration import ActSiteStats as JSiteStats
    from repro.core.calibration import calibrate as j_calibrate_stats
    from repro_torch.core import ActSiteStats, calibrate
    rng = np.random.default_rng(7)
    batches = [(rng.standard_normal((64, 33)) * (i + 1)).astype(np.float32) for i in range(3)]
    want = j_calibrate_stats(jnp.asarray, batches)
    got = calibrate(torch.from_numpy, batches)
    assert got.absmax == pytest.approx(want.absmax, rel=1e-6)
    assert got.scale(448.0) == pytest.approx(want.scale(448.0), rel=1e-6)
    regs = []
    for site_stats in (ActSiteStats, JSiteStats):
        a, b = site_stats(), site_stats()
        for site, v in (("x", 1.0), ("y", 3.0)):
            a.update(site, v)
        for site, v in (("x", 2.0), ("z", 0.5)):
            b.update(site, v)
        regs.append((a.merge(b).absmax, b.merge(a).scales(127.0)))
    assert regs[0] == regs[1]


def test_port_calibration_data_equals_reference():
    """The port's SyntheticTranslation draws the reference's batches."""
    a = SyntheticTranslation(CFG.vocab_size, CFG.enc_len, seed=0).sample(4)
    b = calib_batches(1)[0]
    for k in ("src_tokens", "tgt_in"):
        np.testing.assert_array_equal(a[k], b[k])


def test_deploy_calibrates_one_shot_iterables_for_both_arms(torch_params):
    """A one-shot calib iterable is listed once when a draft needs it too:
    target and act-quantizing draft both come out calibrated."""
    pipe = deploy("nllb600m", "w8a8", params=torch_params, device="cpu",
                  draft_spec="w4a8kv8", calib_batches=iter(calib_batches()), **KW)
    assert pipe.ctx.act_fmt == "int8" and dict(pipe.ctx.act_scales)
    d = pipe.engine.draft.ctx
    assert d.act_fmt == "int8" and dict(d.act_scales)
    assert d.attn_act_fmt == pipe.ctx.attn_act_fmt


@pytest.mark.parametrize("calib", [None, "empty"])
def test_uncalibrated_act_spec_warns_and_stays_dynamic(torch_params, calib):
    """An a8 spec without calibration batches warns, stays dynamic and
    still quantizes: its logits are not those of bf16 activations."""
    with pytest.warns(UserWarning, match="dynamic per-token"):
        pipe = deploy("nllb600m", "w8a8", params=torch_params, device="cpu",
                      calib_batches=iter(()) if calib else None, **KW)
    assert pipe.ctx.act_scales is None and pipe.ctx.act_fmt == "int8"
    batch = calib_batches(1, 2)[0]
    model = pipe.model
    quantized, _ = model.forward(pipe.ctx, pipe.params, batch)
    plain, _ = model.forward(Ctx(compute_dtype=torch.float32), pipe.params, batch)
    assert not torch.allclose(quantized, plain, atol=1e-6)


def test_bf16_spec_never_warns(torch_params):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pipe = deploy("nllb600m", "int8", params=torch_params, device="cpu",
                      calib_batches=calib_batches(), **KW)
    assert pipe.ctx.act_fmt == "bf16" and pipe.ctx.act_scales is None


def test_spec_overrides_an_explicit_ctx(torch_params):
    """The spec's activation formats win over a caller's ctx."""
    with pytest.warns(UserWarning, match="dynamic per-token"):
        pipe = deploy("nllb600m", "w8a8kv8x8", params=torch_params, device="cpu",
                      ctx=Ctx(compute_dtype=torch.float32), **KW)
    assert (pipe.ctx.act_fmt, pipe.ctx.attn_act_fmt) == ("int8", "int8")


# -- engines -------------------------------------------------------------------

@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
@pytest.mark.parametrize("spec", ["w8a8", "fp8e2e", "w4a8kv8", "wfp4a8",
                                  "wfp8e4m3afp8kvfp8", "w8a8kv8x8"])
def test_every_spec_deploys_and_serves(torch_params, spec, calibrated):
    """Every act-quantizing / fp8 spec deploys paged, with or without
    calibration batches, and serves a request to its budget."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = deploy("nllb600m", spec, params=torch_params, device="cpu", paged=True,
                      calib_batches=calib_batches(1, 2) if calibrated else None, **KW)
    assert bool(pipe.ctx.act_scales) == calibrated
    out = pipe.generate(prompts()[:1], SamplingParams(max_new_tokens=3))[0]
    assert out.finish_reason == "length" and len(out.token_ids) == 3


@pytest.mark.parametrize("spec,route", [(s, r) for s in STREAM_SPECS for r in ("dense", "paged")]
                         + [(s, "paged-kernels") for s in KERNEL_SPECS])
def test_streams_equal_reference(torch_params, reference, spec, route):
    """Greedy streams of the port's dense and paged engines equal the JAX
    engines', token for token: the "torch" bundle's against the dense
    "xla" engine, the "kernels" bundle's (plain versions here) against
    the paged "pallas" engine."""
    ref, ref_scales = reference
    ctx = Ctx(compute_dtype=torch.float32, act_scales=ref_scales[spec])
    kw = dict(ROUTES[route])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = deploy("nllb600m", spec, params=torch_params, device="cpu", ctx=ctx,
                      paged=kw["paged"], **KW, **impl_routes(kw["bundle"]))
    if spec in CALIBRATED:
        assert pipe.ctx.act_scales == ref_scales[spec]
    outs = pipe.generate(prompts(), SamplingParams(max_new_tokens=GEN))
    want = ref[spec, "paged-kernels" if route == "paged-kernels" else "dense"]
    assert [o.token_ids for o in outs] == want
