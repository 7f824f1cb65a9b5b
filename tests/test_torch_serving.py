"""Serving parity at smoke size: the port's deploy() -> paged and dense
engines stream the same greedy tokens as the JAX engines of the same
layout (Pallas kernel routes, interpret mode) on the same weights, token
for token, for the 4-bit specs at horizon 1 and 16, with mixed source
lengths and mid-stream admission; dense streams equal paged streams;
seeded temperature / top-k / top-p requests stream the JAX engines'
tokens too; plus EOS retirement, page reclaim and the unported routes.
Each JAX engine is built once and serves the greedy and the sampled
requests."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro.serving import impl_routes as j_impl_routes  # noqa: E402
from repro_torch.core import resolve_spec  # noqa: E402
from repro_torch.serving import (FaultPlan, SLATarget, SamplingParams, deploy,  # noqa: E402
                                 impl_routes)

SPECS = ["int4", "fp4", "nf4"]
SRC_LENS = [5, 9, 12, 5, 7]
CODES = [8, 1, 7, 9, 2]
GEN = 8
KW = dict(smoke=True, paged=True, page_size=4, slots=3, max_len=16)
DENSE_KW = dict(KW, paged=False)
# three seeded nucleus requests, one top-k request, one greedy request
SAMPLED = [dict(temperature=0.7, top_p=0.9, seed=11),
           dict(temperature=0.7, top_p=0.9, seed=12),
           dict(temperature=1.0, top_k=5, seed=14),
           dict(temperature=0.7, top_p=0.9, seed=13),
           dict()]


def _prompts():
    rng = np.random.default_rng(0)
    return [{"src_tokens": rng.integers(16, 256, (1, n)).astype(np.int32),
             "tgt_in": np.full((1, 1), c, np.int32)}
            for n, c in zip(SRC_LENS, CODES)]


@pytest.fixture(scope="module")
def raw_params():
    return j_build_model(reduce_config(REGISTRY["nllb600m"])).init(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def reference(raw_params):
    """JAX engine streams per spec and cache layout, computed once
    (horizon 1: the JAX invariant makes every horizon identical, and one
    decode program compiles where a horizon of 16 compiles one for each
    power of two it shrinks to as the requests end)."""
    out = {}
    for spec in SPECS:
        for name, kw in ((spec, KW), (f"dense-{spec}", DENSE_KW)):
            pipe = j_deploy("nllb600m", spec, params=raw_params, horizon=1, **kw,
                            **j_impl_routes("pallas"))
            outs = pipe.generate([{k: jnp.asarray(v) for k, v in p.items()}
                                  for p in _prompts()],
                                 JSamplingParams(max_new_tokens=GEN))
            out[name] = [list(o.token_ids) for o in outs]
            if spec == "int4":
                outs = _serve_mid_stream(pipe, _sampled(JSamplingParams), jnp.asarray)
                out[f"sampled-{name}"] = [list(o.token_ids) for o in outs]
    pipe = j_deploy("nllb600m", "int4", params=raw_params, horizon=1, **KW,
                    **j_impl_routes("xla"))
    outs = pipe.generate([{k: jnp.asarray(v) for k, v in p.items()}
                          for p in _prompts()], JSamplingParams(max_new_tokens=GEN))
    out["int4-xla"] = [list(o.token_ids) for o in outs]
    return out


@pytest.fixture(scope="module")
def torch_params(raw_params):
    return jax_to_torch(raw_params)


def _sampled(sp_cls):
    return [sp_cls(max_new_tokens=GEN, **kw) for kw in SAMPLED]


def _serve_mid_stream(pipe, sps, convert=lambda v: v):
    """Two requests first, one horizon, then the rest join mid-stream.
    ``sps`` is one SamplingParams for all, or one per prompt."""
    prompts = [{k: convert(v) for k, v in p.items()} for p in _prompts()]
    sps = sps if isinstance(sps, list) else [sps] * len(prompts)
    eng = pipe.engine
    ids = [eng.submit(p, sp) for p, sp in zip(prompts[:2], sps)]
    outs = eng.step()
    ids += [eng.submit(p, sp) for p, sp in zip(prompts[2:], sps[2:])]
    outs += eng.run_until_drained()
    by_id = {o.request_id: o for o in outs}
    return [by_id[i] for i in ids]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("horizon", [1, 16])
def test_streams_equal_jax_engine(spec, horizon, reference, torch_params):
    pipe = deploy("nllb600m", spec, params=torch_params, horizon=horizon,
                  device="cpu", **KW)
    outs = _serve_mid_stream(pipe, SamplingParams(max_new_tokens=GEN))
    assert [o.token_ids for o in outs] == reference[spec]
    assert all(o.finish_reason == "length" for o in outs)
    pipe.engine.allocator.check()
    assert pipe.engine.allocator.pages_in_use == 0
    if horizon == 16:
        assert pipe.engine.decode_syncs < pipe.engine.decode_steps


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("horizon", [1, 16])
def test_dense_streams_equal_jax_dense_engine(spec, horizon, reference,
                                              torch_params):
    """deploy() without ``paged`` builds the dense engine: its streams
    equal the JAX dense engine's and the paged engines' streams."""
    pipe = deploy("nllb600m", spec, params=torch_params, horizon=horizon,
                  device="cpu", **{k: v for k, v in KW.items() if k != "paged"})
    assert not pipe.engine.paged and pipe.engine.allocator is None
    assert "block_tables" not in pipe.engine.cache
    outs = _serve_mid_stream(pipe, SamplingParams(max_new_tokens=GEN))
    assert [o.token_ids for o in outs] == reference[f"dense-{spec}"]
    assert [o.token_ids for o in outs] == reference[spec]
    assert all(o.finish_reason == "length" for o in outs)
    assert "active" not in pipe.engine.cache


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("horizon", [1, 16])
def test_sampled_streams_equal_jax_engine(paged, horizon, reference, torch_params):
    """Seeded sampled requests, mixed with a greedy one, stream the JAX
    engine's tokens, dense and paged; dense equals paged."""
    pipe = deploy("nllb600m", "int4", params=torch_params, horizon=horizon,
                  device="cpu", **dict(KW, paged=paged))
    got = [o.token_ids for o in _serve_mid_stream(pipe, _sampled(SamplingParams))]
    assert got == reference["sampled-int4" if paged else "sampled-dense-int4"]
    assert got == reference["sampled-dense-int4" if paged else "sampled-int4"]
    assert all(len(t) == GEN for t in got)
    # the seeds matter: the nucleus requests on equal settings part ways
    assert len({tuple(got[i]) for i in (0, 1, 3)}) > 1


@pytest.mark.parametrize("horizon", [1, 16])
def test_torch_bundle_equals_jax_xla_bundle(horizon, reference, torch_params):
    """The "torch" bundle (dequantize + matmul, gathered chains) is the
    counterpart of the reference's "xla" bundle, token for token."""
    pipe = deploy("nllb600m", "int4", params=torch_params, horizon=horizon,
                  device="cpu", **KW, **impl_routes("torch"))
    outs = _serve_mid_stream(pipe, SamplingParams(max_new_tokens=GEN))
    assert [o.token_ids for o in outs] == reference["int4-xla"]
    pipe.engine.allocator.check()


@pytest.mark.parametrize("horizon", [1, 16])
def test_eos_retirement(horizon, reference, torch_params):
    stream = reference["int4"][1]
    eos = stream[2]
    cut = stream.index(eos) + 1
    pipe = deploy("nllb600m", "int4", params=torch_params, horizon=horizon,
                  device="cpu", **KW)
    outs = pipe.generate([_prompts()[1]],
                         SamplingParams(max_new_tokens=GEN, eos_id=eos))
    assert outs[0].finish_reason == "eos"
    assert outs[0].token_ids == stream[:cut]
    pipe.engine.allocator.check()
    assert pipe.engine.allocator.pages_in_use == 0


def test_translate_surface(torch_params):
    pipe = deploy("nllb600m", "int4", params=torch_params, device="cpu", **KW)
    outs = pipe.translate(np.arange(20, 30).reshape(2, 5), "ita",
                          SamplingParams(max_new_tokens=3))
    assert [len(o.token_ids) for o in outs] == [3, 3]
    assert [o.request_id for o in outs] == [0, 1]


class _Reached(Exception):
    """Raised by ``_Mesh`` where a deploy first reads its group: the deploy
    got past every refusal."""


class _Mesh:
    """A stand-in mesh of ``n`` ranks, for refusals made before any build;
    a deploy past them stops at its first collective setup
    (``get_group``)."""

    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n

    def get_group(self):
        raise _Reached


@pytest.mark.parametrize("kwargs", [
    dict(policy="w8a8"), dict(policy="fp8e2e"), dict(policy="w4a8kv8"),
    dict(policy="w16x8"), dict(policy="fp8"), dict(kv_dtype="fp8"),
    dict(draft_spec="wfp4a8"), dict(draft_spec="w4kvfp8"), dict(calib_batches=[]),
    dict(calib_batches=[], paged=False), dict(kv_dtype="fp8", paged=False),
    dict(mesh=_Mesh(2), policy="w8a8", faults=FaultPlan(nan_at=[(1, 0, 0)])),
    dict(mesh=_Mesh(2), draft_spec="nf4", paged=False, sla=SLATarget(p95_tpot_ms=50.0)),
    dict(mesh=_Mesh(2), sla=SLATarget(p95_ttft_ms=50.0)),
    dict(mesh=_Mesh(2), arch="mamba2-780m", faults=FaultPlan(skew_at=[(1, 5.0)])),
    dict(mesh=_Mesh(3), calib_batches=[])])
def test_unported_routes_raise(kwargs):
    """Every route deploys. Under a mesh a deploy gets past every check to
    the rank's group: a width tp does not divide (the reduced nllb600m's 4
    heads at tp3) replicates, and what reads the clock (SLA admission,
    fault injection; beside an act-quantizing spec, a draft arm, on the
    SSM family too) serves (the clock-driven arms under a mesh:
    tests/test_torch_tp_clock.py; tensor-parallel serving itself:
    tests/test_torch_tp.py, the dense and VLM LMs
    tests/test_torch_tp_lm.py, the MoE and audio families
    tests/test_torch_tp_moe.py, the SSM and hybrid families
    tests/test_torch_tp_recurrent.py, the quantization arms
    tests/test_torch_tp_quant.py, any tp tests/test_torch_tp_uneven.py).
    The quantization routes (slice 3) deploy: act-quantizing and fp8-KV
    specs and drafts and ``calib_batches`` build engines whose Ctx
    carries the spec's activation formats and whose caches the KV format
    (tests/test_torch_quant_routes.py, tests/test_torch_fp8_kv.py); SLA
    admission, tracing, overlapped rounds, faults, max_pending and draft
    arms are ported too."""
    kw = dict(KW, **kwargs)
    policy = kw.pop("policy", "int4")
    arch = kw.pop("arch", "nllb600m")
    if "mesh" in kw:
        with pytest.raises(_Reached):
            deploy(arch, policy, device="cpu", **kw)
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # uncalibrated act specs warn
        pipe = deploy("nllb600m", policy, device="cpu", **kw)
    spec = resolve_spec(policy)
    assert (pipe.ctx.act_fmt, pipe.ctx.attn_act_fmt) == (spec.act, spec.attn)
    kv = kw.get("kv_dtype", spec.kv)
    layout = {"int8": "k_codes", "fp8": "k"}.get(kv, "k")
    assert layout in pipe.engine.cache
    assert ("k_scales" in pipe.engine.cache) == (kv in ("int8", "fp8"))
    if kv == "fp8":
        assert pipe.engine.cache["k"].dtype == torch.float8_e4m3fn
    if "draft_spec" in kw:
        assert pipe.engine.draft.spec == resolve_spec(kw["draft_spec"])


def test_sampled_decoding_raises(torch_params):
    """Sampled decoding is ported (tests/test_torch_sampling.py), and so
    are deadlines (tests/test_torch_faults.py): a sampled request with a
    generous deadline runs to its budget; a non-positive deadline still
    raises."""
    pipe = deploy("nllb600m", "int4", params=torch_params, device="cpu", **KW)
    with pytest.raises(ValueError, match="deadline_ms"):
        SamplingParams(temperature=0.7, deadline_ms=0)
    outs = pipe.generate(_prompts()[:1], SamplingParams(temperature=0.7, max_new_tokens=3,
                                                        deadline_ms=1e6))
    assert len(outs[0].token_ids) == 3 and outs[0].finish_reason == "length"
