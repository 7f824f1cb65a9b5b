"""LM serving parity at smoke size: the port's deploy() engines for the
decoder-only families against the JAX engines of the same layout (Pallas
kernel routes, interpret mode) on the same weights, token for token:
qwen2.5-14b paged (greedy and seeded sampled), gemma3-1b paged with
prompts longer than its local window (the reference's gather route) and
llava-next-mistral-7b dense with image embeddings. The port's dense and
paged streams are equal, a speculative nf4 draft over qwen emits the
target-only streams, calibration on ``{"tokens": ...}`` batches gives the
reference's per-site scales, the enc-dec-only calls raise for an LM, and
the launcher draws the reference launcher's LM prompts. Each JAX engine
is built once per module. Both sides start from the port's seeded init
of the raw parameters."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch, torch_to_jax  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.core import calibrate_act_scales as j_calibrate  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core.spec import ALIASES as J_ALIASES  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro.serving import impl_routes as j_impl_routes  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import SamplingParams, deploy  # noqa: E402

GEN = 8
KW = dict(smoke=True, page_size=4, slots=3, max_len=32, horizon=4)
# qwen: two buckets (8, 16); gemma3: every prompt past its window of 8
# llava (unbucketed: a prefill shape per prompt length): two lengths
LENS = {"qwen2.5-14b": [5, 11, 14, 7], "gemma3-1b": [10, 14, 12, 9],
        "llava-next-mistral-7b": [6, 9, 9, 6]}
PAGED = {"qwen2.5-14b": True, "gemma3-1b": True, "llava-next-mistral-7b": False}
SAMPLED = [dict(temperature=0.7, top_p=0.9, seed=11), dict(temperature=1.0, top_k=5, seed=12),
           dict(temperature=0.7, top_p=0.9, seed=13), dict()]


def _prompts(arch):
    """Token ids (1-D numpy) per request, and a VLM's image embeddings."""
    cfg = reduce_config(REGISTRY[arch])
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS[arch]]
    if cfg.family != "vlm":
        return toks, None
    imgs = [(0.1 * rng.standard_normal((1, cfg.num_patches, cfg.d_model))
             ).astype(np.float32) for _ in toks]
    return toks, imgs


def _batches(arch, conv=lambda a: a):
    toks, imgs = _prompts(arch)
    if imgs is None:
        return [{"tokens": conv(t[None])} for t in toks]
    return [{"tokens": conv(t[None]), "img_embeds": conv(im)} for t, im in zip(toks, imgs)]


def _serve(eng, prompts, sps):
    ids = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
    by_id = {o.request_id: o for o in eng.run_until_drained()}
    return [by_id[i] for i in ids]


@pytest.fixture(scope="module")
def raw():
    """Raw parameters per arch: the port's seeded init, as a JAX tree."""
    return {arch: torch_to_jax(build_model(t_reduce_config(get_config(arch)), "cpu").init(
        torch.Generator().manual_seed(0))) for arch in LENS}


@pytest.fixture(scope="module")
def reference(raw):
    """The JAX engines' streams: greedy per arch in its layout, and
    qwen's seeded sampled requests on the same engine."""
    out = {}
    for arch in LENS:
        pipe = j_deploy(arch, "int4", params=raw[arch], paged=PAGED[arch], **KW,
                        **j_impl_routes("pallas"))
        outs = pipe.generate(_batches(arch, jnp.asarray), JSamplingParams(max_new_tokens=GEN))
        out[arch] = [list(o.token_ids) for o in outs]
        if arch == "qwen2.5-14b":
            sps = [JSamplingParams(max_new_tokens=GEN, **kw) for kw in SAMPLED]
            outs = _serve(pipe.engine, _batches(arch, jnp.asarray), sps)
            out["sampled"] = [list(o.token_ids) for o in outs]
    return out


@pytest.fixture(scope="module")
def torch_raw(raw):
    return {arch: jax_to_torch(tree) for arch, tree in raw.items()}


def _port(torch_raw, arch, **kw):
    return deploy(arch, "int4", params=torch_raw[arch], device="cpu",
                  **{"paged": PAGED[arch], **KW, **kw})


def _tokens(outs):
    return [list(o.token_ids) for o in outs]


@pytest.mark.parametrize("arch", list(LENS))
def test_greedy_streams_equal_jax_engine(arch, reference, torch_raw):
    """1-D token prompts (llava: batch dicts with its image rows) through
    generate(): the JAX engine's streams; every request retires on length
    and a paged engine frees its pages."""
    pipe = _port(torch_raw, arch)
    toks, imgs = _prompts(arch)
    prompts = toks if imgs is None else _batches(arch)
    outs = pipe.generate(prompts, SamplingParams(max_new_tokens=GEN))
    assert _tokens(outs) == reference[arch]
    assert all(o.finish_reason == "length" for o in outs)
    if pipe.engine.paged:
        pipe.engine.allocator.check()
        assert pipe.engine.allocator.pages_in_use == 0
    else:
        assert "active" not in pipe.engine.cache


@pytest.fixture(scope="module")
def dense_qwen(torch_raw):
    """The port's dense-engine greedy streams for qwen (horizon 4)."""
    pipe = _port(torch_raw, "qwen2.5-14b", paged=False)
    return _tokens(pipe.generate(_prompts("qwen2.5-14b")[0],
                                 SamplingParams(max_new_tokens=GEN)))


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma3-1b"])
@pytest.mark.parametrize("horizon", [1, 4])
def test_dense_streams_equal_paged_streams(arch, horizon, reference, dense_qwen, torch_raw):
    """The dense engine's streams equal the paged gather route's (gemma3
    takes that route under the kernel bundle: the JAX paged engine's
    streams; qwen's paged kernel route commits the fresh token before it
    attends, so its paged streams are held against the gather route)."""
    dense = _tokens(_port(torch_raw, arch, paged=False, horizon=horizon).generate(
        _prompts(arch)[0], SamplingParams(max_new_tokens=GEN)))
    paged = _port(torch_raw, arch, horizon=horizon, paged_attn_impl="gather")
    assert dense == _tokens(paged.generate(_prompts(arch)[0],
                                           SamplingParams(max_new_tokens=GEN)))
    if arch == "gemma3-1b":
        assert dense == reference[arch]
    else:
        assert dense == dense_qwen


def test_sampled_streams_equal_jax_engine(reference, torch_raw):
    """Seeded temperature / top-p / top-k requests and a greedy one, qwen
    paged: the JAX engine's tokens."""
    pipe = _port(torch_raw, "qwen2.5-14b")
    outs = _serve(pipe.engine, _batches("qwen2.5-14b"),
                  [SamplingParams(max_new_tokens=GEN, **kw) for kw in SAMPLED])
    assert _tokens(outs) == reference["sampled"]


@pytest.mark.parametrize("paged", [False, True])
def test_speculative_nf4_draft_emits_target_only_streams(paged, reference, dense_qwen,
                                                         torch_raw):
    """A greedy nf4 draft arm over qwen (allowed: a pad-safe family)
    emits the target-only streams, dense and paged."""
    pipe = _port(torch_raw, "qwen2.5-14b", paged=paged, draft_spec="nf4",
                 draft_lookahead=3)
    assert pipe.draft_spec_str is not None
    outs = pipe.generate(_prompts("qwen2.5-14b")[0], SamplingParams(max_new_tokens=GEN))
    assert _tokens(outs) == (reference["qwen2.5-14b"] if paged else dense_qwen)
    m = pipe.engine.metrics()
    assert m.verify_calls > 0 and m.drafted_tokens > 0


def test_generate_stream_takes_token_ids(reference, torch_raw):
    pipe = _port(torch_raw, "gemma3-1b")
    gen = pipe.generate_stream(_prompts("gemma3-1b")[0][1], SamplingParams(max_new_tokens=GEN))
    got = []
    try:
        while True:
            got.append(next(gen))
    except StopIteration as stop:
        out = stop.value
    assert got == out.token_ids == reference["gemma3-1b"][1]


def test_lm_pipeline_refuses_the_enc_dec_calls(torch_raw):
    pipe = _port(torch_raw, "qwen2.5-14b")
    with pytest.raises(TypeError, match="needs an enc-dec model.*use generate"):
        pipe.translate(np.array([5, 6, 7]), "ita")
    with pytest.raises(TypeError, match="needs an enc-dec model.*use generate_stream"):
        pipe.translate_stream(np.array([5, 6, 7]), "ita")


def test_vlm_layout_rules(torch_raw):
    """A VLM serves dense only, without a draft arm (as the reference);
    its image rows count against max_len."""
    with pytest.raises(ValueError, match="paged serving supports"):
        _port(torch_raw, "llava-next-mistral-7b", paged=True)
    with pytest.raises(ValueError, match="speculative decoding supports"):
        _port(torch_raw, "llava-next-mistral-7b", draft_spec="nf4")
    pipe = _port(torch_raw, "llava-next-mistral-7b", max_len=16)
    with pytest.raises(ValueError, match="4 image rows"):
        pipe.engine.submit(_batches("llava-next-mistral-7b")[1],
                           SamplingParams(max_new_tokens=GEN))


def test_calibration_on_token_batches_equals_reference(raw, torch_raw):
    """w8a8 calibration batches ``{"tokens": ...}`` run through
    lm_forward: the per-site static scales equal the reference's."""
    arch = "qwen2.5-14b"
    batches = [{"tokens": t[None]} for t in _prompts(arch)[0][:2]]
    jp = j_quantize_tree(raw[arch], J_ALIASES["w8a8"].policy())
    want = j_calibrate(j_build_model(reduce_config(REGISTRY[arch])), jp,
                       JCtx(compute_dtype=jnp.float32),
                       [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # calibrated: no dynamic warning
        pipe = deploy(arch, "w8a8", params=torch_raw[arch], device="cpu",
                      calib_batches=batches, **{"paged": True, **KW})
    got = dict(pipe.ctx.act_scales)
    assert sorted(got) == sorted(want) and {"attn.qkv", "ffn.in", "ffn.out"} <= set(got)
    for site, v in want.items():
        assert got[site] == pytest.approx(float(v), rel=1e-5), site


def test_launcher_draws_the_reference_prompts(monkeypatch, capsys):
    """launch.serve --arch gemma3-1b submits randint(PRNGKey(i), (1, 4 +
    i % 4), 0, V) prompts, as the reference launcher does."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import ServeEngine
    seen = []
    real = ServeEngine.submit

    def submit(self, request, params=None, **kw):
        seen.append(np.asarray(request["tokens"]))
        return real(self, request, params, **kw)

    monkeypatch.setattr(ServeEngine, "submit", submit)
    serve.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--paged",
                "--requests", "5", "--gen", "4", "--max-len", "32"])
    out = capsys.readouterr().out
    assert out.count("[req ") == 10 and "served 5 requests" in out
    V = reduce_config(REGISTRY["gemma3-1b"]).vocab_size
    want = [np.asarray(jax.random.randint(jax.random.PRNGKey(i), (1, 4 + i % 4), 0, V))
            for i in range(5)]
    assert len(seen) == 5
    for got, w in zip(seen, want):
        np.testing.assert_array_equal(got, w)
    # and the port's draw at the full vocabulary
    np.testing.assert_array_equal(
        prng.randint(prng.prng_key(3), (1, 7), 0, 262144).numpy(),
        np.asarray(jax.random.randint(jax.random.PRNGKey(3), (1, 7), 0, 262144)))
