"""MoE serving and training parity at smoke size: the port's deploy()
engines for nllb600m-moe (dense and paged), olmoe-1b-7b (dense and
paged) and moonshot-v1-16b-a3b (paged) against the JAX engines of the
same layout (Pallas kernel routes, interpret mode) on the same int4
weights, greedy, token for token with equal finish reasons. The MoE
prefill dispatches with capacity over the bucketed prompt (its pad
tokens included), the decode steps dropless. Decode equals forward for
the three MoE archs at capacity factor 8.0 (< 5e-3), a greedy nf4 draft
over olmoe emits the target-only streams, and one nllb600m-moe train
step from ``PRNGKey(0)`` equals the reference's (loss and aux loss
within 1e-6 relative, parameters within 1e-5). Each JAX engine is built
once per module; both sides start from the port's seeded init."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy, torch_to_jax  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.data import SyntheticTranslation  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro.serving import impl_routes as j_impl_routes  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.optim import warmup_cosine  # noqa: E402
from repro_torch.serving import SamplingParams, deploy  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

GEN = 8
LM_KW = dict(smoke=True, page_size=4, slots=3, max_len=32, horizon=4)
ED_KW = dict(smoke=True, page_size=4, slots=3, max_len=16, horizon=4)
# LM prompts in two buckets (8, 16); sources of mixed lengths
LM_LENS = [5, 11, 14, 7]
SRC_LENS, CODES = [5, 9, 12, 7], [8, 1, 7, 9]
# (arch, paged) engines held against the JAX engines
RUNS = [("nllb600m-moe", False), ("nllb600m-moe", True), ("olmoe-1b-7b", False),
        ("olmoe-1b-7b", True), ("moonshot-v1-16b-a3b", True)]
ARCHS = sorted({a for a, _ in RUNS})


def _kw(arch):
    return ED_KW if arch == "nllb600m-moe" else LM_KW


def _prompts(arch, conv=lambda a: a):
    rng = np.random.default_rng(0)
    if arch == "nllb600m-moe":
        return [{"src_tokens": conv(rng.integers(16, 256, (1, n)).astype(np.int32)),
                 "tgt_in": conv(np.full((1, 1), c, np.int32))}
                for n, c in zip(SRC_LENS, CODES)]
    return [{"tokens": conv(rng.integers(0, 256, (1, n)).astype(np.int32))} for n in LM_LENS]


@pytest.fixture(scope="module")
def torch_raw():
    """Raw parameters per arch: the port's seeded init."""
    return {arch: build_model(t_reduce_config(get_config(arch)), "cpu").init(
        torch.Generator().manual_seed(0)) for arch in ARCHS}


@pytest.fixture(scope="module")
def reference(torch_raw):
    """The JAX engines' greedy outputs per (arch, paged)."""
    out = {}
    for arch, paged in RUNS:
        pipe = j_deploy(arch, "int4", params=torch_to_jax(torch_raw[arch]), paged=paged,
                        **_kw(arch), **j_impl_routes("pallas"))
        outs = pipe.generate(_prompts(arch, jnp.asarray), JSamplingParams(max_new_tokens=GEN))
        out[arch, paged] = [(list(o.token_ids), o.finish_reason) for o in outs]
    return out


def _port(torch_raw, arch, paged, **kw):
    return deploy(arch, "int4", params=torch_raw[arch], device="cpu", paged=paged,
                  **{**_kw(arch), **kw})


def _outs(outs):
    return [(list(o.token_ids), o.finish_reason) for o in outs]


@pytest.mark.parametrize("arch,paged", RUNS, ids=[f"{a}-{'paged' if p else 'dense'}"
                                                  for a, p in RUNS])
def test_greedy_streams_equal_jax_engine(arch, paged, reference, torch_raw):
    """generate() (an LM's 1-D token ids; nllb600m-moe's batch dicts):
    the JAX engine's streams and finish reasons; a paged engine frees
    every page."""
    pipe = _port(torch_raw, arch, paged)
    prompts = _prompts(arch)
    if arch != "nllb600m-moe":
        prompts = [p["tokens"][0] for p in prompts]
    outs = pipe.generate(prompts, SamplingParams(max_new_tokens=GEN))
    assert _outs(outs) == reference[arch, paged]
    if paged:
        pipe.engine.allocator.check()
        assert pipe.engine.allocator.pages_in_use == 0


def test_translate_serves_nllb600m_moe(reference, torch_raw):
    """translate() on the MoE variant: the JAX engine's streams for the
    same sources and language codes."""
    pipe = _port(torch_raw, "nllb600m-moe", True)
    outs = [pipe.translate(p["src_tokens"], int(p["tgt_in"][0, 0]),
                           SamplingParams(max_new_tokens=GEN))[0]
            for p in _prompts("nllb600m-moe")]
    assert _outs(outs) == reference["nllb600m-moe", True]


def test_speculative_nf4_draft_emits_target_only_streams(reference, torch_raw):
    """A greedy nf4 draft arm over olmoe (paged): the verify block goes
    through the dropless decode steps, so the streams are the target's."""
    pipe = _port(torch_raw, "olmoe-1b-7b", True, draft_spec="nf4", draft_lookahead=3)
    outs = pipe.generate([p["tokens"][0] for p in _prompts("olmoe-1b-7b")],
                         SamplingParams(max_new_tokens=GEN))
    assert _outs(outs) == reference["olmoe-1b-7b", True]
    m = pipe.engine.metrics()
    assert m.verify_calls > 0 and m.drafted_tokens > 0


B, S_FULL, S_PREF = 2, 12, 8


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, torch_raw):
    """Prefill + dropless decode steps give the teacher-forced forward's
    logits (< 5e-3, f32 caches) at capacity factor 8.0, where the forward
    drops nothing either (tests/test_decode_equiv.py's setting)."""
    cfg = t_reduce_config(get_config(arch))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = build_model(cfg, "cpu")
    params = torch_raw[arch]
    ctx = Ctx(compute_dtype=torch.float32)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S_FULL)).astype(np.int32))
    if cfg.family == "encdec":
        extra = {"src_tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, cfg.enc_len)).astype(np.int32))}
        tkey = "tgt_in"
    else:
        extra, tkey = {}, "tokens"
    full, _ = model.forward(ctx, params, {tkey: toks, **extra})
    cache = model.init_cache(B, 16, "f32")
    cache, lg = model.prefill(ctx, params, cache, {tkey: toks[:, :S_PREF], **extra})
    errs = [float((lg[:, -1] - full[:, S_PREF - 1]).abs().max())]
    for t in range(S_PREF, S_FULL):
        cache, lg = model.decode_step(ctx, params, toks[:, t:t + 1], cache)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 5e-3


def test_nllb600m_moe_train_step_matches_reference():
    """One f32 AdamW step of nllb600m-moe from the reference's PRNGKey(0)
    init (the port draws it from prng_key(0)): loss and aux loss within
    1e-6 relative, the aux loss non-zero, every parameter within 1e-5."""
    from repro_torch.random import prng_key
    jcfg = reduce_config(REGISTRY["nllb600m-moe"])
    cfg = t_reduce_config(get_config("nllb600m-moe"))
    jm, tm = j_build_model(jcfg), build_model(cfg, "cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=0, languages=["hin", "eng"])
    b = {k: v for k, v in ds.sample(8).items() if not isinstance(v, str)}
    j_init, j_step = j_make_train_step(
        jm, lr_fn=lambda s: j_warmup_cosine(s, peak_lr=3e-3, warmup=5, total=40),
        ctx=JCtx(compute_dtype=jnp.float32))
    t_init, t_step = make_train_step(
        tm, lr_fn=lambda s: warmup_cosine(s, peak_lr=3e-3, warmup=5, total=40),
        ctx=Ctx(compute_dtype=torch.float32))
    jstate, jmet = jax.jit(j_step)(j_init(jparams), {k: jnp.asarray(v) for k, v in b.items()})
    tstate, tmet = t_step(t_init(tm.init(prng_key(0))), b)
    assert float(jmet["aux_loss"]) > 0
    for k in ("loss", "aux_loss", "total_loss"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-6 * abs(float(jmet[k])), k
    want = dict(leaves_with_path(from_numpy_tree(jax_tree_to_numpy(jstate["params"]))))
    got = dict(leaves_with_path(tstate["params"]))
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        assert float((w - got[k]).abs().max()) <= 1e-5, k
