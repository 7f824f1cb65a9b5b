"""whisper-base (the audio family) at smoke size: the encoder takes frame
embeddings (B, F, d) in place of source tokens, and everything after it
is the enc-dec path.

The port's dense and paged deploy() engines serve ``{"frames",
"tgt_in"}`` prompts (mixed frame counts and prompt lengths) with the JAX
engines' greedy streams and finish reasons (Pallas kernel routes,
interpret mode, the same int4 weights); decode equals the teacher-forced
forward (< 5e-3); ``make_batch``'s audio batch is byte-equal to the
reference's; one f32 AdamW step from ``PRNGKey(0)`` equals the
reference's (loss within 1e-6 relative, parameters within 1e-5); a
request preempted under page pressure resumes (its frames replayed with
its tokens) to its uncontended stream; bare token lists raise
``TypeError``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy, torch_to_jax  # noqa: E402

from repro.configs import REGISTRY, ShapeSpec as JShapeSpec, reduce_config  # noqa: E402
from repro.data import make_batch as j_make_batch  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro.serving import impl_routes as j_impl_routes  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config, reduce_config as t_reduce  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.optim import warmup_cosine  # noqa: E402
from repro_torch.random import prng_key  # noqa: E402
from repro_torch.serving import SamplingParams, deploy  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCH = "whisper-base"
GEN = 8
KW = dict(smoke=True, page_size=4, slots=3, max_len=16, horizon=4)
# (frames, prompt tokens) per request: two frame counts, 1-3 prompt tokens
SHAPES = [(12, 1), (7, 3), (12, 2), (9, 1)]


def _prompts(conv=lambda a: a, shapes=SHAPES):
    cfg = t_reduce(get_config(ARCH))
    rng = np.random.default_rng(0)
    return [{"frames": conv((0.1 * rng.standard_normal((1, f, cfg.d_model))).astype(np.float32)),
             "tgt_in": conv(rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32))}
            for f, n in shapes]


@pytest.fixture(scope="module")
def raw():
    return build_model(t_reduce(get_config(ARCH)), "cpu").init(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def reference(raw):
    out = {}
    for paged in (False, True):
        pipe = j_deploy(ARCH, "int4", params=torch_to_jax(raw), paged=paged, **KW,
                        **j_impl_routes("pallas"))
        outs = pipe.generate(_prompts(jnp.asarray), JSamplingParams(max_new_tokens=GEN))
        out[paged] = [(list(o.token_ids), o.finish_reason) for o in outs]
    return out


def _outs(outs):
    return [(list(o.token_ids), o.finish_reason) for o in outs]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_frame_prompts_stream_the_jax_engines_tokens(raw, reference, paged):
    pipe = deploy(ARCH, "int4", params=raw, device="cpu", paged=paged, **KW)
    outs = pipe.generate(_prompts(), SamplingParams(max_new_tokens=GEN))
    assert _outs(outs) == reference[paged]
    if paged:
        pipe.engine.allocator.check()
        assert pipe.engine.allocator.pages_in_use == 0
    with pytest.raises(TypeError, match="batch dicts"):
        pipe.generate([[1, 2, 3]])
    with pytest.raises(ValueError, match="cross-attention capacity"):
        pipe.engine.submit({"frames": np.zeros((1, 13, pipe.cfg.d_model), np.float32),
                            "tgt_in": np.ones((1, 1), np.int32)},
                           SamplingParams(max_new_tokens=4))


def test_decode_matches_forward(raw):
    cfg = t_reduce(get_config(ARCH))
    model = build_model(cfg, "cpu")
    ctx = Ctx(compute_dtype=torch.float32)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32))
    frames = torch.from_numpy((0.1 * rng.standard_normal((2, cfg.enc_len, cfg.d_model))
                               ).astype(np.float32))
    full, aux = model.forward(ctx, raw, {"tgt_in": toks, "frames": frames})
    assert float(aux) == 0.0
    cache = model.init_cache(2, 16, "f32")
    cache, lg = model.prefill(ctx, raw, cache, {"tgt_in": toks[:, :8], "frames": frames})
    errs = [float((lg[:, -1] - full[:, 7]).abs().max())]
    for t in range(8, 12):
        cache, lg = model.decode_step(ctx, raw, toks[:, t:t + 1], cache)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 5e-3


def test_make_batch_audio_is_byte_equal():
    jcfg, cfg = reduce_config(REGISTRY[ARCH]), t_reduce(get_config(ARCH))
    a = j_make_batch(jcfg, JShapeSpec("s", 10, 3, "train"), seed=4)
    b = make_batch(cfg, ShapeSpec("s", 10, 3, "train"), seed=4)
    assert sorted(a) == sorted(b) == ["frames", "loss_mask", "tgt_in", "tgt_out"]
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    assert b["frames"].shape == (3, cfg.enc_len, cfg.d_model)


def test_train_step_matches_reference():
    jcfg, cfg = reduce_config(REGISTRY[ARCH]), t_reduce(get_config(ARCH))
    jm, tm = j_build_model(jcfg), build_model(cfg, "cpu")
    b = make_batch(cfg, ShapeSpec("s", 8, 4, "train"), seed=0)
    j_init, j_step = j_make_train_step(
        jm, lr_fn=lambda s: j_warmup_cosine(s, peak_lr=3e-3, warmup=5, total=40),
        ctx=JCtx(compute_dtype=jnp.float32))
    t_init, t_step = make_train_step(
        tm, lr_fn=lambda s: warmup_cosine(s, peak_lr=3e-3, warmup=5, total=40),
        ctx=Ctx(compute_dtype=torch.float32))
    jstate, jmet = jax.jit(j_step)(j_init(jm.init(jax.random.PRNGKey(0))),
                                   {k: jnp.asarray(v) for k, v in b.items()})
    tstate, tmet = t_step(t_init(tm.init(prng_key(0))), b)
    for k in ("loss", "total_loss", "grad_norm"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-6 * abs(float(jmet[k])), k
    want = dict(leaves_with_path(from_numpy_tree(jax_tree_to_numpy(jstate["params"]))))
    got = dict(leaves_with_path(tstate["params"]))
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        assert float((w - got[k]).abs().max()) <= 1e-5, k


def test_preempted_request_resumes_to_its_uncontended_stream(raw):
    """Two requests of 5 prompt tokens + 10 new need 4 pages each; a pool
    of 5 evicts the younger mid-decode, and its resume prefills its frames
    with its prompt and stashed tokens: both streams equal an uncontended
    run's."""
    prompts = _prompts(shapes=[(12, 5), (9, 5)])
    sp = SamplingParams(max_new_tokens=10)
    kw = dict(KW, slots=2)
    free = deploy(ARCH, "int4", params=raw, device="cpu", paged=True, **kw)
    want = free.generate(prompts, sp)
    tight = deploy(ARCH, "int4", params=raw, device="cpu", paged=True, num_pages=5,
                   preempt_limit=16, **kw)
    got = tight.generate(prompts, sp)
    m = tight.engine.metrics()
    assert m.preemptions >= 1 and m.resumed_requests >= 1
    assert _outs(got) == _outs(want)
    assert all(o.finish_reason == "length" for o in got)
    tight.engine.allocator.check()
    assert tight.engine.allocator.pages_in_use == 0
