"""The port's LM training path against the JAX package's: the dense
(gemma3-1b, qwen2.5-14b, internlm2-20b, nemotron-4-15b), VLM
(llava-next-mistral-7b) and MoE (olmoe-1b-7b, moonshot-v1-16b-a3b)
families, reduced, f32 compute, on the CPU.

The batches are the reference's ``make_batch`` (SyntheticLM, 4 x 20
tokens; the VLM's 20 tokens after 4 image rows): 20 tokens span the
reduced configs' 8-token windows. Bounds:

- ``init(prng_key(0))`` draws the reference's ``PRNGKey(0)`` init: each
  normal within one f32 ulp of jax's, a scaled weight within two (3e-7
  relative; test_torch_train.py's enc-dec bound), the same tree paths.
- Loss within 1e-6 relative and every gradient leaf within 1e-5 of the
  leaf's largest element, on the reference's converted init (measured at
  most 1.7e-7 and 1.5e-6). An MoE routes every token to the same experts
  in every layer first.
- One step with ``remat=True`` against the reference's jitted step with
  ``remat=True`` (tests/test_archs.py::test_one_train_step's setup), the
  optimizer arms (8-bit moments, bf16 live parameters) over two steps and
  three QLoRA steps: test_torch_train.py's bounds for each.
- Port against port: ``microbatches=2`` with ``remat=True`` equals one
  full batch within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch, jax_tree_to_numpy  # noqa: E402
from test_torch_train import _assert_tree_close, _by_path, lr_fn_j, lr_fn_t  # noqa: E402

from repro.configs import REGISTRY, SHAPES  # noqa: E402
from repro.configs import reduce_config as j_reduce  # noqa: E402
from repro.core import attach_lora as j_attach_lora  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core import resolve_spec as j_resolve  # noqa: E402
from repro.data import make_batch as j_make_batch  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.train import compute_loss as j_compute_loss  # noqa: E402
from repro.train import make_qlora_step as j_make_qlora_step  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config, reduce_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.random import prng_key  # noqa: E402
from repro_torch.train import compute_loss, make_qlora_step, make_train_step  # noqa: E402
from repro_torch.tree import leaves_with_path, map_like  # noqa: E402

ARCHS = ["gemma3-1b", "qwen2.5-14b", "internlm2-20b", "nemotron-4-15b",
         "llava-next-mistral-7b", "olmoe-1b-7b", "moonshot-v1-16b-a3b"]
JCTX = JCtx(compute_dtype=jnp.float32)
CTX = Ctx(compute_dtype=torch.float32)
B, S = 4, 20
SPEC = SHAPES["train_4k"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as test_torch_train.py: the same arithmetic on
    every machine, and faster beside other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lms():
    """arch -> (JAX model, port model, the reference's PRNGKey(0) init),
    each built once, on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jm = j_build_model(j_reduce(REGISTRY[arch]))
            cache[arch] = (jm, build_model(reduce_config(get_config(arch)), "cpu"),
                           jm.init(jax.random.PRNGKey(0)))
        return cache[arch]
    return get


def lm_batch(cfg, seed=0):
    """The reference's make_batch: {"tokens", "loss_mask"} (and a VLM's
    "img_embeds"), B x S text tokens."""
    seq = S + cfg.num_patches if cfg.family == "vlm" else S
    return dict(j_make_batch(cfg, SPEC, seed=seed, batch=B, seq=seq))


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def assert_init_matches(jparams, tparams):
    want = dict(leaves_with_path(jax_to_torch(jparams)))
    got = dict(leaves_with_path(tparams))
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        assert w.shape == got[k].shape and w.dtype == got[k].dtype, k
        rel = float(((w - got[k]).abs() / w.abs().clamp(min=1e-30)).max())
        assert rel <= 3e-7, (k, rel)


def assert_loss_and_grads_match(jm, tm, jparams, batch, grad_tol=1e-5):
    """jax.value_and_grad(repro.train.compute_loss) against the port's
    compute_loss and torch.autograd on the converted parameters."""
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, jb: j_compute_loss(JCTX, jm, p, jb), has_aux=True))(jparams, _j(batch))
    live = map_like(lambda p: p.requires_grad_(), jax_to_torch(jparams))
    tl, tmet = compute_loss(CTX, tm, live, batch)
    paths = [k for k, _ in leaves_with_path(live)]
    grads = dict(zip(paths, torch.autograd.grad(
        tl, [v for _, v in leaves_with_path(live)], allow_unused=True)))
    for name in ("loss", "aux_loss", "total_loss"):
        w, g = float(jmet[name]), float(tmet[name].detach())
        assert abs(g - w) <= 1e-6 * abs(w), (name, g, w)
    want = dict(leaves_with_path(jax_to_torch(jg)))
    assert sorted(want) == sorted(grads)
    for k, w in want.items():
        g = torch.zeros_like(w) if grads[k] is None else grads[k]
        err = float((w - g).abs().max())
        assert err <= grad_tol * float(w.abs().max()), (k, err)


def moe_routes(monkeypatch, jm, tm, jparams, batch):
    """Every MoE layer's expert ids (G, Tg, k): the reference's (its
    ``jax.lax.top_k`` read back through a debug callback inside its
    jitted forward) and the port's (its ``route``)."""
    want, got = [], []
    top_k, route = jax.lax.top_k, tmoe.route

    def rec_top_k(x, k):
        w, e = top_k(x, k)
        jax.debug.callback(lambda e: want.append(np.asarray(e)), e, ordered=True)
        return w, e

    def rec_route(*a):
        out = route(*a)
        got.append(out[2].numpy())
        return out

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(tmoe, "route", rec_route)
    jax.block_until_ready(jax.jit(lambda p, b: jm.forward(JCTX, p, b))(jparams, _j(batch)))
    with torch.no_grad():
        tm.forward(CTX, jax_to_torch(jparams), batch)
    monkeypatch.undo()
    return want, got


@pytest.mark.parametrize("arch", ARCHS)
def test_key_init_draws_the_reference_init(lms, arch):
    jm, tm, jparams = lms(arch)
    assert_init_matches(jparams, tm.init(prng_key(0)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(lms, arch, monkeypatch):
    jm, tm, jparams = lms(arch)
    batch = lm_batch(jm.cfg)
    if tm.cfg.moe is not None:
        want, got = moe_routes(monkeypatch, jm, tm, jparams, batch)
        assert len(want) == len(got) == tm.cfg.num_layers
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    # the launcher's batches carry tokens alone: the mask defaults to ones
    if tm.cfg.family == "dense":
        batch.pop("loss_mask")
    assert_loss_and_grads_match(jm, tm, jparams, batch)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "llava-next-mistral-7b", "olmoe-1b-7b"])
def test_remat_step_matches_jitted_reference(lms, arch):
    jm, tm, jparams = lms(arch)
    j_init, j_step = j_make_train_step(jm, lr_fn=lr_fn_j, ctx=JCTX, remat=True)
    t_init, t_step = make_train_step(tm, lr_fn=lr_fn_t, ctx=CTX, remat=True)
    b = lm_batch(jm.cfg, seed=1)
    jstate, jmet = jax.jit(j_step)(j_init(jparams), _j(b))
    tstate, tmet = t_step(t_init(jax_to_torch(jparams)), b)
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-6 * abs(float(jmet[k])), k
    _assert_tree_close(jstate["params"], tstate["params"], 1e-5)


@pytest.mark.parametrize("arch,kw", [("gemma3-1b", dict(state_bits=8)),
                                     ("internlm2-20b", dict(param_dtype="bf16"))],
                         ids=["gemma3-8bit", "internlm2-bf16_master"])
def test_optimizer_arms_match_reference(lms, arch, kw):
    jm, tm, jparams = lms(arch)
    bf16 = "param_dtype" in kw
    jkw = dict(kw, param_dtype=jnp.bfloat16) if bf16 else kw
    tkw = dict(kw, param_dtype=torch.bfloat16) if bf16 else kw
    j_init, j_step = j_make_train_step(jm, lr_fn=lr_fn_j, ctx=JCTX, **jkw)
    t_init, t_step = make_train_step(tm, lr_fn=lr_fn_t, ctx=CTX, **tkw)
    jstate, tstate = j_init(jparams), t_init(jax_to_torch(jparams))
    j_step = jax.jit(j_step)
    rtol = 1e-4 if bf16 else 1e-6      # test_torch_train.py's bounds for these arms
    for seed in (2, 3):
        b = lm_batch(jm.cfg, seed)
        jstate, jmet = j_step(jstate, _j(b))
        tstate, tmet = t_step(tstate, b)
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= rtol * abs(float(jmet[k])), k
    _assert_tree_close(jstate["params"], tstate["params"], 2 ** -7 if bf16 else 1e-5)
    if bf16:
        _assert_tree_close(jstate["opt"]["master"], tstate["opt"]["master"], 1e-5)
    else:
        for name in ("m", "v"):
            want = _by_path(from_numpy_tree(jax_tree_to_numpy(jstate["opt"][name])))
            got = _by_path(tstate["opt"][name])
            for k, w in want.items():
                if k[-1] == "codes":
                    d = (w.int() - got[k].int()).abs()
                    assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-3 * d.numel(), k


def test_microbatches_with_remat_equal_one_full_batch(lms):
    _, tm, jparams = lms("qwen2.5-14b")
    b = lm_batch(tm.cfg, seed=4)
    runs = []
    for mb, remat in ((1, False), (2, True)):
        init, step = make_train_step(tm, lr_fn=lr_fn_t, ctx=CTX, microbatches=mb, remat=remat)
        runs.append(step(init(jax_to_torch(jparams)), b))
    (a, ma), (c, mc) = runs
    assert abs(float(ma["loss"]) - float(mc["loss"])) <= 1e-6
    for (k, x), (_, y) in zip(leaves_with_path(a["params"]), leaves_with_path(c["params"])):
        assert float((x - y).abs().max()) <= 1e-6, k


def test_qlora_steps_on_an_lm_match_reference(lms):
    jm, tm, jparams = lms("qwen2.5-14b")
    # one compiled call (eager, the reference's nf4 pass takes 14 s here);
    # both packages train from this same base
    policy = j_resolve("nf4").policy()
    qj = jax.jit(lambda p: j_attach_lora(j_quantize_tree(p, policy), jax.random.PRNGKey(1),
                                         rank=8))(jparams)
    qt = jax_to_torch(qj)
    before = {k: [getattr(v, f).clone() for f in QTensor._CHILDREN if getattr(v, f) is not None]
              for k, v in leaves_with_path(qt) if isinstance(v, QTensor)}
    assert before
    j_init, j_step = j_make_qlora_step(jm, lr_fn=lr_fn_j, ctx=JCTX)
    t_init, t_step = make_qlora_step(tm, lr_fn=lr_fn_t, ctx=CTX)
    jstate, tstate = j_init(qj), t_init(qt)
    j_step = jax.jit(j_step)
    for seed in (5, 6, 7):
        b = lm_batch(jm.cfg, seed)
        jstate, jmet = j_step(jstate, qj, _j(b))
        tstate, tmet = t_step(tstate, qt, b)
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5 * float(jmet["loss"])
    _assert_tree_close(jstate["adapters"], tstate["adapters"], 1e-5)
    for k, v in leaves_with_path(qt):            # the base: byte-identical
        if isinstance(v, QTensor):
            now = [getattr(v, f) for f in QTensor._CHILDREN if getattr(v, f) is not None]
            assert all(torch.equal(a, b) for a, b in zip(before[k], now)), k


def test_vlm_batches_equal_the_reference():
    jcfg = j_reduce(REGISTRY["llava-next-mistral-7b"])
    cfg = reduce_config(get_config("llava-next-mistral-7b"))
    spec = ShapeSpec(SPEC.name, SPEC.seq_len, SPEC.global_batch, SPEC.kind)
    for seq in (24, 10):                 # 20 text tokens; the floor of 8
        want = j_make_batch(jcfg, SPEC, seed=3, batch=B, seq=seq)
        got = make_batch(cfg, spec, seed=3, batch=B, seq=seq)
        assert sorted(want) == sorted(got) == ["img_embeds", "loss_mask", "tokens"]
        assert got["tokens"].shape == (B, max(seq - cfg.num_patches, 8))
        for k in want:
            assert want[k].dtype == got[k].dtype and want[k].tobytes() == got[k].tobytes(), k


def test_launch_train_an_lm_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu", "--steps", "3",
          "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert "done: 3 steps" in capsys.readouterr().out
