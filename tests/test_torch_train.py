"""The port's enc-dec training path against the JAX package's (smoke
nllb600m, f32 compute, on the CPU).

Every comparison starts from the reference's own initial parameters,
converted (``convert.py``), and the same seeded ``SyntheticTranslation``
batches. Tolerances (f32; the two packages sum in different orders):
loss within 1e-6 relative and every gradient leaf within 1e-5 of the
leaf's largest gradient; after two jitted reference steps the metrics
within 1e-6 relative (1e-4 with bf16 live parameters, whose bf16
gradients round each element on its own), f32 parameters within 1e-5
(bf16 ones within one bf16 ulp) and the 8-bit moment codes within one
code at no more than 0.1% of positions (the gradients differ in their
last bits; from equal gradients the codes are byte-equal,
test_torch_optim.py); 20-step losses within
1e-4 relative step by step (Adam normalizes each update, so last-ulp
gradient differences grow over steps); three QLoRA steps: adapters
within 1e-5, the quantized base byte-identical. Port against port
(microbatches, remat): 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy, jax_to_torch  # noqa: E402

from repro.configs import REGISTRY, SHAPES, ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs import param_count as j_param_count  # noqa: E402
from repro.configs import reduce_config as j_reduce  # noqa: E402
from repro.core import attach_lora as j_attach_lora  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core import resolve_spec as j_resolve  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data import SyntheticTranslation  # noqa: E402
from repro.data import batch_iterator as j_batch_iterator  # noqa: E402
from repro.data import make_batch as j_make_batch  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro.train import compute_loss as j_compute_loss  # noqa: E402
from repro.train import make_qlora_step as j_make_qlora_step  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config, param_count, reduce_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.data import SyntheticLM, batch_iterator, make_batch  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.optim import warmup_cosine  # noqa: E402
from repro_torch.train import (TrainLoop, compute_loss, make_qlora_step,  # noqa: E402
                               make_train_step)
from repro_torch.tree import leaves_with_path, map_like  # noqa: E402

JCFG = j_reduce(REGISTRY["nllb600m"])
CFG = reduce_config(get_config("nllb600m"))
JCTX = JCtx(compute_dtype=jnp.float32)
CTX = Ctx(compute_dtype=torch.float32)
LANGS = ["hin", "eng"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's small training ops: their
    arithmetic, and so a fit's trajectory and scores, is then the same on
    every machine, and beside other test workers it runs faster."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def lr_fn_j(s):
    return j_warmup_cosine(s, peak_lr=3e-3, warmup=5, total=40)


def lr_fn_t(s):
    return warmup_cosine(s, peak_lr=3e-3, warmup=5, total=40)


def _by_path(tree):
    return {k: v for k, v in leaves_with_path(tree) if v is not None}


def _assert_tree_close(jtree, ttree, atol, rel=False):
    want = _by_path(from_numpy_tree(jax_tree_to_numpy(jtree)))
    got = _by_path(ttree)
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, QTensor):
            continue
        if w.dtype in (torch.int8, torch.int32):
            assert torch.equal(w, g), k
            continue
        tol = atol * (float(w.abs().max()) + 1e-30) if rel else atol
        err = float((w.float() - g.float()).abs().max())
        assert err <= tol, (k, err, tol)


def _batches(n, batch=8, seed=0):
    ds = SyntheticTranslation(CFG.vocab_size, CFG.enc_len, seed=seed, languages=LANGS)
    return [{k: v for k, v in ds.sample(batch).items() if not isinstance(v, str)}
            for _ in range(n)]


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jparams():
    return j_build_model(JCFG).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def models():
    return j_build_model(JCFG), build_model(CFG, "cpu")


def test_configs_and_batches_match_reference():
    assert param_count(get_config("nllb600m")) == j_param_count(REGISTRY["nllb600m"])
    assert param_count(CFG) == j_param_count(JCFG)
    assert ShapeSpec("s", 32, 4, "train") == ShapeSpec(*JShapeSpec("s", 32, 4, "train").__dict__.values())
    a, b = JSyntheticLM(CFG.vocab_size, 24, seed=3), SyntheticLM(CFG.vocab_size, 24, seed=3)
    for _ in range(2):
        x, y = a.sample(4), b.sample(4)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    spec = SHAPES["train_4k"]
    it_j = j_batch_iterator(JCFG, spec, seed=5, batch=3, seq=20)
    it_t = batch_iterator(CFG, ShapeSpec(spec.name, spec.seq_len, spec.global_batch, spec.kind),
                          seed=5, batch=3, seq=20)
    for _ in range(2):
        x, y = next(it_j), next(it_t)
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    # audio batches: tests/test_torch_audio.py; VLM batches (tokens cut to
    # max(S - P, 8) after the image rows) equal the reference's byte for byte
    vlm = reduce_config(get_config("llava-next-mistral-7b"))
    want = j_make_batch(j_reduce(REGISTRY["llava-next-mistral-7b"]), spec, seed=2, batch=2,
                        seq=8)
    got = make_batch(vlm, spec, seed=2, batch=2, seq=8)
    assert sorted(want) == sorted(got) == ["img_embeds", "loss_mask", "tokens"]
    for k in want:
        assert want[k].dtype == got[k].dtype and want[k].tobytes() == got[k].tobytes(), k


def test_key_init_draws_the_reference_init(jparams):
    """build_model(...).init(prng_key(seed)) draws jax's PRNGKey(seed) init:
    the same splits and normals; each normal within one f32 ulp of jax's,
    a scaled weight within two (3e-7 relative)."""
    from repro_torch.random import normal, prng_key, split
    want = dict(leaves_with_path(jax_to_torch(jparams)))
    got = dict(leaves_with_path(build_model(CFG, "cpu").init(prng_key(0))))
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        assert w.shape == got[k].shape, k
        assert float(((w - got[k]).abs() / w.abs().clamp(min=1e-30)).max()) <= 3e-7, k
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    np.testing.assert_array_equal(np.asarray(keys).astype(np.int64),
                                  split(prng_key(7), 3).numpy())
    a = np.asarray(jax.random.normal(keys[1], (64, 96)))
    b = normal(split(prng_key(7), 3)[1], (64, 96)).numpy()
    np.testing.assert_allclose(b, a, rtol=2.4e-7, atol=0)


def test_loss_and_gradients_match_reference(jparams, models):
    jm, tm = models
    b = _batches(1)[0]
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, jb: j_compute_loss(JCTX, jm, p, jb), has_aux=True))(jparams, _j(b))
    live = map_like(lambda p: p.requires_grad_(), jax_to_torch(jparams))
    tl, tmet = compute_loss(CTX, tm, live, b)
    leaves = [v for _, v in leaves_with_path(live)]
    grads = dict(zip([k for k, _ in leaves_with_path(live)],
                     torch.autograd.grad(tl, leaves)))
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert abs(float(tmet["loss"].detach()) - float(jmet["loss"])) <= 1e-6 * abs(float(jmet["loss"]))
    want = dict(leaves_with_path(jax_to_torch(jg)))
    assert sorted(want) == sorted(grads)
    for k, w in want.items():
        err = float((w - grads[k]).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (k, err)


STEP_VARIANTS = [dict(), dict(state_bits=8), dict(param_dtype="bf16")]


@pytest.mark.parametrize("kw", STEP_VARIANTS, ids=["f32", "8bit", "bf16_master"])
def test_train_step_matches_jitted_reference(jparams, models, kw):
    jm, tm = models
    jkw = dict(kw, param_dtype=jnp.bfloat16) if "param_dtype" in kw else kw
    tkw = dict(kw, param_dtype=torch.bfloat16) if "param_dtype" in kw else kw
    j_init, j_step = j_make_train_step(jm, lr_fn=lr_fn_j, ctx=JCTX, **jkw)
    t_init, t_step = make_train_step(tm, lr_fn=lr_fn_t, ctx=CTX, **tkw)
    jstate = j_init(jparams)
    tstate = t_init(jax_to_torch(jparams))
    _assert_tree_close(jstate, tstate, 0.0)
    j_step = jax.jit(j_step)
    # bf16 gradients (bf16 live parameters) round each element on its own:
    # a last-ulp difference of the f32 gradient flips some of them
    rtol = 1e-4 if "param_dtype" in kw else 1e-6
    for b in _batches(2):
        jstate, jmet = j_step(jstate, _j(b))
        tstate, tmet = t_step(tstate, b)
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= rtol * abs(float(jmet[k])), k
    # bf16 live parameters round from the f32 master: one bf16 ulp apart
    atol = 2 ** -7 if "param_dtype" in kw else 1e-5
    _assert_tree_close(jstate["params"], tstate["params"], atol)
    if "param_dtype" in kw:
        _assert_tree_close(jstate["opt"]["master"], tstate["opt"]["master"], 1e-5)
    if kw.get("state_bits") == 8:
        # the gradients differ in their last bits, so a moment that lands
        # on a rounding edge of the int8 grid may take the next code
        # (byte-equal codes from equal gradients: test_torch_optim.py)
        for name in ("m", "v"):
            want = _by_path(from_numpy_tree(jax_tree_to_numpy(jstate["opt"][name])))
            got = _by_path(tstate["opt"][name])
            for k, w in want.items():
                if k[-1] == "codes":
                    d = (w.int() - got[k].int()).abs()
                    assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-3 * d.numel(), k


def test_microbatches_equal_one_full_batch(jparams, models):
    _, tm = models
    b = _batches(1, batch=8)[0]
    states = []
    for mb in (1, 2):
        init, step = make_train_step(tm, lr_fn=lr_fn_t, ctx=CTX, microbatches=mb)
        st, met = step(init(jax_to_torch(jparams)), b)
        states.append((st, met))
    (a, ma), (c, mc) = states
    assert abs(float(ma["loss"]) - float(mc["loss"])) <= 1e-6
    for (k, x), (_, y) in zip(leaves_with_path(a["params"]), leaves_with_path(c["params"])):
        assert float((x - y).abs().max()) <= 1e-6, k


def test_remat_gives_the_same_gradients(jparams, models):
    _, tm = models
    b = _batches(1)[0]
    grads = []
    for remat in (False, True):
        live = map_like(lambda p: p.requires_grad_(), jax_to_torch(jparams))
        loss, _ = compute_loss(CTX, tm, live, b, remat=remat)
        grads.append(torch.autograd.grad(loss, [v for _, v in leaves_with_path(live)]))
    for x, y in zip(*grads):
        assert float((x - y).abs().max()) <= 1e-6


def test_twenty_step_trajectory_matches_reference(jparams, models):
    jm, tm = models
    j_init, j_step = j_make_train_step(jm, lr_fn=lr_fn_j, ctx=JCTX)
    t_init, t_step = make_train_step(tm, lr_fn=lr_fn_t, ctx=CTX)
    jstate, tstate = j_init(jparams), t_init(jax_to_torch(jparams))
    j_step = jax.jit(j_step)
    jl, tl = [], []
    for b in _batches(20):
        jstate, jmet = j_step(jstate, _j(b))
        tstate, tmet = t_step(tstate, b)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert np.mean(tl[-5:]) < tl[0]


def test_qlora_steps_match_reference(jparams, models):
    jm, tm = models
    qj = j_quantize_tree(jparams, j_resolve("nf4").policy())
    qj = j_attach_lora(qj, jax.random.PRNGKey(1), rank=8)
    qt = jax_to_torch(qj)
    before = {k: [getattr(v, f).clone() for f in QTensor._CHILDREN if getattr(v, f) is not None]
              for k, v in leaves_with_path(qt) if isinstance(v, QTensor)}
    j_init, j_step = j_make_qlora_step(jm, lr_fn=lr_fn_j, ctx=JCTX)
    t_init, t_step = make_qlora_step(tm, lr_fn=lr_fn_t, ctx=CTX)
    jstate, tstate = j_init(qj), t_init(qt)
    j_step = jax.jit(j_step)
    for b in _batches(3):
        jstate, jmet = j_step(jstate, qj, _j(b))
        tstate, tmet = t_step(tstate, qt, b)
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5 * float(jmet["loss"])
    _assert_tree_close(jstate["adapters"], tstate["adapters"], 1e-5)
    moved = [float((v - w).abs().max()) for (_, v), (_, w) in
             zip(leaves_with_path(tstate["adapters"]), leaves_with_path(t_init(qt)["adapters"]))
             if v is not None]
    assert max(moved) > 0
    for k, v in leaves_with_path(qt):            # the base: byte-identical
        if isinstance(v, QTensor):
            now = [getattr(v, f) for f in QTensor._CHILDREN if getattr(v, f) is not None]
            assert all(torch.equal(a, b) for a, b in zip(before[k], now)), k


@pytest.mark.parametrize("ctx", [Ctx(matmul_impl="kernel"), Ctx(use_fasst_kernel=True)],
                         ids=["qmm", "fasst"])
def test_training_on_a_kernel_route_raises(models, ctx):
    _, tm = models
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(tm, lr_fn=lr_fn_t, ctx=ctx)
    with pytest.raises(ValueError, match="no backward"):
        make_qlora_step(tm, lr_fn=lr_fn_t, ctx=ctx)


def _counting_step(slow_at=None, preempt_at=None, loop=None):
    """A step that takes 50 ms (1 s at ``slow_at``), so the straggler
    watchdog's 3 x EMA threshold sits far above scheduling jitter."""
    import time

    def step(state, batch):
        n = int(state["n"]) + 1
        time.sleep(1.0 if n == slow_at else 0.05)
        if n == preempt_at:
            loop[0].mgr.preempted = True
        return {"n": torch.tensor(n, dtype=torch.int32)}, {"loss": torch.tensor(1.0 / n)}
    return step


def test_train_loop_resume_preemption_and_stragglers(tmp_path):
    batches = iter(lambda: {}, None)
    logs = []
    loop = TrainLoop(_counting_step(slow_at=6), str(tmp_path / "a"), ckpt_every=2, keep=2,
                     log_fn=logs.append)
    state, hist = loop.run({"n": torch.tensor(0, dtype=torch.int32)}, batches, 7)
    assert int(state["n"]) == 7 and len(hist) == 7
    assert loop.stragglers == 1 and any("[straggler] step 5:" in line for line in logs)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["step_4", "step_6"]
    fresh = TrainLoop(_counting_step(), str(tmp_path / "a"), ckpt_every=2, log_fn=logs.append)
    state, start = fresh.maybe_resume({"n": torch.tensor(0, dtype=torch.int32)})
    assert start == 6 and int(state["n"]) == 6
    state, hist = fresh.run(state, batches, 9, start_step=start)
    assert int(state["n"]) == 9 and len(hist) == 3

    holder = []
    loop = TrainLoop(_counting_step(preempt_at=3, loop=holder), str(tmp_path / "b"),
                     ckpt_every=0, log_fn=logs.append)
    holder.append(loop)
    state, hist = loop.run({"n": torch.tensor(0, dtype=torch.int32)}, batches, 10)
    assert len(hist) == 3 and loop.mgr.latest_step() == 3
    assert any("[preempt]" in line for line in logs)


def test_launch_train_smoke_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--smoke", "--device", "cpu", "--steps", "20", "--ckpt-dir", str(tmp_path),
          "--ckpt-every", "10"])
    out = capsys.readouterr().out
    assert "done: 20 steps" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_10", "step_20"]
