"""The port's LM training path for the recurrent families against the
JAX package's: mamba2-780m (SSM) and recurrentgemma-9b (hybrid),
reduced, f32 compute, on the CPU.

The batches are the reference's ``make_batch`` (SyntheticLM, 4 x 20
tokens): 20 tokens run four SSD chunks of 5 through the inter-chunk
recurrence (both packages take the largest divisor of S up to the
reduced chunk of 8, so no chunk is ragged) and span the hybrid's
8-token local window. Bounds are test_torch_lm_train.py's, but one:

- ``init(prng_key(0))`` within two f32 ulps of the reference's
  ``PRNGKey(0)`` init (3e-7 relative). ``a_log``'s linspace is the
  reference's bit for bit; its log is rounded once from f64 and lies
  within one ulp of XLA's CPU log, which is not correctly rounded.
- Loss within 1e-6 relative, every gradient leaf within 1e-5 of its
  largest element (measured at most 1.2e-6 for mamba2-780m and 2.5e-6
  for recurrentgemma-9b, whose RG-LRU doubling scan sums in another
  order than the reference's ``associative_scan``).
- One ``remat=True`` step against the reference's jitted ``remat=True``
  step: loss within 1e-6, the updated parameters within 1e-5, and the
  gradient norm within 1e-5 relative, not 1e-6 (measured 1.1e-6 for
  mamba2-780m and 8.8e-7 for recurrentgemma-9b; the gradients above).
  Port against port, ``remat`` leaves the gradients unchanged.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch  # noqa: E402
from test_torch_lm_train import (CTX, JCTX, _j, assert_init_matches,  # noqa: E402,F401
                                 assert_loss_and_grads_match, lm_batch, lms, one_thread)
from test_torch_train import _assert_tree_close, lr_fn_j, lr_fn_t  # noqa: E402

from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.models.ssm import _a_log, _linspace  # noqa: E402
from repro_torch.random import prng_key  # noqa: E402
from repro_torch.train import compute_loss, make_train_step  # noqa: E402
from repro_torch.tree import leaves_with_path, map_like  # noqa: E402

ARCHS = ["mamba2-780m", "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_key_init_draws_the_reference_init(lms, arch):
    jm, tm, jparams = lms(arch)
    assert_init_matches(jparams, tm.init(prng_key(0)))


@pytest.mark.parametrize("nh", [8, 48])          # reduced and full mamba2-780m
def test_a_log_is_the_reference_linspace(nh):
    want_x = jnp.linspace(1.0, 16.0, nh).astype(jnp.float32)
    np.testing.assert_array_equal(_linspace(1.0, 16.0, nh, "cpu").numpy(), np.asarray(want_x))
    got, want = _a_log(nh, "cpu").numpy(), np.asarray(jnp.log(want_x))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(lms, arch):
    jm, tm, jparams = lms(arch)
    assert_loss_and_grads_match(jm, tm, jparams, lm_batch(jm.cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_step_matches_jitted_reference(lms, arch):
    jm, tm, jparams = lms(arch)
    j_init, j_step = j_make_train_step(jm, lr_fn=lr_fn_j, ctx=JCTX, remat=True)
    t_init, t_step = make_train_step(tm, lr_fn=lr_fn_t, ctx=CTX, remat=True)
    b = lm_batch(jm.cfg, seed=1)
    jstate, jmet = jax.jit(j_step)(j_init(jparams), _j(b))
    tstate, tmet = t_step(t_init(jax_to_torch(jparams)), b)
    for k, rtol in (("loss", 1e-6), ("grad_norm", 1e-5), ("lr", 1e-6)):
        assert abs(float(tmet[k]) - float(jmet[k])) <= rtol * abs(float(jmet[k])), k
    _assert_tree_close(jstate["params"], tstate["params"], 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(lms, arch):
    _, tm, _ = lms(arch)
    b = lm_batch(tm.cfg, seed=2)
    grads = []
    for remat in (False, True):
        live = map_like(lambda p: p.requires_grad_(), tm.init(prng_key(0)))
        loss, _ = compute_loss(CTX, tm, live, b, remat=remat)
        grads.append(torch.autograd.grad(loss, [v for _, v in leaves_with_path(live)]))
    for x, y in zip(*grads):
        assert float((x - y).abs().max()) <= 1e-6


def test_launch_train_mamba2_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu", "--steps", "3",
          "--batch", "4", "--seq", "16", "--remat", "--ckpt-dir", str(tmp_path)])
    assert "done: 3 steps" in capsys.readouterr().out
