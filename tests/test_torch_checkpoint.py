"""The port's checkpoints share the JAX package's on-disk format (on the
CPU): a train state written by either package restores in the other,
leaf for leaf and byte for byte (bf16 parameters, f32 moments and master
copies, 8-bit moment codes and scales, the int32 step, quantized
QTensors); the manager's atomic publish, keep-k and step discovery
behave as the reference's; a restore into shardings is one rank's shard.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy, jax_to_torch, same_bytes  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.checkpoint import latest_step as j_latest_step  # noqa: E402
from repro.checkpoint import restore_tree as j_restore_tree  # noqa: E402
from repro.checkpoint import save_tree as j_save_tree  # noqa: E402
from repro.configs import REGISTRY, reduce_config as j_reduce  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core import resolve_spec as j_resolve  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    restore_tree, save_tree)
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core import quantize_tree, resolve_spec  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.parallel import param_specs, shard_tree  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

JCFG = j_reduce(REGISTRY["nllb600m"])
CFG = reduce_config(get_config("nllb600m"))


def _leaves(tree):
    """{path: tensor} of a port tree, a QTensor's fields included."""
    out = {}
    for k, v in leaves_with_path(tree):
        if isinstance(v, QTensor):
            out.update({k + (f,): getattr(v, f) for f in QTensor._CHILDREN
                        if getattr(v, f) is not None})
        elif v is not None:
            out[k] = v
    return out


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        x, y = la[k], lb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x,
                           y.view(torch.uint8) if y.dtype == torch.float8_e4m3fn else y), k


@pytest.fixture(scope="module")
def states():
    """One 8-bit, bf16-master train state per package, from the same
    reference init, one reference AdamW update in on seeded gradients (so
    nothing is zero)."""
    jm = j_build_model(JCFG)
    jp = jm.init(jax.random.PRNGKey(0))
    j_init, _ = j_make_train_step(jm, lr_fn=lambda s: 1e-3, state_bits=8,
                                  param_dtype=jnp.bfloat16,
                                  ctx=JCtx(compute_dtype=jnp.float32))
    jstate = j_init(jp)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype),
                         jstate["params"])
    params, opt, _ = jax.jit(lambda g, o, p: j_adamw_update(g, o, p, lr=1e-3,
                                                            state_bits=8))(
        grads, jstate["opt"], jstate["params"])
    jstate = {"params": params, "opt": opt}
    t_init, _ = make_train_step(build_model(CFG, "cpu"), lr_fn=lambda s: 1e-3, state_bits=8,
                                param_dtype=torch.bfloat16,
                                ctx=Ctx(compute_dtype=torch.float32))
    template = t_init(jax_to_torch(jp))
    return jstate, template


def test_jax_written_state_restores_in_the_port(tmp_path, states):
    jstate, template = states
    j_save_tree(str(tmp_path), jstate, step=1, extra={"loss": 2.5})
    restored, step, extra = restore_tree(str(tmp_path), template)
    assert (step, extra) == (1, {"loss": 2.5})
    _assert_same(restored, from_numpy_tree(jax_tree_to_numpy(jstate)))
    assert restored["params"]["embedding"].dtype == torch.bfloat16


def test_port_written_state_restores_in_the_reference(tmp_path, states):
    jstate, template = states
    tstate = from_numpy_tree(jax_tree_to_numpy(jstate))
    save_tree(str(tmp_path), tstate, step=3)
    restored, step, _ = j_restore_tree(str(tmp_path), jstate)
    assert step == 3
    want = dict(leaves_with_path(_leaves(tstate)))
    got = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert len(got) == len(want)
    ours = {jax.tree_util.keystr(kp): leaf for kp, leaf in got}
    for k, t in _leaves(tstate).items():
        j = np.asarray(ours["".join(f"[{p!r}]" for p in k)])
        assert same_bytes(j.reshape(-1), t.reshape(-1)) and j.shape == tuple(t.shape), k


def test_manifests_are_the_same(tmp_path, states):
    jstate, _ = states
    j_save_tree(str(tmp_path / "j"), jstate, step=1)
    save_tree(str(tmp_path / "t"), from_numpy_tree(jax_tree_to_numpy(jstate)), step=1)
    man = [json.load(open(tmp_path / d / "step_1" / "manifest.json")) for d in ("j", "t")]
    assert man[0] == man[1]


def test_quantized_tree_crosses_both_ways(tmp_path):
    jp = j_build_model(JCFG).init(jax.random.PRNGKey(2))
    qj = j_quantize_tree(jp, j_resolve("nf4").policy())
    qt = jax_to_torch(qj)
    j_save_tree(str(tmp_path / "j"), qj, step=1)
    _assert_same(restore_tree(str(tmp_path / "j"), qt)[0], qt)
    save_tree(str(tmp_path / "t"), qt, step=1)
    back = j_restore_tree(str(tmp_path / "t"), qj)[0]
    _assert_same(jax_to_torch(back), qt)


def _small(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.randn(4, generator=g).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32), "none": None}}


def _jsmall(t):
    import ml_dtypes
    b = t["params"]["b"].view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return {"params": {"w": jnp.asarray(t["params"]["w"].numpy()), "b": jnp.asarray(b)},
            "opt": {"step": jnp.asarray(3, jnp.int32), "none": None}}


def test_atomic_publish_keep_k_and_latest_step_as_reference(tmp_path):
    t = _small()
    for root, (mgr_cls, save, latest) in {
            "j": (JCheckpointManager, j_save_tree, j_latest_step),
            "t": (CheckpointManager, save_tree, latest_step)}.items():
        d = str(tmp_path / root)
        assert latest(d) is None
        tree = _jsmall(t) if root == "j" else t
        mgr = mgr_cls(d, keep=2, async_save=False)
        for s in (1, 5, 9):
            mgr.save(tree, s)
        os.makedirs(os.path.join(d, "step_12.tmp"))    # a crashed writer's leftovers
        assert latest(d) == 9 and mgr.latest_step() == 9
        save(d, tree, 12)                             # replaces the leftovers
        assert latest(d) == 12
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t")) \
        == ["step_12", "step_5", "step_9"]


def test_async_save_restore_and_errors(tmp_path):
    t = _small(1)
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(t, 4)
    mgr.wait()
    restored, step, _ = mgr.restore_latest(_small(2))
    assert step == 4 and restored["opt"]["none"] is None
    _assert_same(restored, t)
    with pytest.raises(ValueError, match="incompatible tree"):
        restore_tree(str(tmp_path), {"w": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        restore_tree(str(tmp_path / "empty"), t)
    # restoring into shardings = (specs, rank, mesh): each rank's shard of
    # the checkpoint is shard_tree of the full restore (nf4, tp2: decoded
    # scales, a cut inside w_out's one K block)
    qt = quantize_tree(build_model(CFG, "cpu").init(torch.Generator().manual_seed(0)),
                       resolve_spec("nf4").policy())
    save_tree(str(tmp_path / "q"), qt, step=1)
    specs = param_specs(qt, {"model": 2}, fsdp_scope="none")
    for rank in range(2):
        shard, step, _ = restore_tree(str(tmp_path / "q"), qt,
                                      shardings=(specs, rank, {"model": 2}))
        _assert_same(shard, shard_tree(qt, specs, rank, {"model": 2}))
        assert shard["decoder"]["layers"]["mlp"]["w_out"].shape[-2] == CFG.d_ff // 2
