"""The port's optimizer against the JAX package's (on the CPU).

Seeded numpy trees go through the reference's jitted ``adamw_update`` and
the port's. Tolerances: parameters within 1e-6 after three steps (the
two sum the clipping norm and fuse the moment updates differently); the
8-bit moment codes byte-equal, their f32 scales within 1e-6 relative;
the schedules and ``quantize_grads_int8`` equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_bridge import jax_tree_to_numpy  # noqa: E402

from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.optim import quantize_grads_int8 as j_quantize_grads_int8  # noqa: E402
from repro.optim.compression import compressed_psum as j_compressed_psum  # noqa: E402
from repro.optim import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro.optim import warmup_linear as j_warmup_linear  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update, compressed_psum,  # noqa: E402
                               quantize_grads_int8, warmup_cosine, warmup_linear)
from repro_torch.tree import leaves_with_path  # noqa: E402

SHAPES = {"embed": (300, 8), "dec": {"w": (17, 33), "norm": (5,)}, "c": (2, 3, 40),
          "codes": "int8"}


def _tree(rng, dtype=np.float32, scale=1.0, shapes=SHAPES):
    out = {}
    for k, s in shapes.items():
        if isinstance(s, dict):
            out[k] = _tree(rng, dtype, scale, s)
        elif s == "int8":          # an integer leaf: no moments, no gradient
            out[k] = rng.integers(-100, 100, (4, 4)).astype(np.int8)
        else:
            out[k] = (rng.standard_normal(s) * scale).astype(dtype)
    return out


def _grads(rng, params, scale):
    return {k: _grads(rng, v, scale) if isinstance(v, dict)
            else None if v.dtype == np.int8
            else (rng.standard_normal(v.shape) * scale).astype(np.float32)
            for k, v in params.items()}


def _flat(tree):
    return {k: v for k, v in leaves_with_path(tree) if v is not None}


@pytest.mark.parametrize("step", [0, 1, 5, 19, 20, 21, 333, 1499, 1500, 2000])
def test_schedules_equal_reference(step):
    for j, t in ((j_warmup_cosine, warmup_cosine), (j_warmup_linear, warmup_linear)):
        kw = dict(peak_lr=3e-3, warmup=20, total=1500, floor=1e-5)
        want = float(j(step, **kw))
        assert t(step, **kw) == want
        got = t(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32 and float(got) == want


@pytest.mark.parametrize("bits,master,gscale", [(32, False, 1.0), (8, False, 1.0),
                                                 (8, True, 0.01), (32, True, 0.01)],
                         ids=["f32_clipped", "8bit_clipped", "8bit_master", "f32_master"])
def test_adamw_three_steps_equal_jitted_reference(bits, master, gscale):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = from_numpy_tree(p0)
    js = j_adamw_init(jp, state_bits=bits, master=master)
    ts = adamw_init(tp, state_bits=bits, master=master)
    upd = jax.jit(lambda g, s, p, lr: j_adamw_update(g, s, p, lr=lr, weight_decay=0.01,
                                                     state_bits=bits))
    for lr in (1e-2, 3e-3, 1e-3):
        g = _grads(rng, p0, gscale)
        jp, js, jm = upd(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(lr))
        tp, ts, tm = adamw_update(from_numpy_tree(g), ts, tp, lr=torch.tensor(lr),
                                  weight_decay=0.01, state_bits=bits)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(jm["grad_norm"])
    want, got = _flat(from_numpy_tree(jax_tree_to_numpy(jp))), _flat(tp)
    assert sorted(want) == sorted(got)
    for k in want:
        if want[k].dtype == torch.int8:                 # untouched
            assert torch.equal(want[k], got[k]), k
        else:
            assert float((want[k] - got[k]).abs().max()) <= 1e-6, k
    assert int(ts["step"]) == int(js["step"]) == 3
    jst = {"m": jax_tree_to_numpy(js["m"]), "v": jax_tree_to_numpy(js["v"]), **({"master": jax_tree_to_numpy(js["master"])} if master else {})}
    for name, tree in jst.items():
        w, t = _flat(from_numpy_tree(tree)), _flat(ts[name])
        assert sorted(w) == sorted(t), name
        for k in w:
            if k[-1] == "codes":
                assert torch.equal(w[k], t[k]), (name, k)
            else:
                np.testing.assert_allclose(t[k].numpy(), w[k].numpy(), rtol=1e-6, atol=1e-9,
                                           err_msg=str((name, k)))


def test_adamw_init_layout_matches_reference():
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    for bits in (32, 8):
        js = j_adamw_init(jax.tree.map(jnp.asarray, p0), state_bits=bits, master=True)
        ts = adamw_init(from_numpy_tree(p0), state_bits=bits, master=True)
        conv = from_numpy_tree({"m": jax_tree_to_numpy(js["m"]), "v": jax_tree_to_numpy(js["v"]),
                                "master": jax_tree_to_numpy(js["master"])})
        for name in ("m", "v", "master"):
            w, t = dict(leaves_with_path(conv[name])), dict(leaves_with_path(ts[name]))
            assert sorted(w) == sorted(t)
            for k in w:
                assert (w[k] is None) == (t[k] is None), (name, k)
                if w[k] is not None:
                    assert w[k].dtype == t[k].dtype and torch.equal(w[k], t[k]), (name, k)


def test_quantize_grads_int8_byte_equal(tmp_path):
    """The gradient codes and scales byte-equal the compiled reference's;
    ``compressed_psum`` over a one-rank gloo group (the two-rank case is
    in tests/test_torch_tp.py) is the reference's under ``jax.vmap`` with
    a one-member named axis, byte for byte."""
    import torch.distributed as dist
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((4097,)) * rng.uniform(0.01, 10, (4097,))).astype(np.float32)
    g[:256] = 0.0                                    # an all-zero block takes scale 1
    jc, js = jax.jit(j_quantize_grads_int8)(jnp.asarray(g))
    tc, ts = quantize_grads_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    want = jax.vmap(lambda t: j_compressed_psum(t, "dp"), axis_name="dp")(
        {"g": jnp.asarray(g)[None]})["g"][0]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        got = compressed_psum({"g": torch.from_numpy(g), "none": None})
    finally:
        dist.destroy_process_group()
    assert got["none"] is None
    assert got["g"].numpy().tobytes() == np.asarray(want).tobytes()
