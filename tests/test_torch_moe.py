"""The port's MoE layer and the four new configs against the JAX package
(CPU, f32).

``moe_apply`` on the same numpy-seeded inputs and the same converted
``moe_init`` parameters: dropless, capacity factors 1.0 and 1.25 on a
right-padded batch, one group a row and one global group, both
placement modes, GLU (silu) and plain (relu) experts. Outputs within
1e-5 abs / 1e-4 rel, the aux loss within 1e-6, and the routing (expert
ids, gate weights) and the kept / dropped assignments equal. The
reference's own MoE invariants (tests/test_moe.py) hold on the port,
``moe_init`` from a key draws the reference's parameters (two f32 ulps),
the reduced and full configs equal the reference's, and the quantized
trees of nllb600m-moe, olmoe-1b-7b, moonshot-v1-16b-a3b and whisper-base
are byte-equal at int4, fp4, nf4 (double-quantized 4-D expert stacks),
w8a8 and fp8e2e.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch, same_bytes, tree_same_bytes  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core.spec import ALIASES as J_ALIASES  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models.moe import moe_apply as j_moe_apply  # noqa: E402
from repro.models.moe import moe_init as j_moe_init  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.core import quantize_tree, resolve_spec  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.random import prng_key  # noqa: E402

ARCHS = ["nllb600m-moe", "olmoe-1b-7b", "moonshot-v1-16b-a3b", "whisper-base"]
JCTX = JCtx(compute_dtype=jnp.float32)
CTX = Ctx(compute_dtype=torch.float32)
E, K, D, FF = 4, 2, 16, 24
B, S, PAD = 2, 24, 7           # each row's last PAD positions are padding


def _x(seed=1):
    """A right-padded (B, S, d) batch: each row's tail is one pad vector,
    as a bucketed prefill hands the FFN its pad tokens."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    x[:, S - PAD:] = rng.standard_normal(D).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def layers():
    """act -> (JAX moe_init params, converted port params)."""
    out = {}
    for act in ("silu_glu", "relu"):
        p = j_moe_init(jax.random.PRNGKey(0), D, FF, E, act)
        out[act] = (p, jax_to_torch(p))
    return out


def _j_routing(params, x, top_k, C, G):
    """The reference's routing and dispatch (models/moe.py, the lines
    before the buffer), run in JAX: expert ids, gate weights, and per
    sorted assignment the kept mask and the token."""
    Bx, Sx, d = x.shape
    Tg = Bx * Sx // G
    xt = x.reshape(G, Tg, d)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xt, params["router"]), axis=-1)
    gate_w, gate_e = jax.lax.top_k(probs, top_k)
    gate_w = gate_w / jnp.maximum(jnp.sum(gate_w, -1, keepdims=True), 1e-9)
    TK = Tg * top_k
    flat_e = gate_e.reshape(G, TK)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    e_sorted = jnp.take_along_axis(flat_e, order, axis=1)
    counts = jnp.sum(jax.nn.one_hot(flat_e, params["router"].shape[-1], dtype=jnp.int32), 1)
    starts = jnp.cumsum(counts, axis=1) - counts
    pos = jnp.arange(TK)[None] - jnp.take_along_axis(starts, e_sorted, axis=1)
    t_sorted = jnp.take_along_axis(
        jnp.broadcast_to(jnp.repeat(jnp.arange(Tg), top_k)[None], (G, TK)), order, axis=1)
    return (np.asarray(gate_e), np.asarray(gate_w), np.asarray(pos < C),
            np.asarray(t_sorted))


def _t_routing(params, x, top_k, C, G):
    """The port's routing and dispatch: the same four arrays."""
    Bx, Sx, d = x.shape
    _, gate_w, gate_e = tmoe.route(params["router"], x.reshape(G, Bx * Sx // G, d), top_k)
    TK = gate_e.shape[1] * top_k
    order, buf_idx = tmoe._dispatch(gate_e.reshape(G, TK), params["router"].shape[-1], C)
    return (gate_e.numpy(), gate_w.numpy(), (buf_idx < params["router"].shape[-1] * C).numpy(),
            (order // top_k).numpy())


CASES = {"dropless": dict(dropless=True),
         "cf1.0": dict(capacity_factor=1.0),
         "cf1.25": dict(capacity_factor=1.25),
         "cf1.0-one-group": dict(capacity_factor=1.0, dispatch_groups=1),
         "cf1.25-tensor": dict(capacity_factor=1.25, parallel_mode="tensor"),
         "dropless-tensor-one-group": dict(dropless=True, parallel_mode="tensor",
                                           dispatch_groups=1)}


@pytest.mark.parametrize("act", ["silu_glu", "relu"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(layers, act, case):
    """Outputs within 1e-5 abs / 1e-4 rel, the aux loss within 1e-6, and
    the routing and the kept / dropped assignments equal."""
    kw = CASES[case]
    jp, tp = layers[act]
    x = _x()
    jy, jaux = j_moe_apply(JCTX, jp, jnp.asarray(x), top_k=K, act=act, **kw)
    ty, taux = tmoe.moe_apply(CTX, tp, torch.from_numpy(x), top_k=K, act=act, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-4)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    G = kw.get("dispatch_groups") or B
    C = tmoe.capacity(B * S // G, K, E, kw.get("capacity_factor", 1.25),
                      kw.get("dropless", False))
    want = _j_routing(jp, jnp.asarray(x), K, C, G)
    got = _t_routing(tp, torch.from_numpy(x), K, C, G)
    for name, w, g in zip(("expert ids", "gate weights", "kept", "tokens"), want, got):
        if name == "gate weights":
            np.testing.assert_allclose(g, w, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_capacity_drops_the_reference_assignments(layers):
    """Under capacity factor 1.0 (C = 6 of a row's 24 tokens x 2
    assignments over 4 experts) some assignments drop, the pad tokens'
    among them; the port drops exactly the reference's, and a token whose
    every assignment dropped outputs zeros in both."""
    jp, tp = layers["silu_glu"]
    x = _x()
    C = tmoe.capacity(S, K, E, 1.0, False)
    assert C == round(S * K / E)
    _, _, jkeep, jtok = _j_routing(jp, jnp.asarray(x), K, C, B)
    _, _, tkeep, ttok = _t_routing(tp, torch.from_numpy(x), K, C, B)
    np.testing.assert_array_equal(tkeep, jkeep)
    np.testing.assert_array_equal(ttok, jtok)
    dropped = ~tkeep
    assert dropped.sum() > 0
    # the pad tokens all route alike, so their shared experts overflow
    assert dropped[ttok >= S - PAD].sum() > 0
    jy, _ = j_moe_apply(JCTX, jp, jnp.asarray(x), top_k=K, capacity_factor=1.0)
    ty, _ = tmoe.moe_apply(CTX, tp, torch.from_numpy(x), top_k=K, capacity_factor=1.0)
    kept_per_token = np.zeros((B, S), np.int64)
    for g in range(B):
        np.add.at(kept_per_token[g], ttok[g], tkeep[g].astype(np.int64))
    gone = kept_per_token == 0
    assert np.all(ty.numpy()[gone] == 0) and np.all(np.asarray(jy)[gone] == 0)


def test_capacity_rounds_half_to_even():
    """C = round(Tg * k / E * cf) with Python's round: 2.5 -> 2, 3.5 -> 4."""
    assert tmoe.capacity(5, 2, 4, 1.0, False) == 2
    assert tmoe.capacity(7, 2, 4, 1.0, False) == 4
    assert tmoe.capacity(1, 2, 64, 1.25, False) == 1
    assert tmoe.capacity(9, 2, 4, 1.0, True) == 9


def test_top_k_ties_take_the_lower_expert():
    """Equal probabilities route to the lower expert ids, as
    jax.lax.top_k does."""
    router = torch.zeros((D, E))
    router[:, 3] = 1.0
    x = torch.ones((1, 2, D))
    _, _, e = tmoe.route(router, x, 2)
    _, je = jax.lax.top_k(jax.nn.softmax(jnp.einsum(
        "gtd,de->gte", jnp.ones((1, 2, D)), jnp.asarray(router.numpy())), -1), 2)
    assert e.tolist() == np.asarray(je).tolist() == [[[3, 0], [3, 0]]]


def _dense_oracle(tp, x, top_k):
    """The reference test's per-token loop on the port's parameters:
    every token runs its top-k experts, no capacity."""
    xt = x.reshape(-1, x.shape[-1]).astype(np.float32)
    router = tp["router"].numpy()
    wg, wu, wd = (tp["experts"][n].numpy() for n in ("w_gate", "w_up", "w_down"))
    logits = xt @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        top = np.argsort(-probs[t])[:top_k]
        w = probs[t, top] / probs[t, top].sum()
        for e, wt in zip(top, w):
            h = xt[t] @ wg[e]
            h = (h * (1 / (1 + np.exp(-h)))) * (xt[t] @ wu[e])
            out[t] += wt * (h @ wd[e])
    return out.reshape(x.shape)


def test_dispatch_matches_dense_loop_dropless(layers):
    _, tp = layers["silu_glu"]
    x = np.random.default_rng(3).standard_normal((2, 6, D)).astype(np.float32)
    y, aux = tmoe.moe_apply(CTX, tp, torch.from_numpy(x), top_k=K, dropless=True)
    np.testing.assert_allclose(y.numpy(), _dense_oracle(tp, x, K), atol=2e-4, rtol=1e-3)
    assert float(aux) > 0


def test_capacity_drops_are_bounded(layers):
    """With cf 1.0 some tokens drop; outputs stay finite, and the norm can
    only shrink against dropless."""
    _, tp = layers["silu_glu"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 32, D)).astype(np.float32))
    y_drop, _ = tmoe.moe_apply(CTX, tp, x, top_k=K, capacity_factor=1.0)
    y_full, _ = tmoe.moe_apply(CTX, tp, x, top_k=K, dropless=True)
    assert bool(torch.isfinite(y_drop).all())
    assert float(y_drop.norm()) <= float(y_full.norm()) + 1e-4


def test_aux_loss_penalizes_collapse(layers):
    """Uniform-ish routing gives aux ~ 1; collapsed routing gives ~ E."""
    _, tp = layers["silu_glu"]
    x = torch.from_numpy(np.abs(np.random.default_rng(5).standard_normal(
        (1, 64, D))).astype(np.float32) + 0.1)
    collapsed = dict(tp, router=torch.zeros((D, E)))
    collapsed["router"][:, 0] = 2.0
    _, aux_rand = tmoe.moe_apply(CTX, tp, x, top_k=1)
    _, aux_coll = tmoe.moe_apply(CTX, collapsed, x, top_k=1)
    assert float(aux_coll) > 2.0 * float(aux_rand)
    assert float(aux_coll) == pytest.approx(E, rel=0.1)


def test_parallel_modes_give_the_same_result_and_bad_mode_raises(layers):
    _, tp = layers["relu"]
    x = torch.from_numpy(_x())
    y1, _ = tmoe.moe_apply(CTX, tp, x, top_k=K, act="relu", parallel_mode="expert")
    y2, _ = tmoe.moe_apply(CTX, tp, x, top_k=K, act="relu", parallel_mode="tensor")
    assert torch.equal(y1, y2)
    with pytest.raises(ValueError, match="parallel_mode"):
        tmoe.moe_apply(CTX, tp, x, top_k=K, act="relu", parallel_mode="pipeline")


@pytest.mark.parametrize("act", ["silu_glu", "relu"])
def test_moe_init_from_a_key_draws_the_reference_init(act):
    want = jax_to_torch(j_moe_init(jax.random.PRNGKey(7), D, FF, E, act))
    got = tmoe.moe_init(prng_key(7), D, FF, E, act)
    for name, w, g in [("router", want["router"], got["router"])] + [
            (n, want["experts"][n], got["experts"][n]) for n in want["experts"]]:
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert float(((w - g).abs() / w.abs().clamp(min=1e-30)).max()) <= 3e-7, name
    assert sorted(got["experts"]) == sorted(want["experts"])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_mirror_reference(arch):
    """Full and reduced configs equal the reference's field for field
    (reduced MoE: 4 experts, top-2; enc-dec: enc_len 12)."""
    for t, j in ((get_config(arch), REGISTRY[arch]),
                 (t_reduce_config(get_config(arch)), reduce_config(REGISTRY[arch]))):
        assert t.__dict__.keys() == j.__dict__.keys()
        for k in t.__dict__:
            a, b = getattr(t, k), getattr(j, k)
            if k == "moe" and a is not None:
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, k)
    rc = t_reduce_config(get_config(arch))
    if rc.moe is not None:
        assert (rc.moe.num_experts, rc.moe.top_k) == (4, 2)
    if rc.enc_layers:
        assert rc.enc_len == 12
    assert arch in T_REGISTRY


SPECS = ["int4", "fp4", "nf4", "w8a8", "fp8e2e"]


@pytest.fixture(scope="module")
def raw_trees():
    return {arch: j_build_model(reduce_config(REGISTRY[arch])).init(jax.random.PRNGKey(0))
            for arch in ARCHS}


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_trees_byte_equal(raw_trees, arch, spec):
    """The quantized tree is the reference's byte for byte; the router
    stays unquantized; a 4-D expert stack's layer slice expands its own
    (double-quantized) scales to the reference layer's."""
    raw = raw_trees[arch]
    jtree = j_quantize_tree(raw, J_ALIASES[spec].policy())
    ttree = quantize_tree(jax_to_torch(raw), resolve_spec(spec).policy())
    tree_same_bytes(jtree, ttree)
    stacks = [t["layers"]["moe"] for t in (ttree.get("decoder", ttree),)
              if "moe" in t["layers"]]
    if stacks:
        jstack = (jtree.get("decoder", jtree))["layers"]["moe"]
        assert isinstance(stacks[0]["router"], torch.Tensor)
        for name, qt in stacks[0]["experts"].items():
            assert len(qt.shape) == 4
            layer = jax.tree_util.tree_map(lambda a: a[1], jstack["experts"][name])
            assert same_bytes(layer.block_scales(), qt.select(1).block_scales()), name


def test_families_still_unported_raise():
    """No family is left unported: olmoe-1b-7b inits from a key as the
    reference does (3e-7 relative, two f32 ulps) and its LM loss, the
    aux loss weighted by ``aux_loss_weight`` included, is the reference's
    within 1e-6 relative; the SSM and hybrid variants of its config init
    from a key and train (finite loss and gradients)."""
    from repro.train import compute_loss as j_compute_loss
    from repro_torch.configs.base import SSMCfg
    from repro_torch.train.steps import compute_loss
    from repro_torch.tree import leaves_with_path, map_like
    jm = j_build_model(reduce_config(REGISTRY["olmoe-1b-7b"]))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = t_reduce_config(get_config("olmoe-1b-7b"))
    model = build_model(cfg, "cpu")
    want = dict(leaves_with_path(jax_to_torch(jp)))
    got = dict(leaves_with_path(model.init(prng_key(0))))
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        assert float(((w - got[k]).abs() / w.abs().clamp(min=1e-30)).max()) <= 3e-7, k
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jmet = jax.jit(lambda p, t: j_compute_loss(JCTX, jm, p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    tl, tmet = compute_loss(CTX, model, jax_to_torch(jp), {"tokens": toks})
    assert float(jmet["aux_loss"]) > 0
    for name in ("loss", "aux_loss", "total_loss"):
        assert abs(float(tmet[name]) - float(jmet[name])) <= 1e-6 * float(jmet[name]), name
    for over in (dict(family="ssm", ssm=SSMCfg(state_dim=16, head_dim=16, chunk=8), moe=None),
                 dict(family="hybrid", moe=None, d_rec=64, local_window=8)):
        rec = build_model(dataclasses.replace(cfg, **over), "cpu")
        live = map_like(lambda p: p.requires_grad_(), rec.init(prng_key(0)))
        loss, _ = compute_loss(CTX, rec, live, {"tokens": toks}, remat=True)
        # (a hybrid of 2 layers has no super-block: its empty stacks get no
        # gradient)
        grads = torch.autograd.grad(loss, [v for _, v in leaves_with_path(live)],
                                    allow_unused=True)
        assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads
                                            if g is not None), over
