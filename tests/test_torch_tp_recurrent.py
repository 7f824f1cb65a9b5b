"""The SSM and hybrid meshes (mamba2-780m, recurrentgemma-9b) on gloo CPU
ranks, against one device.

Both recurrent families under ``deploy(mesh=tp_mesh(K))`` on spawned
ranks (``cluster.launch_ranks``), the reduced configs (mamba2: d 64, 8
SSD heads of 16, state 16; recurrentgemma: d_rec 64, 4 heads, one KV
head, window 8) on the reference's key-0 weights, f32 compute, dense, at
the engine shapes tests/test_torch_ssm.py and tests/test_torch_hybrid.py
serve them at (3 slots; mamba2 horizon 1, the longest the reference's
f32 SSM engine serves; recurrentgemma horizon 4, a 30-token prompt past
its window), greedy and seeded sampled grids (temperature 0.8, top-k 8,
seed 7):

* 2 ranks, int4: every rank's grids equal the JAX single-device
  engine's. A rank holds its SSD heads or RG-LRU channels only
  (``parallel.sharding`` layouts (e) and (f)) and fewer weight bytes than
  the whole tree; one prefill through a rank's local model is within
  1e-5 of one device's largest logit, the ranks equal bit for bit.
* 4 ranks: both archs int4 and nf4 equal the port's single device;
  ``deploy_replicas("mamba2-780m", "int4", replicas=2, tp=2)`` equals the
  JAX single-device engine on every rank.

Without a spawn, ranks run in threads over an in-process sum
(``_threads``): ``ssm_apply``, ``ssm_decode_step``, ``rglru_apply`` and
``rglru_decode_step`` on a rank's shard, with and without a carried
state, equal one device within 1e-5 at f32 (the split norm and the gates
sum in another order), their states the rank's slices of one device's;
the shards of layouts (e) and (f) put back together are the whole tree
(int4, double-quantized nf4).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy  # noqa: E402
from test_torch_tp_moe import _threads  # noqa: E402
from torch_tp_ranks import (REC_KW, lm_config, lm_grids, lm_prefill_logits,  # noqa: E402
                            lm_prompts, recurrent_grid)

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduce_config as j_reduce_config  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro_torch.cluster import launch_ranks  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core import quantize_tree, resolve_spec  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.models import Ctx  # noqa: E402
from repro_torch.models import rglru as rg  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.parallel import param_specs, shard_tree  # noqa: E402
from repro_torch.serving import deploy  # noqa: E402

SSM, HYBRID = "mamba2-780m", "recurrentgemma-9b"
ARCHS = (SSM, HYBRID)
LENS = {SSM: [5, 11, 14], HYBRID: [10, 30, 12]}
TP2 = [(SSM, "int4"), (HYBRID, "int4")]
TP4 = [(a, s) for a in ARCHS for s in ("int4", "nf4")]
STACK = (SSM, "int4", 2, 2)      # arch, spec, replicas, tp
CTX = Ctx(compute_dtype=torch.float32)
TOL = 1e-5


def _batches(arch):
    rng = np.random.default_rng(2)
    return [{"tokens": rng.integers(0, 256, (1, n)).astype(np.int32)} for n in LENS[arch]]


@pytest.fixture(scope="module")
def raw():
    """The reference's key-0 weights of both archs, numpy form."""
    return {arch: jax_tree_to_numpy(
        j_build_model(j_reduce_config(J_REGISTRY[arch])).init(jax.random.PRNGKey(0)))
        for arch in ARCHS}


@pytest.fixture(scope="module")
def ranks(raw, tmp_path_factory):
    """Both spawns: the tp2 int4 grids, then the tp4 grids and the
    composed stack."""
    tmp = str(tmp_path_factory.mktemp("tp_rec"))
    batches = {arch: _batches(arch) for arch in ARCHS}
    tp2 = launch_ranks(recurrent_grid, 2, device="cpu", tmpdir=tmp,
                       args=(raw, TP2, batches, None))
    tp4 = launch_ranks(recurrent_grid, 4, device="cpu", tmpdir=tmp,
                       args=(raw, TP4, batches, STACK))
    return {2: tp2, 4: tp4}


@pytest.fixture(scope="module")
def single(raw):
    """The port's single-device grids of every tp4 case, and the prefill
    logits and quantized bytes of each arch's int4 engine."""
    out = {}
    for arch, spec in TP4:
        pipe = deploy(lm_config(arch), spec, params=from_numpy_tree(raw[arch], "cpu"),
                      device="cpu", **REC_KW[arch])
        prompts = lm_prompts(_batches(arch))
        out[arch, spec] = lm_grids(pipe, prompts)
        if spec == "int4":
            out[arch, "logits"] = lm_prefill_logits(pipe, prompts[0], REC_KW[arch]["max_len"])
            out[arch, "bytes"] = pipe.quantized_bytes
    return out


@pytest.fixture(scope="module")
def jax_grids(raw):
    """The JAX single-device engines' int4 greedy and sampled grids."""
    out = {}
    for arch in ARCHS:
        kw = {k: v for k, v in REC_KW[arch].items() if k != "ctx"}
        pipe = j_deploy(j_reduce_config(J_REGISTRY[arch]), "int4",
                        params=jax.tree_util.tree_map(jnp.asarray, raw[arch]),
                        ctx=JCtx(compute_dtype=jnp.float32), **kw)
        prompts = [jnp.asarray(b["tokens"][0]) for b in _batches(arch)]
        out[arch] = tuple(
            [(list(o.token_ids), o.finish_reason) for o in pipe.generate(prompts, sp)]
            for sp in (JSamplingParams(max_new_tokens=8),
                       JSamplingParams(max_new_tokens=8, temperature=0.8, top_k=8, seed=7)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_streams_equal_jax_single_device(arch, ranks, jax_grids):
    want = jax_grids[arch]
    assert all(r == "length" for g in want for _, r in g)
    assert want[0] != want[1]           # the seeds matter
    for rank in ranks[2]:
        assert rank["grids"][arch, "int4"] == want, arch


@pytest.mark.parametrize("case", TP4, ids=lambda c: f"{c[0]}-{c[1]}")
def test_tp4_streams_equal_port_single_device(case, ranks, single):
    for rank in ranks[4]:
        assert rank["grids"][case] == single[case], case


@pytest.mark.parametrize("tp", [2, 4])
def test_ranks_agree_and_hold_their_heads_and_channels(tp, ranks, single):
    """Every rank serves the same grids. An SSM rank holds 8 / tp SSD heads:
    in_proj 2 x 128 / tp (z, x) + 2 x 16 (B, C) + 8 / tp (dt) columns and
    128 / tp + 32 conv channels; a hybrid rank 4 / tp heads, the one KV
    head, d_ff 96 / tp, d_rec 64 / tp and w_rg's (64, 64 / tp) columns.
    Its resident weight bytes are under the whole quantized tree's."""
    first = ranks[tp][0]
    for other in ranks[tp][1:]:
        assert other["grids"] == first["grids"]
    for rank in ranks[tp]:
        local = rank["local"]
        assert local[SSM]["widths"] == (8 // tp, 256 // tp + 32 + 8 // tp, 128 // tp + 32)
        assert local[HYBRID]["widths"] == (4 // tp, 1, 96 // tp, 64 // tp, (64, 64 // tp))
        for arch in ARCHS:
            held, whole = local[arch]["bytes"]
            assert held < whole == single[arch, "bytes"], (arch, held, whole)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_rank_local_prefill_logits_match_one_device(arch, ranks, single):
    """The whole prefill's logits through each rank's own model and shard
    (the split norm's and the gates' sums, the vocabulary gathered); the
    ranks agree bit for bit."""
    want = single[arch, "logits"]
    got = [rank["local"][arch]["logits"] for rank in ranks[2]]
    for g in got:
        assert g.shape == want.shape
        err = np.abs(g - want).max()
        assert err <= TOL * np.abs(want).max(), err
    assert np.array_equal(got[0], got[1])


def test_tp4_replica_stack_equals_jax_single_device(ranks, jax_grids):
    """deploy_replicas(replicas=2, tp=2) of mamba2-780m on 4 ranks: every
    rank returns the JAX single-device engine's int4 grids; ranks 0-1 serve
    replica 0, ranks 2-3 replica 1."""
    assert [r["stack"]["group"] for r in ranks[4]] == [0, 0, 1, 1]
    for rank in ranks[4]:
        assert rank["stack"]["grids"] == jax_grids[SSM]


# ---------------------------------------------------------------------------
# no spawn: ranks in threads, shards
# ---------------------------------------------------------------------------

def _ssm_params(spec=None, layers=None):
    cfg = lm_config(SSM)
    p = ssm_mod.ssm_init(torch.Generator().manual_seed(5), cfg.d_model, cfg.ssm, layers)
    p["conv_bias"] = 0.1 * torch.randn(p["conv_bias"].shape,
                                       generator=torch.Generator().manual_seed(6))
    return cfg, p if spec is None else quantize_tree(p, resolve_spec(spec).policy())


def _rglru_params(layers=None):
    lead = () if layers is None else (layers,)
    return rg.rglru_init(torch.Generator().manual_seed(5), 64, 64, lead)


def _rank_shard(tree, name, r, tp):
    specs = param_specs({name: tree}, {"model": tp}, fsdp_scope="none")
    return shard_tree({name: tree}, specs, r, {"model": tp}, recurrent=True)[name]


def _ssm_state_slice(state, r, tp, di=128):
    """Rank r's slice of a whole SSM (conv, SSD) state: its heads' x
    channels and all of B and C; its heads."""
    conv, h = state
    dl, hl = di // tp, h.shape[1] // tp
    return (torch.cat([conv[..., r * dl:(r + 1) * dl], conv[..., di:]], dim=-1),
            h[:, r * hl:(r + 1) * hl])


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= TOL * max(float(want.abs().max()), 1.0), err


@pytest.mark.parametrize("carried", [False, True], ids=["zero-state", "carried-state"])
@pytest.mark.parametrize("tp", [2, 4])
def test_ssm_on_a_shard_equals_one_device(tp, carried):
    """ssm_apply (prefill, 11 tokens, from a zero or carried conv state)
    and ssm_decode_step (from the prefill's states or zeros) on rank r's
    heads: one device's outputs within 1e-5, the returned states the
    rank's slices of one device's. A call sums twice over the ranks: the
    norm's (B, S, 1) sums of squares and out_proj's (B, S, d)."""
    cfg, p = _ssm_params()
    kw = dict(d_model=cfg.d_model, ssm_cfg=cfg.ssm)
    g = torch.Generator().manual_seed(7)
    x, x1 = torch.randn((2, 11, 64), generator=g), torch.randn((2, 1, 64), generator=g)
    zero = ssm_mod.ssm_init_state(2, cfg.d_model, cfg.ssm, "cpu")
    conv0 = torch.randn(zero[0].shape, generator=g).to(torch.bfloat16) if carried else None
    want, st = ssm_mod.ssm_apply(CTX, p, x, conv_state=conv0, return_state=True, **kw)
    state = st if carried else zero
    want1, st1 = ssm_mod.ssm_decode_step(CTX, p, x1, state, **kw)

    def rank_run(r, group):
        ctx, shard = dataclasses.replace(CTX, tp=group), _rank_shard(p, "ssm", r, tp)
        c0 = None if conv0 is None else _ssm_state_slice((conv0, zero[1]), r, tp)[0]
        y, s = ssm_mod.ssm_apply(ctx, shard, x, conv_state=c0, return_state=True, **kw)
        y1, s1 = ssm_mod.ssm_decode_step(ctx, shard, x1, _ssm_state_slice(state, r, tp), **kw)
        return y, s, y1, s1

    got, sums = _threads(tp, rank_run)
    assert sorted(sums) == sorted((r, shape) for r in range(tp)
                                  for shape in ((2, 11, 1), (2, 11, 64), (2, 1, 1), (2, 1, 64)))
    for r, (y, s, y1, s1) in enumerate(got):
        _close(y, want)
        _close(y1, want1)
        for a, b in zip(s + s1, _ssm_state_slice(st, r, tp) + _ssm_state_slice(st1, r, tp)):
            _close(a.to(torch.float32), b.to(torch.float32))


@pytest.mark.parametrize("carried", [False, True], ids=["zero-state", "carried-state"])
@pytest.mark.parametrize("tp", [2, 4])
def test_rglru_on_a_shard_equals_one_device(tp, carried):
    """rglru_apply (11 tokens, from no state or a carried (conv, h)) and
    rglru_decode_step on rank r's 64 / tp channels: one device's within
    1e-5, the states the rank's channels of one device's. A call gathers
    the conv output along channels before the gates and sums out_proj:
    two (B, S, 64) sums."""
    p = _rglru_params()
    g = torch.Generator().manual_seed(8)
    x, x1 = torch.randn((2, 11, 64), generator=g), torch.randn((2, 1, 64), generator=g)
    st0 = ((torch.randn((2, 3, 64), generator=g).to(torch.bfloat16),
            torch.randn((2, 64), generator=g)) if carried else None)
    want, st = rg.rglru_apply(CTX, p, x, st0, return_state=True)
    state = st if carried else rg.rglru_init_state(2, 64, "cpu")
    want1, st1 = rg.rglru_decode_step(CTX, p, x1, state)

    def channels(s, r):
        n = 64 // tp
        return None if s is None else tuple(t[..., r * n:(r + 1) * n] for t in s)

    def rank_run(r, group):
        ctx, shard = dataclasses.replace(CTX, tp=group), _rank_shard(p, "rglru", r, tp)
        y, s = rg.rglru_apply(ctx, shard, x, channels(st0, r), return_state=True)
        y1, s1 = rg.rglru_decode_step(ctx, shard, x1, channels(state, r))
        return y, s, y1, s1

    got, sums = _threads(tp, rank_run)
    assert sorted(sums) == sorted((r, shape) for r in range(tp)
                                  for shape in ((2, 11, 64),) * 2 + ((2, 1, 64),) * 2)
    for r, (y, s, y1, s1) in enumerate(got):
        _close(y, want)
        _close(y1, want1)
        for a, b in zip(s + s1, channels(st, r) + channels(st1, r)):
            _close(a.to(torch.float32), b.to(torch.float32))


def _deq(t):
    """A leaf dequantized layer by layer (a stacked double-quantized
    QTensor's scales decode per layer), or the leaf itself."""
    if not isinstance(t, QTensor):
        return t
    return torch.stack([t.select(i).dequantize(torch.float32) for i in range(t.data.shape[0])])


@pytest.mark.parametrize("spec", ["int4", "nf4"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_tree_recurrent_layouts_round_trip(spec, tp):
    """Layer-stacked (L 2) SSM and RG-LRU param dicts: rank r's leaves are
    contiguous copies that own their storage; put back together (an SSM
    in_proj's z, x and dt pieces concatenated and B, C equal on every rank;
    conv channels likewise; heads, d_inner columns, channels and out_proj
    rows concatenated) they are the whole tree, dequantized."""
    _, p = _ssm_params(spec, layers=2)
    di, ds, nh = 128, 16, 8
    dl, hl = di // tp, nh // tp
    assert isinstance(p["in_proj"], QTensor) and p["in_proj"].fmt == spec
    shards = [_rank_shard(p, "ssm", r, tp) for r in range(tp)]
    for s in shards:
        for leaf in s.values():
            for t in (leaf.data, leaf.scales) if isinstance(leaf, QTensor) else (leaf,):
                assert t.is_contiguous() and t.untyped_storage().nbytes() == t.nbytes
    parts = [_deq(s["in_proj"]) for s in shards]
    assert parts[0].shape == (2, 64, 2 * dl + 2 * ds + hl)
    for q in parts[1:]:
        assert torch.equal(q[..., 2 * dl:2 * dl + 2 * ds], parts[0][..., 2 * dl:2 * dl + 2 * ds])
    got = torch.cat([torch.cat([q[..., :dl] for q in parts], -1),
                     torch.cat([q[..., dl:2 * dl] for q in parts], -1),
                     parts[0][..., 2 * dl:2 * dl + 2 * ds],
                     torch.cat([q[..., -hl:] for q in parts], -1)], -1)
    assert torch.equal(got, _deq(p["in_proj"]))
    for name in ("conv_w", "conv_bias"):
        qs = [s[name] for s in shards]
        assert all(torch.equal(q[..., dl:], qs[0][..., dl:]) for q in qs)
        assert torch.equal(torch.cat([q[..., :dl] for q in qs] + [qs[0][..., dl:]], -1), p[name])
    for name in ("a_log", "dt_bias", "D", "norm_scale"):
        assert torch.equal(torch.cat([s[name] for s in shards], -1), p[name])
    assert torch.equal(torch.cat([_deq(s["out_proj"]) for s in shards], -2),
                       _deq(p["out_proj"]))
    q = quantize_tree({"rglru": _rglru_params(layers=2)}, resolve_spec(spec).policy())["rglru"]
    shards = [_rank_shard(q, "rglru", r, tp) for r in range(tp)]
    for name, t in q.items():
        assert not isinstance(t, QTensor)       # the policy exempts the RG-LRU
        dim = -2 if name == "out_proj" else -1
        assert shards[0][name].shape[dim] == 64 // tp
        assert torch.equal(torch.cat([s[name] for s in shards], dim), t), name
