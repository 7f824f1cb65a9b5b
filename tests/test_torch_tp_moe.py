"""Expert parallelism (nllb600m-moe, olmoe-1b-7b, moonshot-v1-16b-a3b) and
the audio mesh (whisper-base) on gloo CPU ranks, against one device.

The MoE and audio families under ``deploy(mesh=tp_mesh(K))`` on spawned
ranks (``cluster.launch_ranks``), the reduced configs (4 experts, top-2,
4 heads) on the reference's key-0 weights, f32 compute, greedy:

* 2 ranks: nllb600m-moe and whisper-base int8, each paged at horizon 16
  and dense at horizon 1, equal to the JAX single-device engine's
  streams and finish reasons; olmoe-1b-7b int4 paged and dense equal to
  the port's single device. Each rank holds 2 of the 4 experts, its resident weight
  bytes under the whole tree's, and one prefill through a rank's local
  model is within 1e-5 of one device's largest logit. A paged
  nllb600m-moe engine on 2 slots over 8 pages preempts: its preemption
  counters and streams equal one device's on every rank.
* 4 ranks: olmoe-1b-7b (one expert a rank) and moonshot-v1-16b-a3b int4
  paged equal the port's single device; ``deploy_replicas("nllb600m-moe",
  "int8", replicas=2, tp=2, paged=True, horizon=16)`` equals the JAX
  single-device engine on every rank.

Without a spawn, ranks run in threads over an in-process sum
(``_Threads``): ``moe_apply`` on a rank's expert slice plus the gather
equals one device bit for bit at f32, with drops and dropless; with E not
divisible by tp the stacks replicate and no collective runs. The expert
stacks' shards round-trip after dequantization (int4, double-quantized
nf4).
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy  # noqa: E402
from torch_tp_ranks import (GREEDY, MOE_KW, lm_config, lm_prefill_logits,  # noqa: E402
                            lm_prompts, moe_grid, preempt_run)

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduce_config as j_reduce_config  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro_torch.cluster import launch_ranks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core import quantize_tree, resolve_spec  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.models import Ctx  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.parallel import TPGroup, param_specs, shard_tree  # noqa: E402
from repro_torch.parallel.tp import experts_per_rank, local_config  # noqa: E402
from repro_torch.serving import deploy  # noqa: E402

ARCHS = ("nllb600m-moe", "whisper-base", "olmoe-1b-7b", "moonshot-v1-16b-a3b")
# (arch, spec, paged, horizon, max_len)
JAX_CASES = [("nllb600m-moe", "int8", True, 16, 16), ("nllb600m-moe", "int8", False, 1, 16),
             ("whisper-base", "int8", True, 16, 16), ("whisper-base", "int8", False, 1, 16)]
PORT_TP2 = [("olmoe-1b-7b", "int4", True, 16, 32), ("olmoe-1b-7b", "int4", False, 1, 32)]
TP2 = JAX_CASES + PORT_TP2
TP4 = [("olmoe-1b-7b", "int4", True, 16, 32), ("moonshot-v1-16b-a3b", "int4", True, 16, 32)]
PORT_CASES = PORT_TP2 + TP4[1:]
STACK = ("int8", 2, 2)          # spec, replicas, tp
PREEMPT = (8, 16)               # pages, new tokens a request (6 requests, 2 slots)


def _case_id(c):
    return f"{c[0]}-{c[1]}-{'paged' if c[2] else 'dense'}-h{c[3]}"


def _batches(arch, n=3):
    """Numpy requests: sources and language codes (nllb600m-moe), frames and
    1-2 prompt tokens (whisper-base), 9-14 prompt tokens (the MoE LMs)."""
    cfg = lm_config(arch)
    rng = np.random.default_rng(4)
    if arch == "nllb600m-moe":
        return [{"src_tokens": rng.integers(16, cfg.vocab_size, (1, s)).astype(np.int32),
                 "tgt_in": np.full((1, 1), c, np.int32)}
                for s, c in zip([5, 12, 9, 7, 11, 6][:n], [8, 1, 7, 9, 3, 4])]
    if arch == "whisper-base":
        return [{"frames": (0.1 * rng.standard_normal((1, f, cfg.d_model))).astype(np.float32),
                 "tgt_in": rng.integers(0, cfg.vocab_size, (1, t)).astype(np.int32)}
                for f, t in zip([12, 7, 10][:n], [1, 2, 1])]
    return [{"tokens": rng.integers(0, cfg.vocab_size, (1, s)).astype(np.int32)}
            for s in [10, 14, 9][:n]]


def _preempt_batches():
    return _batches("nllb600m-moe", 6)


@pytest.fixture(scope="module")
def raw():
    """The reference's key-0 weights of every arch, numpy form."""
    return {arch: jax_tree_to_numpy(
        j_build_model(j_reduce_config(J_REGISTRY[arch])).init(jax.random.PRNGKey(0)))
        for arch in ARCHS}


@pytest.fixture(scope="module")
def ranks(raw, tmp_path_factory):
    """Both spawns: the tp2 grids and the preempting engine, then the tp4
    grids and the composed stack."""
    tmp = str(tmp_path_factory.mktemp("tp_moe"))
    batches = {arch: _batches(arch) for arch in ARCHS}
    nllb = raw["nllb600m-moe"]
    tp2 = launch_ranks(moe_grid, 2, device="cpu", tmpdir=tmp,
                       args=({a: raw[a] for a in ARCHS[:3]}, TP2, batches, None,
                             (nllb, _preempt_batches()) + PREEMPT))
    tp4 = launch_ranks(moe_grid, 4, device="cpu", tmpdir=tmp,
                       args=({a: raw[a] for a in ARCHS[2:]}, TP4, batches,
                             STACK + (nllb, batches["nllb600m-moe"]), None))
    return {2: tp2, 4: tp4}


@pytest.fixture(scope="module")
def single(raw):
    """The port's single-device grids of the int4 cases, the first tp2
    case's prefill logits and one device's preempting engine."""
    out = {}
    for arch, spec, paged, horizon, max_len in PORT_CASES + TP2[:1]:
        pipe = deploy(lm_config(arch), spec, params=from_numpy_tree(raw[arch], "cpu"),
                      device="cpu", paged=paged, horizon=horizon, max_len=max_len, **MOE_KW)
        prompts = lm_prompts(_batches(arch))
        if spec == "int4":
            out[arch, spec, paged, horizon] = [(o.token_ids, o.finish_reason)
                                               for o in pipe.generate(prompts, GREEDY)]
        else:
            out["logits"] = lm_prefill_logits(pipe, prompts[0], max_len)
            out["bytes"] = pipe.quantized_bytes
    out["preempt"] = preempt_run("cpu", None, raw["nllb600m-moe"], _preempt_batches(), *PREEMPT)
    return out


@pytest.fixture(scope="module")
def jax_grids(raw):
    """The JAX single-device engines' greedy grids of the int8 cases."""
    out = {}
    for arch, spec, paged, horizon, max_len in JAX_CASES:
        pipe = j_deploy(j_reduce_config(J_REGISTRY[arch]), spec,
                        params=jax.tree_util.tree_map(jnp.asarray, raw[arch]), paged=paged,
                        horizon=horizon, max_len=max_len, ctx=JCtx(compute_dtype=jnp.float32),
                        **{k: v for k, v in MOE_KW.items() if k != "ctx"})
        prompts = [{k: jnp.asarray(v) for k, v in b.items()} for b in _batches(arch)]
        out[arch, spec, paged, horizon] = [
            (list(o.token_ids), o.finish_reason)
            for o in pipe.generate(prompts, JSamplingParams(max_new_tokens=8))]
    return out


@pytest.mark.parametrize("case", JAX_CASES, ids=_case_id)
def test_tp2_streams_equal_jax_single_device(case, ranks, jax_grids):
    want = jax_grids[case[:4]]
    assert all(r == "length" for _, r in want)
    for rank in ranks[2]:
        assert rank["grids"][case[:4]] == want, case


@pytest.mark.parametrize("tp,case", [(2, c) for c in PORT_TP2] + [(4, c) for c in TP4],
                         ids=lambda c: c if isinstance(c, int) else _case_id(c))
def test_streams_equal_port_single_device(tp, case, ranks, single):
    """olmoe-1b-7b at tp2 (2 experts a rank; paged and dense) and tp4 (one
    a rank), moonshot-v1-16b-a3b at tp4: the port's single device's int4
    grid."""
    for rank in ranks[tp]:
        assert rank["grids"][case[:4]] == single[case[:4]], case


@pytest.mark.parametrize("tp", [2, 4])
def test_ranks_agree_and_hold_only_their_experts(tp, ranks):
    """Every rank serves the same grids; a rank keeps E / tp of the 4
    experts, H / tp heads and the whole d_ff (96), and its resident
    weight bytes are under the whole quantized tree's."""
    first = ranks[tp][0]
    for other in ranks[tp][1:]:
        assert other["grids"] == first["grids"]
    for rank in ranks[tp]:
        for arch, local in rank["local"].items():
            moe = lm_config(arch).moe
            assert local["heads"] == (4 // tp, 4 // tp, 96 if moe else 96 // tp), arch
            assert local["experts"] == (None if moe is None else 4 // tp), arch
            held, whole = local["bytes"]
            assert held < whole, (arch, held, whole)


def test_tp2_rank_local_prefill_logits_match_one_device(ranks, single):
    """nllb600m-moe int8 (the first case): the whole prefill's logits
    through each rank's own model and shard, experts and vocabulary
    gathered; the ranks agree bit for bit."""
    want = single["logits"]
    got = [rank["local"]["nllb600m-moe"]["logits"] for rank in ranks[2]]
    for g in got:
        assert g.shape == want.shape
        err = np.abs(g - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err
    assert np.array_equal(got[0], got[1])


def test_tp4_replica_stack_equals_jax_single_device(ranks, jax_grids):
    """deploy_replicas(replicas=2, tp=2) of nllb600m-moe on 4 ranks: every
    rank returns the JAX single-device engine's int8 paged horizon-16
    grid; ranks 0-1 serve replica 0, ranks 2-3 replica 1."""
    assert [r["stack"]["group"] for r in ranks[4]] == [0, 0, 1, 1]
    for rank in ranks[4]:
        assert rank["stack"]["grid"] == jax_grids[JAX_CASES[0][:4]]


def test_preemption_under_a_mesh_equals_single_device(ranks, single):
    """Six requests on 2 slots over a pool of 8 pages: the engine preempts
    and resumes, and every rank's counters and streams are one
    device's."""
    want = single["preempt"]
    assert want["preemptions"] > 0 and want["resumed"] > 0
    assert all(r == "length" and len(t) == PREEMPT[1] for t, r in want["grid"])
    for rank in ranks[2]:
        assert rank["preempt"] == want


# ---------------------------------------------------------------------------
# no spawn: ranks in threads, shards, refusals
# ---------------------------------------------------------------------------

class _Threads(TPGroup):
    """A tensor-parallel group of ranks that are threads of this process:
    the in-place f32 sum adds every rank's buffer behind a barrier; the
    shape of every sum is recorded."""

    def __init__(self, rank, size, shared):
        super().__init__(None, rank, size, "threads")
        self.shared = shared

    def _sum(self, y):
        parts, barrier = self.shared["parts"], self.shared["barrier"]
        self.shared["sums"].append((self.rank, tuple(y.shape)))
        parts[self.rank] = y.clone()
        barrier.wait()
        total = sum(parts[r] for r in range(self.size))
        barrier.wait()
        return y.copy_(total)


def _threads(tp, fn):
    """``fn(rank, group)`` on ``tp`` threads: (results by rank, the shapes
    summed)."""
    shared = {"parts": {}, "barrier": threading.Barrier(tp), "sums": []}
    out, errs = [None] * tp, []

    def run(r):
        try:
            out[r] = fn(r, _Threads(r, tp, shared))
        except BaseException as e:     # noqa: BLE001 - surfaced below
            errs.append(e)
            shared["barrier"].abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out, shared["sums"]


def _moe_params(E, act, spec=None, seed=3):
    """One layer's router and expert stacks (d 64, ff 96), quantized under
    ``spec`` when given."""
    g = torch.Generator().manual_seed(seed)
    p = moe_mod.moe_init(g, 64, 96, E, act, layers=2)
    if spec is not None:
        p = quantize_tree(p, resolve_spec(spec).policy())
    return p


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else
            (v.select(i) if isinstance(v, QTensor) else v[i]) for k, v in tree.items()}


@pytest.mark.parametrize("dropless,act", [(False, "silu_glu"), (True, "relu")],
                         ids=["capacity", "dropless"])
@pytest.mark.parametrize("tp", [2, 4])
def test_expert_slice_and_gather_equal_one_device_bitwise(tp, dropless, act):
    """moe_apply on rank r's experts [r E/tp, (r+1) E/tp) (the shard_tree
    slice), the outputs gathered along E: one device's (y, aux) bit for
    bit at f32. The capacity case drops assignments (capacity factor
    0.5); one gather a call, of (G, E/tp, C, d) a rank."""
    E, top_k = 4, 2
    params = _layer(_moe_params(E, act), 1)
    x = torch.randn((4, 6, 64), generator=torch.Generator().manual_seed(7))
    ctx = Ctx(compute_dtype=torch.float32)
    kw = dict(top_k=top_k, capacity_factor=0.5, act=act, dropless=dropless)
    want, aux = moe_mod.moe_apply(ctx, params, x, **kw)
    if not dropless:
        C = moe_mod.capacity(6, top_k, E, 0.5, False)
        _, _, e = moe_mod.route(params["router"], x.reshape(4, 6, 64), top_k)
        counts = torch.nn.functional.one_hot(e.reshape(4, -1), E).sum(1)
        assert bool((counts > C).any())            # some assignments drop
    specs = param_specs({"moe": params}, {"model": tp}, fsdp_scope="none")

    def rank_apply(r, group):
        shard = shard_tree({"moe": params}, specs, r, {"model": tp})["moe"]
        assert shard["experts"][next(iter(shard["experts"]))].shape[0] == E // tp
        return moe_mod.moe_apply(dataclasses.replace(ctx, tp=group), shard, x, **kw)

    got, sums = _threads(tp, rank_apply)
    G, C = 4, moe_mod.capacity(6, top_k, E, 0.5, dropless)
    assert sorted(sums) == [(r, (G, E, C, 64)) for r in range(tp)]
    for y, a in got:
        assert torch.equal(y, want) and torch.equal(a, aux)


def test_stacks_replicate_when_tp_does_not_divide_e():
    """6 experts at tp4: the reference's rule replicates the stacks, every
    rank runs every expert with no collective, and the result is one
    device's; the rank-local config keeps E and d_ff."""
    params = _layer(_moe_params(6, "silu_glu"), 0)
    specs = param_specs({"moe": params}, {"model": 4}, fsdp_scope="none")
    assert all(s == () or "model" not in s for s in specs.values())
    x = torch.randn((2, 5, 64), generator=torch.Generator().manual_seed(8))
    ctx = Ctx(compute_dtype=torch.float32)
    want, _ = moe_mod.moe_apply(ctx, params, x, top_k=2)

    def rank_apply(r, group):
        shard = shard_tree({"moe": params}, specs, r, {"model": 4})["moe"]
        return moe_mod.moe_apply(dataclasses.replace(ctx, tp=group), shard, x, top_k=2)[0]

    got, sums = _threads(4, rank_apply)
    assert sums == []
    for y in got:
        assert torch.equal(y, want)
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"),
                              moe=dataclasses.replace(get_config("olmoe-1b-7b").moe,
                                                      num_experts=6))
    lc = local_config(cfg, 4)
    assert (lc.num_heads, lc.d_ff, lc.moe.num_experts) == (4, 1024, 6)
    assert experts_per_rank(cfg, 4) == 6 and experts_per_rank(cfg, 3) == 2


@pytest.mark.parametrize("spec", ["int4", "nf4"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_tree_expert_stacks_round_trip(spec, tp):
    """Layer-stacked expert QTensors (L 2, E 4): rank r's shard holds
    experts [r E/tp, (r+1) E/tp) whole, codes sliced and scales with them
    (nf4's double-quantized scales decoded layer by layer first); the
    ranks' dequantized shards, concatenated along E, are the stack's
    layers dequantized one by one, as the model reads them (a whole
    double-quantized stack's ``block_scales()`` reads one flat run of
    chunks, right for its first layer only); the router replicates."""
    params = _moe_params(4, "silu_glu", spec)
    specs = param_specs({"moe": params}, {"model": tp}, fsdp_scope="none")
    shards = [shard_tree({"moe": params}, specs, r, {"model": tp})["moe"] for r in range(tp)]
    for name, qt in params["experts"].items():
        assert isinstance(qt, QTensor) and qt.fmt == spec
        assert (qt.scales is None) == (spec == "nf4")
        parts = [s["experts"][name] for s in shards]
        for p in parts:
            assert p.shape == (2, 4 // tp) + tuple(qt.shape[2:])
            assert p.scales is not None and p.scales.dtype == torch.float32
        got = torch.cat([p.dequantize(torch.float32) for p in parts], dim=1)
        whole = torch.stack([qt.select(i).dequantize(torch.float32) for i in range(2)])
        assert torch.equal(got, whole), name
    for s in shards:
        assert torch.equal(s["router"], params["router"])


def test_tp_group_gather_concatenates_in_rank_order():
    """TPGroup.gather along dims 0, 1 and -1: the ranks' slices in rank
    order, bf16 bits kept (the f32 sum has one nonzero term each)."""
    xs = [torch.randn((3, 2, 5), generator=torch.Generator().manual_seed(r)).to(torch.bfloat16)
          for r in range(3)]

    def rank_gather(r, group):
        return [group.gather(xs[r], d) for d in (0, 1, -1)]

    got, _ = _threads(3, rank_gather)
    for out in got:
        for y, d in zip(out, (0, 1, -1)):
            assert y.dtype == torch.bfloat16
            assert torch.equal(y, torch.cat(xs, dim=d))
