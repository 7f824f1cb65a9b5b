"""The quantization arms under a mesh, on gloo CPU ranks, against one device.

Every arm one device serves, under ``deploy(mesh=tp_mesh(K))`` on spawned
ranks (``cluster.launch_ranks``): the reduced nllb600m on the reference's
key-0 weights, f32 compute, the reference TP test's sources and engine
shape (2 slots, 16 positions, pages of 4), greedy and seeded sampled
grids (temperature 0.8, top-k 8, seed 7), with their finish reasons:

* ``w8a8`` calibrated (paged, horizon 16), ``fp8e2e`` dynamic (paged,
  horizon 4), ``w4a8kv8x8`` calibrated (dense: the x<fmt> attention slot
  reaches the dense and gather routes only), int4 with rank-16 QLoRA
  adapters, B non-zero (paged, horizon 4), and int4 with a calibrated
  ``w4a8kv8`` draft arm (paged, horizon 4);
* tp2 ("torch" bundle): every rank's grids equal the JAX single-device
  engine's (its "xla" bundle, fp8 casts rounded once,
  ``test_torch_bridge.exact_fp8_reference``), which calibrates on the
  same batches;
* tp4 ("kernels" bundle, the plain versions here): equal the port's
  single device; ``deploy_replicas("nllb600m", "w8a8", replicas=2,
  tp=2, calib_batches=...)`` equals the JAX single-device engine;
* tp2: gemma3-1b ``w8a8`` calibrated (paged) and mamba2-780m ``fp8e2e``
  (dense; its unlabelled ``out_proj`` is row-parallel) equal the port's
  single device;
* every rank holds the same calibrated site tables (target and draft)
  and the same acceptance counters; the tables are one device's within
  f32 rounding (the row-parallel sums reorder each activation's sum).

Without a spawn, ranks run in threads over in-process sums and maxima
(``_threads``): ``Ctx.dot`` at a ``.out`` site quantizes the rank's K
slice to one device's int8 / fp8 codes on one device's per-token scales,
exactly, with one max and one sum over the ranks; and calibration on the
shards of a block whose every observation precedes a sum gives one
device's site table exactly, the same on every rank.
"""

import dataclasses
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import exact_fp8_reference, jax_to_torch  # noqa: E402
from test_torch_tp_moe import _Threads  # noqa: E402
from torch_tp_ranks import (CTX, grids, lm_config, lm_grids, lm_prompts,  # noqa: E402
                            quant_deploy, quant_facts, quant_grid)

import repro_torch.core.qlinear as tql  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduce_config as j_reduce_config  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core import resolve_spec as j_resolve  # noqa: E402
from repro.core.qlora import attach_lora as j_attach_lora  # noqa: E402
from repro.core.qlora import extract_adapters as j_extract  # noqa: E402
from repro.core.qlora import inject_adapters as j_inject  # noqa: E402
from repro.data import SyntheticTranslation  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro_torch.cluster import launch_ranks  # noqa: E402
from repro_torch.core import calibrate_act_scales, quantize_tree, resolve_spec  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.parallel import param_specs, shard_tree  # noqa: E402
from repro_torch.random import prng_key  # noqa: E402

SHAPE = dict(slots=2, max_len=16, page_size=4)
# name -> (spec, tree, engine shape); tp2 serves the "torch" bundle, tp4 the "kernels" one
ARMS = {
    "w8a8": ("w8a8", "raw", dict(paged=True, horizon=16, calibrate=True)),
    "fp8e2e": ("fp8e2e", "raw", dict(paged=True, horizon=4)),
    "w4a8kv8x8": ("w4a8kv8x8", "raw", dict(paged=False, horizon=4, calibrate=True)),
    "qlora": ("int4", "adapted", dict(paged=True, horizon=4)),
    "draft": ("int4", "raw", dict(paged=True, horizon=4, calibrate=True,
                                  draft_spec="w4a8kv8")),
}
CALIBRATED = ("w8a8", "w4a8kv8x8", "draft")
GEMMA, SSM = "gemma3-1b", "mamba2-780m"
LM_ARMS = {GEMMA: ("w8a8", dict(slots=2, max_len=32, page_size=4, paged=True, horizon=4,
                                calibrate=True)),
           SSM: ("fp8e2e", dict(slots=3, max_len=32, horizon=1))}
STACK = ("w8a8", 2, 2, dict(paged=True, horizon=16, bundle="torch"))
GREEDY = JSamplingParams(max_new_tokens=8)
SAMPLED = JSamplingParams(max_new_tokens=8, temperature=0.8, top_k=8, seed=7)


def _cases(bundle):
    return [(name, spec, tree, dict(SHAPE, bundle=bundle, **kw))
            for name, (spec, tree, kw) in ARMS.items()]


def _src():
    cfg = j_reduce_config(J_REGISTRY["nllb600m"])
    ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=0,
                              languages=("hin", "eng", "ita"))
    return np.asarray(ds.sample(3)["src_tokens"])


def _calib():
    """Two calibration batches of 4 rows (the reference's data)."""
    cfg = j_reduce_config(J_REGISTRY["nllb600m"])
    ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=0)
    return [{k: np.asarray(v) for k, v in ds.sample(4).items() if not isinstance(v, str)}
            for _ in range(2)]


def _lm_inputs(arch):
    """An LM arm's (prompts, calibration batches): three prompts of 5-11
    tokens and two batches of 2 x 12 tokens."""
    rng = np.random.default_rng(4)
    prompts = [{"tokens": rng.integers(0, 256, (1, n)).astype(np.int32)} for n in (5, 11, 8)]
    calib = [{"tokens": rng.integers(0, 256, (2, 12)).astype(np.int32)} for _ in range(2)]
    return prompts, calib


@pytest.fixture(scope="module")
def raw():
    return j_build_model(j_reduce_config(J_REGISTRY["nllb600m"])).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def adapted(raw):
    """int4 params with rank-16 JAX adapters on every matmul, B non-zero:
    (JAX tree, torch tree)."""
    qj = j_quantize_tree(raw, j_resolve("int4").policy())
    qj = j_attach_lora(qj, jax.random.PRNGKey(1), rank=16)
    rng = np.random.default_rng(1)

    def fill(node):
        if isinstance(node, dict) and set(node) == {"a", "b"}:
            return {"a": node["a"],
                    "b": jnp.asarray(rng.standard_normal(node["b"].shape) * 0.05, jnp.float32)}
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return node
    qj = j_inject(qj, fill(j_extract(qj)))
    return qj, jax_to_torch(qj)


@pytest.fixture(scope="module")
def lm_raw():
    """The LM arms' key-0 weights, drawn by the port (its key init is the
    reference's, tests/test_torch_lm.py)."""
    return {arch: build_model(lm_config(arch), "cpu").init(prng_key(0)) for arch in LM_ARMS}


def _lm_cases(lm_raw):
    return [(arch, spec, kw, lm_raw[arch], *_lm_inputs(arch))
            for arch, (spec, kw) in LM_ARMS.items()]


@pytest.fixture(scope="module")
def trees(raw, adapted):
    return {"raw": jax_to_torch(raw), "adapted": adapted[1]}


@pytest.fixture(scope="module")
def ranks(trees, lm_raw, tmp_path_factory):
    """Both spawns: tp2 over the arms ("torch" bundle) and the LM arms,
    tp4 over the arms ("kernels" bundle) and the composed stack."""
    tmp = str(tmp_path_factory.mktemp("tp_quant"))
    src, calib = _src(), _calib()
    tp2 = launch_ranks(quant_grid, 2, device="cpu", tmpdir=tmp,
                       args=(trees, _cases("torch"), src, calib, _lm_cases(lm_raw), None))
    tp4 = launch_ranks(quant_grid, 4, device="cpu", tmpdir=tmp,
                       args=(trees, _cases("kernels"), src, calib, [], STACK))
    return {2: tp2, 4: tp4}


@pytest.fixture(scope="module")
def single(trees, lm_raw):
    """The port's single-device grids and facts of the tp4 arms and the LM
    arms."""
    out = {}
    for name, spec, tree, kw in _cases("kernels"):
        pipe = quant_deploy("nllb600m", spec, trees[tree], _calib(), kw, smoke=True,
                            device="cpu")
        out[name] = (grids(pipe, _src()), quant_facts(pipe))
    for arch, spec, kw, params, prompts, calib in _lm_cases(lm_raw):
        pipe = quant_deploy(lm_config(arch), spec, params, calib, kw, device="cpu")
        out[arch] = (lm_grids(pipe, lm_prompts(prompts)), quant_facts(pipe))
    return out


@pytest.fixture(scope="module")
def jax_grids(raw, adapted):
    """The JAX single-device engines' grids and tables of every arm,
    calibrated on the same batches, fp8 casts rounded once: dense engines
    at horizon 1, the quickest to build (the reference's own invariant
    makes every layout and horizon serve these streams)."""
    src, out = jnp.asarray(_src()), {}
    cal = [{k: jnp.asarray(v) for k, v in b.items()} for b in _calib()]
    with exact_fp8_reference(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, (spec, tree, kw) in ARMS.items():
            kw = dict(SHAPE, **dict(kw, paged=False, horizon=1))
            calibrate = kw.pop("calibrate", False)
            pipe = j_deploy("nllb600m", spec, smoke=True, ctx=JCtx(compute_dtype=jnp.float32),
                            params=raw if tree == "raw" else adapted[0],
                            calib_batches=cal if calibrate else None, **kw)
            out[name] = tuple([(list(o.token_ids), o.finish_reason)
                               for o in pipe.translate(src, lang, sp)]
                              for lang, sp in (("ita", GREEDY), ("hin", SAMPLED)))
            draft = pipe.engine.draft
            out[name, "facts"] = {"table": pipe.ctx.act_scales,
                                  "draft_table": draft and draft.ctx.act_scales}
    return out


@pytest.mark.parametrize("arm", list(ARMS))
def test_tp2_streams_equal_jax_single_device(arm, ranks, jax_grids):
    want = jax_grids[arm]
    assert all(r == "length" for g in want for _, r in g)
    assert want[0] != want[1]           # the seeds matter
    for rank in ranks[2]:
        assert rank["grids"][arm] == want, arm


@pytest.mark.parametrize("arm", list(ARMS))
def test_tp4_streams_equal_port_single_device(arm, ranks, single):
    for rank in ranks[4]:
        assert rank["grids"][arm] == single[arm][0], arm


@pytest.mark.parametrize("arch", list(LM_ARMS))
def test_tp2_lm_arms_equal_port_single_device(arch, ranks, single):
    """gemma3-1b w8a8 calibrated, paged; mamba2-780m fp8e2e, dense (its
    out_proj's dynamic scale is the ranks' absmax)."""
    want = single[arch][0]
    assert want[0] != want[1]
    for rank in ranks[2]:
        assert rank["grids"][arch] == want, arch


def _close_tables(got, want, rel=1e-5):
    """Two site tables: the same sites, each scale within ``rel`` of the
    other's (f32 rounding of the sums' order)."""
    assert [s for s, _ in got] == [s for s, _ in want]
    for (site, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=rel), site


@pytest.mark.parametrize("tp", [2, 4])
def test_ranks_hold_one_table_and_counters(tp, ranks, single, jax_grids):
    """Every rank holds the same calibrated site tables (target and draft)
    and the same acceptance counters; the tables are one device's sites,
    each scale within 1e-5 of one device's of the same routes (at tp2 the
    JAX engine's, whose dequantized products are the "torch" bundle's; at
    tp4 the port's "kernels" bundle, whose qmm rounds its inputs to
    bf16); a draft arm accepted some drafted tokens. w4a8kv8x8 calibrates
    with its attention operands quantized dynamically (the x<fmt> slot),
    so an operand's code that the reordered sums move across a rounding
    boundary moves the absmax after it by a fraction of a code step (1e-3
    of the scale)."""
    first = ranks[tp][0]
    for other in ranks[tp][1:]:
        assert other["facts"] == first["facts"]
        assert other["grids"] == first["grids"]
    for name in ARMS:
        facts = first["facts"][name]
        want = jax_grids[name, "facts"] if tp == 2 else single[name][1]
        assert bool(facts["table"]) == (name in CALIBRATED and name != "draft")
        if facts["table"]:
            _close_tables(facts["table"], want["table"], 1e-3 if "x" in name else 1e-5)
        if name == "draft":
            _close_tables(facts["draft_table"], want["draft_table"])
            drafted, accepted, rounds = facts["accept"]
            assert drafted > 0 and rounds > 0 and 0 < accepted <= drafted
    if tp == 2:
        _close_tables(first["facts"][GEMMA]["table"], single[GEMMA][1]["table"])
        assert first["facts"][SSM]["table"] is None


def test_tp4_replica_stack_equals_jax_single_device(ranks, jax_grids):
    """deploy_replicas("nllb600m", "w8a8", replicas=2, tp=2,
    calib_batches=...) on 4 ranks: every rank returns the JAX
    single-device engine's grids; each replica's ranks calibrated one
    table."""
    assert [r["stack"]["group"] for r in ranks[4]] == [0, 0, 1, 1]
    for rank in ranks[4]:
        assert rank["stack"]["grids"] == jax_grids["w8a8"]
        assert rank["stack"]["table"] == ranks[4][0]["stack"]["table"]


# ---------------------------------------------------------------------------
# no spawn: ranks in threads
# ---------------------------------------------------------------------------

class _MaxThreads(_Threads):
    """``_Threads`` with the elementwise max over the ranks; every max's
    shape is recorded."""

    def _max(self, y):
        parts, barrier = self.shared["parts"], self.shared["barrier"]
        self.shared.setdefault("maxes", []).append((self.rank, tuple(y.shape)))
        parts[self.rank] = y.clone()
        barrier.wait()
        total = torch.stack([parts[r] for r in range(self.size)]).amax(dim=0)
        barrier.wait()
        return y.copy_(total)


def _threads(tp, fn):
    """``fn(rank, group)`` on ``tp`` threads: (results by rank, the shared
    record of sums and maxima)."""
    shared = {"parts": {}, "barrier": threading.Barrier(tp), "sums": [], "maxes": []}
    out, errs = [None] * tp, []

    def run(r):
        try:
            out[r] = fn(r, _MaxThreads(r, tp, shared))
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
    return out, shared


@pytest.mark.parametrize("spec", ["w8a8", "fp8e2e", "w4a8kv8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_row_parallel_dot_quantizes_as_one_device(tp, spec, monkeypatch):
    """``Ctx.dot`` at an ".out" site, dynamic scales (5 rows, K 256, N 48,
    two rows with an outlier, one zero row): rank r's activation codes are
    one device's codes of its K slice and its per-token scales one
    device's, exactly (the int8 route's and the fake-quant route's); a
    call takes one max of the (5, 1) absmax and one sum of the (5, 48)
    product over the ranks; the sum is one device's product within 1e-5,
    and w8a8's, whose int32 products are summed before the rescale, bit
    for bit."""
    s = resolve_spec(spec)
    g = torch.Generator().manual_seed(11)
    w = quantize_tree({"w_out": torch.randn((256, 48), generator=g) * 0.1},
                      s.policy())["w_out"]
    x = torch.randn((5, 256), generator=g)
    x[1, 100] = 40.0
    x[3, 7] = -25.0
    x[4] = 0.0
    ctx = dataclasses.replace(CTX, act_fmt=s.act)
    seen = {}
    real = tql.quantize_activations
    local = threading.local()

    def spy(xs, fmt="int8", scale=None):
        codes, sc = real(xs, fmt, scale)
        seen.setdefault(getattr(local, "rank", None), []).append((codes, sc))
        return codes, sc

    monkeypatch.setattr(tql, "quantize_activations", spy)
    want = ctx.dot(x, w, site="dec.ffn.out")
    (codes, scale), = seen.pop(None)
    k = 256 // tp

    def rank_run(r, group):
        local.rank = r
        shard = shard_tree({"w_out": w}, param_specs({"w_out": w}, {"model": tp},
                                                      fsdp_scope="none"),
                           r, {"model": tp})["w_out"]
        return dataclasses.replace(ctx, tp=group).dot(x[:, r * k:(r + 1) * k], shard,
                                                      site="dec.ffn.out")

    got, shared = _threads(tp, rank_run)
    assert sorted(shared["maxes"]) == [(r, (5, 1)) for r in range(tp)]
    assert sorted(shared["sums"]) == [(r, (5, 48)) for r in range(tp)]
    for r, y in enumerate(got):
        (rc, rs), = seen[r]
        assert torch.equal(rc.view(torch.uint8), codes[:, r * k:(r + 1) * k].view(torch.uint8))
        assert torch.equal(rs, scale)
        err = float((y - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err
        assert torch.equal(y, want) or spec != "w8a8"


class _Block:
    """A parallel block as a "model": attention with the x<fmt> slot and an
    FFN on the same normed input, summed into the residual. Every
    activation is observed before a sum over the ranks, so a rank's
    observations are one device's slices, bit for bit."""

    def __init__(self, heads, kv_heads):
        self.heads, self.kv_heads = heads, kv_heads

    def forward(self, ctx, params, batch):
        x = batch["x"]
        pos = torch.arange(x.shape[1]).expand(x.shape[0], -1)
        a, _ = layers.attn_apply(ctx, params["attn"], x, pos, num_heads=self.heads,
                                 num_kv_heads=self.kv_heads, head_dim=16)
        return x + a + layers.mlp(ctx, params["mlp"], x, "relu")


@pytest.mark.parametrize("tp", [2, 4])
def test_calibration_on_shards_gives_one_device_table(tp):
    """``calibrate_act_scales`` (w8a8kv8x8's int8 activations and int8
    attention operands) of a parallel block (d 64, 4 heads of 16, 2 KV
    heads, d_ff 96) on two batches: on each rank's shard (its heads, its
    FFN columns, tp / 2 copies of a KV head at tp4) the merged table is
    one device's, exactly (the row-parallel inputs "attn.out" and
    "ffn.out" and the per-head "attn.qk.a/b" and "attn.pv.a/b" are seen in
    slices), equal on every rank, after one max over the sorted table."""
    g = torch.Generator().manual_seed(12)
    cfg = dataclasses.replace(lm_config("nllb600m"), d_model=64, num_heads=4,
                              num_kv_heads=2, head_dim=16, d_ff=96)
    params = {"attn": layers.attention_init(g, None, cfg, extras=False),
              "mlp": {"w_in": torch.randn((64, 96), generator=g) * 0.1,
                      "w_out": torch.randn((96, 64), generator=g) * 0.1}}
    params = quantize_tree(params, resolve_spec("w8a8kv8x8").policy())
    batches = [{"x": torch.randn((2, 7, 64), generator=g)} for _ in range(2)]
    ctx = dataclasses.replace(CTX, act_fmt="int8", attn_act_fmt="int8")
    want = calibrate_act_scales(_Block(4, 2), params, ctx, batches)
    specs = param_specs(params, {"model": tp}, fsdp_scope="none")
    reps = tp // 2 if tp > 2 else 1

    def rank_run(r, group):
        shard = shard_tree(params, specs, r, {"model": tp}, kv_replicas=reps)
        return calibrate_act_scales(_Block(4 // tp, max(2 // tp, 1)), shard,
                                    dataclasses.replace(ctx, tp=group), batches)

    got, shared = _threads(tp, rank_run)
    assert {"attn.out", "ffn.out", "attn.qk.a", "attn.pv.b"} <= set(want)
    assert sorted(shared["maxes"]) == [(r, (len(want),)) for r in range(tp)]
    for table in got:
        assert table == want
