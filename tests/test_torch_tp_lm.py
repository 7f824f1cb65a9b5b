"""Tensor-parallel decoder-only LMs and the composed dp x tp stack on gloo
CPU ranks, against one device.

The dense and VLM families under ``deploy(mesh=tp_mesh(K))`` on spawned
ranks (``cluster.launch_ranks``), the reduced configs on the reference's
key-0 weights, f32 compute, greedy and seeded sampled grids (temperature
0.8, top-k 8, seed 7):

* 2 ranks: gemma3-1b (one KV head, so each rank keeps a copy of it:
  ``parallel.sharding`` layout (d)) int4 paged at horizon 16 and int8
  dense at horizon 1; qwen2.5-14b with two KV heads (one a rank, QKV
  biases, an untied head) int4 paged at horizon 16; llava-next-mistral-7b
  int4 dense with image rows. Every rank's streams and finish reasons
  equal each other's and the port's single-device engine's; gemma3's
  int8 dense grid also equals the JAX single-device engine's. One
  prefill through a rank's local model is within 1e-5 of the single
  device's largest logit.
* 4 ranks: gemma3-1b at tp4 (one query head a rank) int4 paged at
  horizon 16, equal to the port's single device; then the reference's
  composed case, ``deploy_replicas("nllb600m", "int8", replicas=2, tp=2,
  paged=True, horizon=16)`` (the counterpart of the reference's
  ``test_replica_router_streams_match_single_device`` at its (2, 2)
  stack): its grids equal the JAX single-device engine's on every rank,
  its merged metrics are the per-replica sums, and its placements are
  those of the tp=1 router over two single-device engines.

Without a spawn, two ranks run in threads over an in-process all-reduce
(``_ThreadGroup``): a rank's ``_embed`` of a vocabulary-split table
equals one device's rows (embed scale, image rows), and a prefill under
a mesh gathers only the rows the engine reads; ``shard_tree``'s layout
(d) and the refusals of what stays in slice 6 (and the families that now
pass, the SSM and hybrid ones too: tests/test_torch_tp_recurrent.py) need
no ranks at all.

One spawn of 2 ranks and one of 4 serve every grid.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy  # noqa: E402
from torch_tp_ranks import (CTX, GREEDY, LM_KW, common,  # noqa: E402
                            lm_config, lm_grid, lm_grids, lm_prefill_logits, lm_prompts)

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduce_config as j_reduce_config  # noqa: E402
from repro.data import SyntheticTranslation  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro_torch.cluster import deploy_replicas, launch_ranks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core import quantize_tree, resolve_spec  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.parallel import TPGroup, param_specs, shard_tree  # noqa: E402
from repro_torch.models.layers import seq_rows  # noqa: E402
from repro_torch.parallel.tp import kv_replicas, local_config, refuse_under_mesh  # noqa: E402
from repro_torch.serving import deploy  # noqa: E402

KV = {"gemma3-1b": None, "qwen2.5-14b": 2, "llava-next-mistral-7b": None}
LENS = [10, 14, 9]             # past gemma3's local window of 8
TP2 = [("gemma3-1b", None, "int4", True, 16), ("gemma3-1b", None, "int8", False, 1),
       ("qwen2.5-14b", 2, "int4", True, 16), ("llava-next-mistral-7b", None, "int4", False, 1)]
TP4 = [("gemma3-1b", None, "int4", True, 16)]
STACK = ("int8", 2, 2)           # spec, replicas, tp


def _case_id(c):
    return f"{c[0]}-{c[2]}-{'paged' if c[3] else 'dense'}-h{c[4]}"


def _j_config(arch):
    cfg = j_reduce_config(J_REGISTRY[arch])
    kv = KV.get(arch)
    return cfg if kv is None else dataclasses.replace(cfg, num_kv_heads=kv)


def _batches(arch):
    """Numpy prompts ({"tokens" (1, n)}, a VLM's with its image rows)."""
    cfg = lm_config(arch, KV[arch])
    rng = np.random.default_rng(1)
    out = [{"tokens": rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)} for n in LENS]
    if cfg.family == "vlm":
        for b in out:
            b["img_embeds"] = (0.1 * rng.standard_normal((1, cfg.num_patches, cfg.d_model))
                               ).astype(np.float32)
    return out


def _src():
    cfg = j_reduce_config(J_REGISTRY["nllb600m"])
    ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=0,
                              languages=("hin", "eng", "ita"))
    return np.asarray(ds.sample(3)["src_tokens"])


@pytest.fixture(scope="module")
def raw():
    """The reference's key-0 weights of every arch, numpy form."""
    return {arch: jax_tree_to_numpy(j_build_model(_j_config(arch)).init(jax.random.PRNGKey(0)))
            for arch in (*KV, "nllb600m")}


@pytest.fixture(scope="module")
def ranks(raw, tmp_path_factory):
    """Both spawns: the tp2 LM grids, then the tp4 gemma3 grid and the
    composed stack."""
    tmp = str(tmp_path_factory.mktemp("tp_lm"))
    batches = {arch: _batches(arch) for arch in KV}
    lm = {arch: raw[arch] for arch in KV}
    tp2 = launch_ranks(lm_grid, 2, device="cpu", tmpdir=tmp,
                       args=(lm, TP2, batches, None))
    tp4 = launch_ranks(lm_grid, 4, device="cpu", tmpdir=tmp,
                       args=({"gemma3-1b": lm["gemma3-1b"]}, TP4, batches,
                             STACK + (raw["nllb600m"], _src())))
    return {2: tp2, 4: tp4}


@pytest.fixture(scope="module")
def single(raw):
    """The port's single-device grids of every case, and the prefill
    logits of the first case of each spawn."""
    out = {}
    for arch, kv, spec, paged, horizon in TP2:
        pipe = deploy(lm_config(arch, kv), spec, params=from_numpy_tree(raw[arch], "cpu"),
                      device="cpu", paged=paged, horizon=horizon, **LM_KW)
        prompts = lm_prompts(_batches(arch))
        out[arch, spec, paged, horizon] = lm_grids(pipe, prompts)
        if "logits" not in out:
            out["logits"] = lm_prefill_logits(pipe, prompts[0])
    return out


@pytest.fixture(scope="module")
def jax_grids(raw):
    """The JAX single-device engines' grids: gemma3-1b int8 dense at
    horizon 1 (the LM grid), and nllb600m int8 paged at horizon 16 (the
    composed stack's), as the reference's TP tests build them."""
    pipe = j_deploy(_j_config("gemma3-1b"), "int8",
                    params=jax.tree_util.tree_map(jnp.asarray, raw["gemma3-1b"]), paged=False,
                    horizon=1, ctx=JCtx(compute_dtype=jnp.float32),
                    **{k: v for k, v in LM_KW.items() if k != "ctx"})
    prompts = [{k: jnp.asarray(v) for k, v in b.items()} for b in _batches("gemma3-1b")]
    out = {"gemma": tuple(
        [(list(o.token_ids), o.finish_reason) for o in pipe.generate(prompts, sp)]
        for sp in (JSamplingParams(max_new_tokens=8),
                   JSamplingParams(max_new_tokens=8, temperature=0.8, top_k=8, seed=7)))}
    kw = dict(common(True, 16), ctx=JCtx(compute_dtype=jnp.float32))
    kw.pop("smoke")
    pipe = j_deploy(j_reduce_config(J_REGISTRY["nllb600m"]), "int8", params=None,
                    init_seed=0, **kw)
    src = jnp.asarray(_src())
    out["nllb"] = tuple(
        [(list(o.token_ids), o.finish_reason) for o in pipe.translate(src, lang, sp)]
        for lang, sp in (("ita", JSamplingParams(max_new_tokens=8)),
                         ("hin", JSamplingParams(max_new_tokens=8, temperature=0.8,
                                                 top_k=8, seed=7))))
    return out


@pytest.mark.parametrize("case", TP2, ids=_case_id)
def test_tp2_lm_streams_equal_port_single_device(case, ranks, single):
    arch, _, spec, paged, horizon = case
    want = single[arch, spec, paged, horizon]
    for rank in ranks[2]:
        assert rank["grids"][arch, spec, paged, horizon] == want, case
    assert all(r == "length" for g in want for _, r in g)
    # the seeds matter: sampled streams are not the greedy ones
    assert want[0] != want[1]


def test_tp2_gemma_int8_dense_equals_jax_single_device(ranks, jax_grids):
    for rank in ranks[2]:
        assert rank["grids"]["gemma3-1b", "int8", False, 1] == jax_grids["gemma"]


def test_tp4_gemma_paged_h16_equals_port_single_device(ranks, single):
    """gemma3-1b's one KV head on four ranks of one query head each: the
    same grid as the port's single device (its int4 paged horizon-16
    engine)."""
    assert len(ranks[4]) == 4
    for rank in ranks[4]:
        assert rank["grids"]["gemma3-1b", "int4", True, 16] == \
            single["gemma3-1b", "int4", True, 16]
        assert rank["local"] == (1, 1, 24)       # 4 heads, 1 KV head, d_ff 96 over 4


@pytest.mark.parametrize("tp", [2, 4])
def test_lm_ranks_agree_and_keep_local_widths(tp, ranks):
    first = ranks[tp][0]
    assert "over gloo" in first["mesh"] and "model" in first["mesh"]
    for other in ranks[tp][1:]:
        assert other["grids"] == first["grids"]
    # gemma3-1b's first case: H 4 and d_ff 96 split, the one KV head kept
    assert first["local"] == (4 // tp, 1, 96 // tp)


def test_tp2_rank_local_prefill_logits_match_one_device(ranks, single):
    """gemma3-1b int4 paged (the first case): the whole prefill's logits
    through each rank's own model and shard, vocabulary gathered."""
    want = single["logits"]
    for rank in ranks[2]:
        err = np.abs(rank["logits"] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("grid", ["greedy", "sampled"])
def test_composed_stack_streams_equal_jax_single_device(grid, ranks, jax_grids):
    """deploy_replicas(replicas=2, tp=2) on 4 ranks: every rank returns
    the JAX single-device engine's grid; ranks 0-1 serve replica 0,
    ranks 2-3 replica 1, each on two heads of four."""
    k = ("greedy", "sampled").index(grid)
    assert [r["stack"]["group"] for r in ranks[4]] == [0, 0, 1, 1]
    for rank in ranks[4]:
        assert rank["stack"]["grids"][k] == jax_grids["nllb"][k]
        assert rank["stack"]["local_heads"] == 2


def test_composed_stack_metrics_are_replica_sums(ranks):
    for rank in ranks[4]:
        m = rank["stack"]["metrics"]
        assert m == ranks[4][0]["stack"]["metrics"]
        for key, total in m["merged"].items():
            assert total == sum(p[key] for p in m["per"]), key
        # two grids x 3 rows x 8 tokens, the first of each from its prefill
        assert m["merged"]["synced_tokens"] == 2 * 3 * (8 - 1)
        assert m["ttft_count"] == sum(m["ttft_per"]) == 6
        assert "repro_cluster_ttft_ms_bucket" in m["prometheus"]
        assert 'repro_cluster_replica_occupancy{replica="1"}' in m["prometheus"]


def test_composed_stack_places_as_the_tp1_router(ranks, raw):
    """The replicated router places each request where the in-process
    router over two single-device engines does, on every rank, and the
    routed streams are those engines' streams."""
    pipe = deploy_replicas("nllb600m", STACK[0], replicas=2, device="cpu",
                           params=from_numpy_tree(raw["nllb600m"], "cpu"), **common(True, 16))
    router, src = pipe.engine, _src()
    prompts = [{"src_tokens": torch.as_tensor(src[i:i + 1]),
                "tgt_in": torch.full((1, 1), 7, dtype=torch.int32)} for i in range(len(src))]
    gids = [router.submit(p, GREEDY) for p in prompts]
    placed = [router._owner[g][0] for g in gids]
    by_id = {o.request_id: o.token_ids for o in router.run_until_drained()}
    assert sorted(set(placed)) == [0, 1]
    for rank in ranks[4]:
        assert rank["stack"]["placements"] == placed
        assert rank["stack"]["routed"] == [by_id[g] for g in gids]


# ---------------------------------------------------------------------------
# no spawn: two ranks in threads, shard layout (d), refusals
# ---------------------------------------------------------------------------

class _ThreadGroup(TPGroup):
    """A tensor-parallel group of ranks that are threads of this process:
    the all-reduce sums every rank's tensor behind a barrier; every
    gathered shape is recorded."""

    def __init__(self, rank, size, shared):
        super().__init__(None, rank, size, "threads")
        self.shared = shared

    def all_reduce(self, x):
        parts, barrier = self.shared["parts"], self.shared["barrier"]
        parts[self.rank] = x.to(torch.float32)
        barrier.wait()
        y = sum(parts[r] for r in range(self.size))
        barrier.wait()
        return y.to(x.dtype)

    def gather(self, x, dim):
        self.shared["gathered"].append((self.rank, tuple(x.shape)))
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.size
        out = x.new_zeros(shape)
        out.narrow(dim, self.rank * n, n).copy_(x)
        return self.all_reduce(out)


def _thread_ranks(tp, fn):
    """``fn(rank, group)`` on ``tp`` threads; returns (results by rank,
    the gathered shapes)."""
    shared = {"parts": {}, "barrier": threading.Barrier(tp), "gathered": []}
    out, errs = [None] * tp, []

    def run(r):
        try:
            out[r] = fn(r, _ThreadGroup(r, tp, shared))
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
    return out, shared["gathered"]


def _rank_parts(arch, tp, rank, params):
    """(local model, shard) of rank ``rank`` at tp, as the engine builds
    them (``tp_engine_parts``)."""
    cfg = lm_config(arch, KV[arch])
    specs = param_specs(params, {"model": tp}, fsdp_scope="none")
    shard = shard_tree(params, specs, rank, {"model": tp}, kv_replicas=kv_replicas(cfg, tp))
    return build_model(local_config(cfg, tp), "cpu"), shard


@pytest.mark.parametrize("arch", ["gemma3-1b", "llava-next-mistral-7b"])
def test_vocab_split_embed_equals_one_device(arch, raw):
    """gemma3-1b (int8 table, embed scale after the sum) and llava (image
    rows after the token rows): each rank's ``_embed`` of its vocabulary
    slice equals one device's."""
    cfg = lm_config(arch, KV[arch])
    params = quantize_tree(from_numpy_tree(raw[arch], "cpu"), resolve_spec("int8").policy())
    b = lm_prompts(_batches(arch))[0]
    img = b.get("img_embeds")
    want = tf._embed(CTX, params, cfg, b["tokens"], img)

    def rank_embed(r, group):
        _, shard = _rank_parts(arch, 2, r, params)
        assert shard["embedding"].shape[0] == cfg.vocab_size // 2
        return tf._embed(dataclasses.replace(CTX, tp=group), shard, cfg, b["tokens"], img)

    got, _ = _thread_ranks(2, rank_embed)
    for g in got:
        assert g.shape == want.shape
        assert torch.equal(g, want)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-14b"])
def test_prefill_under_a_mesh_gathers_only_the_rows_read(arch, raw):
    """A batch of two prompts through each rank's local model: with the
    rows the engine reads (the last real token of each) the head gathers
    (2, V / 2) a rank, where the whole prefill would gather (2, S, V / 2);
    the rows equal one device's (1e-5 of the largest logit)."""
    cfg = lm_config(arch, KV[arch])
    params = quantize_tree(from_numpy_tree(raw[arch], "cpu"), resolve_spec("int4").policy())
    toks = torch.as_tensor(np.stack([_batches(arch)[i]["tokens"][0, :9] for i in range(2)]))
    lengths = torch.tensor([9, 6], dtype=torch.int32)
    read = lengths.long() - 1
    single = build_model(cfg, "cpu")
    _, full = single.prefill(CTX, params, single.init_cache(2, 16, "int8"),
                             {"tokens": toks, "lengths": lengths})
    want = full[torch.arange(2), read]

    def rank_prefill(r, group):
        model, shard = _rank_parts(arch, 2, r, params)
        ctx = dataclasses.replace(CTX, tp=group)
        batch = {"tokens": toks, "lengths": lengths}
        _, rows = model.prefill(ctx, shard, model.init_cache(2, 16, "int8"), batch, read=read)
        return rows

    got, gathered = _thread_ranks(2, rank_prefill)
    assert sorted(gathered) == [(0, (2, cfg.vocab_size // 2)), (1, (2, cfg.vocab_size // 2))]
    for g in got:
        assert g.shape == (2, cfg.vocab_size)
        assert float((g - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("tp,hkv", [(2, 1), (4, 1), (4, 2)])
def test_shard_tree_replicates_kv_heads_layout_d(tp, hkv):
    """Rank r gets the columns of KV head ``r // (tp / Hkv)`` whole in
    ``wk`` / ``wv`` (int8 codes and scales, f32), ``bias_k`` / ``bias_v``;
    the query projection keeps the even split; q/k norms replicate."""
    hd, d, heads = 16, 64, 4
    g = torch.Generator().manual_seed(5)
    w = {n: torch.randn((2, d, c), generator=g) for n, c in
         (("wq", heads * hd), ("wk", hkv * hd), ("wv", hkv * hd))}
    tree = {"layers": {"attn": {
        "wq": QTensor.quantize(w["wq"], "int8", 64), "wk": QTensor.quantize(w["wk"], "int8", 64),
        "wv": w["wv"], "bias_q": torch.randn((2, heads * hd), generator=g),
        "bias_k": torch.randn((2, hkv * hd), generator=g),
        "bias_v": torch.randn((2, hkv * hd), generator=g),
        "q_norm": torch.randn((2, hd), generator=g), "k_norm": torch.randn((2, hd), generator=g)}}}
    specs = param_specs(tree, {"model": tp}, fsdp_scope="none")
    attn = tree["layers"]["attn"]
    for r in range(tp):
        got = shard_tree(tree, specs, r, {"model": tp}, kv_replicas=tp // hkv)["layers"]["attn"]
        head = slice((r // (tp // hkv)) * hd, (r // (tp // hkv) + 1) * hd)
        q = slice(r * heads * hd // tp, (r + 1) * heads * hd // tp)
        assert torch.equal(got["wk"].data, attn["wk"].data[..., head])
        assert torch.equal(got["wk"].scales, attn["wk"].scales[..., head])
        assert got["wk"].shape == (2, d, hd)
        assert torch.equal(got["wv"], attn["wv"][..., head])
        for b in ("bias_k", "bias_v"):
            assert torch.equal(got[b], attn[b][..., head])
        assert torch.equal(got["wq"].data, attn["wq"].data[..., q])
        assert torch.equal(got["bias_q"], attn["bias_q"][..., q])
        for n in ("q_norm", "k_norm"):
            assert torch.equal(got[n], attn[n])


def test_kv_heads_that_tp_splits_or_replicates():
    """Hkv % tp == 0: Hkv / tp a rank; tp % Hkv == 0: one a rank, tp / Hkv
    copies; any other pair replicates the attention: every rank holds all
    48 query heads and the Hkv KV heads (no copies to place), while the
    FFN, which tp divides, still splits, and a dense cache of 48
    positions splits its sequence, 48 / tp rows a rank."""
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), num_heads=48, d_ff=13824 * 3)
    for hkv, tp, local, copies in ((8, 2, 4, 1), (8, 8, 1, 1), (2, 4, 1, 2), (1, 8, 1, 8)):
        c = dataclasses.replace(cfg, num_kv_heads=hkv)
        assert local_config(c, tp).num_kv_heads == local
        assert local_config(c, tp).replicated == ()
        assert kv_replicas(c, tp) == copies
    for hkv, tp in ((6, 4), (2, 3), (4, 6)):
        c = dataclasses.replace(cfg, num_kv_heads=hkv)
        refuse_under_mesh(c, tp=tp)
        lc = local_config(c, tp)
        assert (lc.num_heads, lc.num_kv_heads, lc.d_ff) == (48, hkv, 13824 * 3 // tp)
        assert (lc.tp, lc.replicated, kv_replicas(c, tp)) == (tp, ("attn",), 1)
        assert seq_rows(lc, 48) == 48 // tp and seq_rows(lc, 50) == 50


class _Reached(Exception):
    """Raised by ``_StubMesh`` where a deploy first reads its group: the
    deploy got past every refusal."""


class _StubMesh:
    """A mesh of ``n`` ranks that stops a deploy at its first collective
    setup (``get_group``)."""

    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n

    def get_group(self):
        raise _Reached


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "nllb600m-moe", "mamba2-780m",
                                  "recurrentgemma-9b", "whisper-base"])
def test_families_reach_the_group_at_any_tp(arch):
    """Every family passes at every tp from 1 to 8, as the dense and VLM
    LMs do: the MoE families (expert parallelism), whisper-base (the audio
    mesh) and the SSM and hybrid families, whatever tp divides or not
    (a width tp does not divide replicates). A w8a8 deploy of the
    reduced arch reaches the rank's group on a tp2 and a tp5 mesh, and so
    does gemma3-1b (4 query heads) on a tp8 one; ``sla=`` under a mesh
    serves (tests/test_torch_tp_clock.py)."""
    for tp in range(1, 9):
        refuse_under_mesh(get_config(arch), tp=tp)
        for served in KV:
            refuse_under_mesh(get_config(served), tp=tp)
    for tp in (2, 5):
        with pytest.raises(_Reached):
            deploy(arch, "w8a8", smoke=True, device="cpu", mesh=_StubMesh(tp))
    with pytest.raises(_Reached):
        deploy("gemma3-1b", "w8a8", smoke=True, device="cpu", mesh=_StubMesh(8))
    assert local_config(get_config("gemma3-1b"), 8).replicated == ("attn",)
