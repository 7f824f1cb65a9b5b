"""Any tp: a sublayer whose width tp does not divide is replicated, and a
replicated attention's dense KV cache splits its sequence (the reference's
``cache_shardings``), on gloo CPU ranks against one device.

One spawn of 3 ranks (``cluster.launch_ranks``), the reduced configs (H 4,
one KV head (nllb600m four), d_ff 96, vocabulary 256, 4 experts, d_rec 64,
8 SSD heads) on the reference's key-0 weights, f32 compute, 2 slots,
greedy and seeded sampled grids (temperature 0.8, top-k 8, seed 7). At
tp3 they give every decision: the attention replicated with its dense
cache split 3 ways where 3 divides ``max_len`` (whole where it does not),
the FFN split, the vocabulary, the experts, the RG-LRU and the SSM
replicated:

* nllb600m int8 dense at ``max_len`` 48 (16 rows a rank; decoder prompts
  of 38, 17 and 4 tokens reach every block) and 32 (whole), horizon 1
  and 4, paged (the pool whole), gemma3-1b int8 dense at 48 (its window
  of 8 crosses blocks) and an x<fmt> spec (``w4a8kv8x8``, dynamic
  scales) dense at 48: every rank's grids equal the JAX single-device
  engine's, built dense at horizon 1 (the reference's own invariant
  makes every layout and horizon serve these streams) on its "pallas"
  bundle, the counterpart of the "kernels" bundle the port deploys by
  default (4-bit weights go through qmm, whose plain version rounds the
  activations to bf16 as the Pallas kernel does; the "xla" bundle's
  dequantized product does not, and its sampled stream parts);
* the x<fmt> spec again, olmoe-1b-7b int4 dense at 48, mamba2-780m int4
  (horizon 1) and recurrentgemma-9b int4 with a window of 6 (its rolling
  buffer of 6 rows split 2 a rank): every rank's grids equal the port's
  single device's;
* a decode step takes exactly 2 collectives a split attention layer (3
  with the x<fmt> slot's dynamic PV scale) and one a split FFN, none for
  a replicated sublayer.

Without a spawn, ranks run in threads over in-process sums and maxes
(``test_torch_tp_quant._threads``): the split softmax combine at tp3
and tp8 against one device's ``decode_attn_apply`` (1e-6 at f32, a rank
whose block holds no
valid position included; the x<fmt> PV operand's codes and scales are
one device's slices exactly), a gemma3-1b prefill and decode steps on 8
ranks (attention replicated, cache split 6 rows a rank, FFN and
vocabulary split) within 1e-5 of one device, and nllb600m on 5 ranks,
where every sublayer and the cache are replicated: one device's logits
bit for bit, with no collective at all.
"""

import dataclasses
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import exact_fp8_reference, jax_tree_to_numpy  # noqa: E402
from test_torch_tp_quant import _threads  # noqa: E402
from torch_tp_ranks import (CTX, UNEVEN_KW, lm_grids, lm_prompts, uneven_config,  # noqa: E402
                            uneven_grid)

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduce_config as j_reduce_config  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro.serving import impl_routes as j_impl_routes  # noqa: E402
from repro_torch.cluster import launch_ranks  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core import quantize_tree, resolve_spec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.parallel.tp import local_config, shard_params  # noqa: E402
from repro_torch.serving import deploy  # noqa: E402

ARCHS = ("nllb600m", "gemma3-1b", "olmoe-1b-7b", "mamba2-780m", "recurrentgemma-9b")
# (name, arch, spec, paged, horizon, max_len, prompt set)
JAX_CASES = [("nllb-split-h1", "nllb600m", "int8", False, 1, 48, "nllb-long"),
             ("nllb-split-h4", "nllb600m", "int8", False, 4, 48, "nllb-long"),
             ("nllb-whole-h1", "nllb600m", "int8", False, 1, 32, "nllb-short"),
             ("nllb-whole-h4", "nllb600m", "int8", False, 4, 32, "nllb-short"),
             ("nllb-paged", "nllb600m", "int8", True, 4, 48, "nllb-long"),
             ("gemma3", "gemma3-1b", "int8", False, 4, 48, "lm-long"),
             ("xfmt", "nllb600m", "w4a8kv8x8", False, 4, 48, "nllb-long")]
XFMT = JAX_CASES[-1]
PORT_CASES = [XFMT, ("olmoe", "olmoe-1b-7b", "int4", False, 4, 48, "lm-long"),
              ("mamba2", "mamba2-780m", "int4", False, 1, 32, "ssm"),
              ("hybrid", "recurrentgemma-9b", "int4", False, 4, 48, "hybrid")]
CASES = JAX_CASES + PORT_CASES[1:]
# per case: the kinds a rank replicates, its (heads, KV heads, d_ff, d_rec),
# the rows of its dense cache (None: paged, or an SSM's states) and the
# collectives a decode step takes
LAYOUT = {"nllb-split-h1": (("attn",), (4, 4, 32, 0), 16, 6),
          "nllb-split-h4": (("attn",), (4, 4, 32, 0), 16, 6),
          "nllb-whole-h1": (("attn",), (4, 4, 32, 0), 32, 2),
          "nllb-whole-h4": (("attn",), (4, 4, 32, 0), 32, 2),
          "nllb-paged": (("attn",), (4, 4, 32, 0), None, 2),
          "gemma3": (("attn",), (4, 1, 32, 0), 16, 6),
          "xfmt": (("attn",), (4, 4, 32, 0), 16, 10),
          "olmoe": (("attn",), (4, 4, 96, 0), 16, 4),
          "mamba2": (("ssd",), (4, 4, 0, 0), None, 0),
          "hybrid": (("attn", "rec"), (4, 1, 32, 64), 2, 6)}


def _prompts():
    """Numpy requests of each prompt set: nllb600m sources with decoder
    prompts reaching every 16-row block of 48 (long) or within 32
    (short), LM prompts, and the recurrent archs' (one past the hybrid's
    window)."""
    rng = np.random.default_rng(6)

    def enc_dec(lens):
        return [{"src_tokens": rng.integers(16, 256, (1, s)).astype(np.int32),
                 "tgt_in": rng.integers(0, 256, (1, n)).astype(np.int32)}
                for s, n in zip((7, 11, 5), lens)]

    def lm(lens):
        return [{"tokens": rng.integers(0, 256, (1, n)).astype(np.int32)} for n in lens]

    return {"nllb-long": enc_dec((38, 17, 4)), "nllb-short": enc_dec((20, 9, 3)),
            "lm-long": lm((38, 17, 4)), "ssm": lm((5, 11, 14)), "hybrid": lm((10, 30, 12))}


@pytest.fixture(scope="module")
def raw():
    """The reference's key-0 weights of every arch, numpy form."""
    return {arch: jax_tree_to_numpy(
        j_build_model(j_reduce_config(J_REGISTRY[arch])).init(jax.random.PRNGKey(0)))
        for arch in ARCHS}


@pytest.fixture(scope="module")
def ranks(raw, tmp_path_factory):
    """The 3-rank spawn over every case."""
    return launch_ranks(uneven_grid, 3, device="cpu",
                        tmpdir=str(tmp_path_factory.mktemp("tp_uneven")),
                        args=(raw, CASES, _prompts()))


@pytest.fixture(scope="module")
def jax_grids(raw):
    """The JAX single-device engines' greedy and sampled grids of each
    (arch, spec) of JAX_CASES, dense at horizon 1 and max_len 48 on the
    "pallas" bundle, over each prompt set its cases serve; fp8 casts
    rounded once."""
    out, prompts = {}, _prompts()
    with exact_fp8_reference(), warnings.catch_warnings():
        warnings.simplefilter("ignore")      # an act spec's dynamic fallback
        for arch, spec in sorted({c[1:3] for c in JAX_CASES}):
            pipe = j_deploy(j_reduce_config(J_REGISTRY[arch]), spec,
                            params=jax.tree_util.tree_map(jnp.asarray, raw[arch]),
                            ctx=JCtx(compute_dtype=jnp.float32), slots=2, max_len=48,
                            paged=False, horizon=1, **j_impl_routes("pallas"))
            for which in {c[6] for c in JAX_CASES if c[1:3] == (arch, spec)}:
                reqs = [{k: jnp.asarray(v) for k, v in b.items()} for b in prompts[which]]
                if arch != "nllb600m":
                    reqs = [r["tokens"][0] for r in reqs]
                out[arch, spec, which] = tuple(
                    [(list(o.token_ids), o.finish_reason) for o in pipe.generate(reqs, sp)]
                    for sp in (JSamplingParams(max_new_tokens=8),
                               JSamplingParams(max_new_tokens=8, temperature=0.8, top_k=8,
                                               seed=7)))
    return out


@pytest.fixture(scope="module")
def single(raw):
    """The port's single-device grids of PORT_CASES."""
    out, prompts = {}, _prompts()
    for name, arch, spec, paged, horizon, max_len, which in PORT_CASES:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # an act spec's dynamic fallback
            pipe = deploy(uneven_config(arch), spec, params=from_numpy_tree(raw[arch], "cpu"),
                          device="cpu", paged=paged, horizon=horizon, max_len=max_len,
                          **UNEVEN_KW)
        out[name] = lm_grids(pipe, lm_prompts(prompts[which]))
    return out


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: c[0])
def test_tp3_streams_equal_jax_single_device(case, ranks, jax_grids):
    name, arch, spec, _, _, _, which = case
    want = jax_grids[arch, spec, which]
    assert all(r == "length" for g in want for _, r in g)
    assert want[0] != want[1]           # the seeds matter
    for rank in ranks:
        assert rank["grids"][name] == want, name


def test_tp3_xfmt_greedy_grid_equals_jax_single_device(ranks, jax_grids, single):
    """The x<fmt> slot's combine (the PV scale from the ranks' max) keeps
    the JAX engine's greedy grid, and the port's single device serves
    both of the JAX engine's grids, so a parting of the ranks is the
    split's."""
    want = jax_grids[XFMT[1], XFMT[2], XFMT[6]]
    assert single["xfmt"] == want
    for rank in ranks:
        assert rank["grids"]["xfmt"][0] == want[0]


@pytest.mark.parametrize("case", PORT_CASES, ids=lambda c: c[0])
def test_tp3_streams_equal_port_single_device(case, ranks, single):
    name = case[0]
    assert single[name][0] != single[name][1]
    for rank in ranks:
        assert rank["grids"][name] == single[name], name


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_ranks_agree_and_choose_their_layout(case, ranks):
    """Every rank serves the same grids and finish reasons; its local
    config replicates exactly the kinds tp3 does not divide, and its dense
    cache holds 48 / 3 rows (6 / 3 of the hybrid's buffer) or all 32."""
    name = case[0]
    rep, widths, rows, _ = LAYOUT[name]
    for rank in ranks:
        assert rank["grids"][name] == ranks[0]["grids"][name]
        got = rank["layout"][name]
        assert (got["replicated"], got["widths"], got["rows"]) == (rep, widths, rows), name


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_decode_step_collectives(case, ranks):
    """2 a split attention layer (the max, then the packed sum), 3 with the
    x<fmt> slot's dynamic PV scale, 1 a split FFN (plus its act-quantizing
    scale's max under the x<fmt> spec's a8), none for a replicated
    sublayer or a whole cache: nllb600m's and gemma3's 2 layers, olmoe's
    2 (experts replicated), the hybrid's one attention and 4 FFNs."""
    name = case[0]
    for rank in ranks:
        assert rank["layout"][name]["per_step"] == LAYOUT[name][3], name


# ---------------------------------------------------------------------------
# no spawn: ranks in threads
# ---------------------------------------------------------------------------

def _run(tp, fn):
    """``fn(rank, group)`` on ``tp`` thread ranks (``_threads``): (results
    by rank, the collectives the group took, each sum or max once)."""
    got, shared = _threads(tp, fn)
    return got, (len(shared["sums"]) + len(shared["maxes"])) // tp


def _attn_inputs(S):
    """One attention layer (d 64, 4 heads of 16, 2 KV heads) and a decode
    step's inputs against a cache of S rows: per row lengths 5, S - 7 and
    S - 1 (a row whose later blocks hold no valid position)."""
    g = torch.Generator().manual_seed(11)
    d, H, Hkv, hd, B = 64, 4, 2, 16, 3
    params = {"wq": torch.randn(d, H * hd, generator=g) * d ** -0.5,
              "wk": torch.randn(d, Hkv * hd, generator=g) * d ** -0.5,
              "wv": torch.randn(d, Hkv * hd, generator=g) * d ** -0.5,
              "wo": torch.randn(H * hd, d, generator=g) * (H * hd) ** -0.5}
    x = torch.randn(B, 1, d, generator=g)
    k = torch.randn(B, S, Hkv, hd, generator=g)
    v = torch.randn(B, S, Hkv, hd, generator=g)
    lens = torch.tensor([5, S - 7, S - 1], dtype=torch.int32)
    idx = torch.arange(S, dtype=torch.int32)[None]
    pos = torch.where(idx < lens[:, None], idx, -1)
    return params, x, lens[:, None], k, v, pos, dict(num_heads=H, num_kv_heads=Hkv,
                                                     head_dim=hd)


@pytest.mark.parametrize("tp", [3, 8])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_split_combine_equals_one_device(tp, fmt, monkeypatch):
    """Each rank attends its block of S = 48 rows (6 at tp8, where rows
    past the first length leave five ranks nothing for one row) and the
    combine gives one device's output within 1e-6 of its largest value at
    f32, and its fresh K / V exactly; 2 collectives, 3 with the x<fmt>
    slot (int8), whose PV probability operand each rank quantizes to one
    device's codes and scales, exactly (the whole row's scale from the
    ranks' max)."""
    S = 48
    params, x, positions, k, v, pos, dims = _attn_inputs(S)
    ctx = layers.Ctx(compute_dtype=torch.float32, attn_act_fmt=fmt)
    seen, rank_of = {}, {}
    real = layers.quantize_activations

    def spy(xs, fmt="int8", scale=None):
        codes, sc = real(xs, fmt=fmt, scale=scale)
        seen.setdefault(threading.get_ident(), []).append((codes, sc))
        return codes, sc

    monkeypatch.setattr(layers, "quantize_activations", spy)
    want = layers.decode_attn_apply(ctx, params, x, positions, k, v, pos, **dims)
    rows = S // tp

    def rank_apply(r, group):
        rank_of[threading.get_ident()] = r
        blk = slice(r * rows, (r + 1) * rows)
        return layers.decode_attn_apply(ctx.solo, params, x, positions, k[:, blk], v[:, blk],
                                        pos, group=group, **dims)

    got, collectives = _run(tp, rank_apply)
    assert collectives == (3 if fmt == "int8" else 2)
    for g in got:
        assert float((g[0] - want[0]).abs().max()) <= 1e-6 * float(want[0].abs().max())
        assert torch.equal(g[1], want[1]) and torch.equal(g[2], want[2])
    if fmt == "int8":
        # the quantized operands in call order: QK's q and cache K, the
        # fresh score's q and K, then PV's probabilities and cache V
        one = seen.pop(threading.get_ident())[4]
        assert sorted(rank_of.values()) == list(range(tp)) and len(seen) == tp
        for ident, calls in seen.items():
            codes, sc = calls[4]
            blk = slice(rank_of[ident] * rows, (rank_of[ident] + 1) * rows)
            assert torch.equal(codes, one[0][..., blk]) and torch.equal(sc, one[1])


def _gemma_parts():
    """The reduced gemma3-1b int8 on the reference's key-0 weights, two
    prompts (20 and 9 tokens) and their lengths."""
    cfg = uneven_config("gemma3-1b")
    raw = jax_tree_to_numpy(j_build_model(j_reduce_config(J_REGISTRY["gemma3-1b"])).init(
        jax.random.PRNGKey(0)))
    params = quantize_tree(from_numpy_tree(raw, "cpu"), resolve_spec("int8").policy())
    rng = np.random.default_rng(9)
    toks = torch.as_tensor(rng.integers(0, 256, (2, 20)).astype(np.int32))
    return cfg, params, toks, torch.tensor([20, 9], dtype=torch.int32)


def _serve_steps(model, ctx, params, toks, lens, max_len, steps):
    """A prefill of ``toks`` and ``steps`` greedy decode steps: every
    step's logits."""
    cache = model.init_cache(toks.shape[0], max_len, "int8")
    cache, logits = model.prefill(ctx, params, cache, {"tokens": toks, "lengths": lens},
                                  read=lens.long() - 1)
    out = [logits]
    for _ in range(steps):
        cache, logits = model.decode_step(ctx, params, out[-1].argmax(-1)[:, None].int(),
                                          cache)
        out.append(logits[:, -1])
    return torch.stack(out)


def test_gemma3_decode_steps_on_8_thread_ranks():
    """gemma3-1b at tp8: the attention (4 query heads) replicated with its
    48-row cache split 6 a rank, the FFN (12 of 96 columns) and the
    vocabulary (32 of 256) split; a prefill and 4 decode steps reaching
    rows of ranks 0-3 (ranks 4-7 hold no valid position) within 1e-5 of
    one device's largest logit, every rank's logits the same bits. The
    prefill takes 2 FFN sums, the embedding's sum and the head's gather;
    a decode step 2 layers x (2 + 1) collectives, the sum and the
    gather."""
    cfg, params, toks, lens = _gemma_parts()
    want = _serve_steps(build_model(cfg, "cpu"), CTX, params, toks, lens, 48, 4)
    lc = local_config(cfg, 8)
    assert (lc.replicated, lc.num_heads, lc.d_ff) == (("attn",), 4, 12)

    def rank_run(r, group):
        model = build_model(lc, "cpu")
        shard = shard_params(params, cfg, model, group)
        ctx = dataclasses.replace(CTX, tp=group)
        cache = model.init_cache(2, 48, "int8")
        assert cache["k_codes"].shape[2] == 6 and cache["pos"].shape[1] == 48
        return _serve_steps(model, ctx, shard, toks, lens, 48, 4)

    got, collectives = _run(8, rank_run)
    for g in got:
        assert g.shape == want.shape
        assert torch.equal(g, got[0])
        assert float((g - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert collectives == 4 + 4 * (2 * 3 + 2)


def test_replicated_sublayers_take_no_collective():
    """nllb600m at tp5: the attention (4 heads), the FFN (96 columns) and
    the vocabulary (256) are all replicated and 5 does not divide a
    48-row cache, so every rank holds the whole model and cache, runs one
    device's code and takes no collective: its prefill and 3 decode
    steps give one device's logits bit for bit."""
    cfg = uneven_config("nllb600m")
    raw = jax_tree_to_numpy(j_build_model(j_reduce_config(J_REGISTRY["nllb600m"])).init(
        jax.random.PRNGKey(0)))
    params = quantize_tree(from_numpy_tree(raw, "cpu"), resolve_spec("int8").policy())
    rng = np.random.default_rng(10)
    batch = {"src_tokens": torch.as_tensor(rng.integers(16, 256, (2, 7)).astype(np.int32)),
             "tgt_in": torch.as_tensor(rng.integers(0, 256, (2, 12)).astype(np.int32))}

    def run(model, ctx, p):
        cache = model.init_cache(2, 48, "int8")
        cache, logits = model.prefill(ctx, p, cache, batch)
        out = [logits[:, -1]]
        for _ in range(3):
            cache, logits = model.decode_step(ctx, p, out[-1].argmax(-1)[:, None].int(), cache)
            out.append(logits[:, -1])
        return torch.stack(out)

    want = run(build_model(cfg, "cpu"), CTX, params)
    lc = local_config(cfg, 5)
    assert lc.replicated == ("attn", "ffn")

    def rank_run(r, group):
        model = build_model(lc, "cpu")
        return run(model, dataclasses.replace(CTX, tp=group),
                   shard_params(params, cfg, model, group))

    got, collectives = _run(5, rank_run)
    assert collectives == 0
    for g in got:
        assert torch.equal(g, want)
