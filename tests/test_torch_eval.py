"""The port's quality-evaluation subsystem against the JAX package's
(smoke nllb600m, on the CPU).

  * metrics and ``CorpusStat``: the same floats as the reference's on
    seeded (and, where hypothesis is installed, drawn) token lists;
  * reports written by either package load in the other, unchanged;
  * on a short JAX fit, converted, the port's token grids and quality
    cells (BLEU, chrF, token accuracy, exact match) equal the JAX
    engines' exactly, for bf16 and int8, dense horizon 1 and paged
    horizon 4 ("torch" against "xla" bundles: the same routes);
  * the port's own 1500-step fit (the reference test's settings) meets
    the reference test's bars through the default "kernels" bundle
    (their plain versions here): bf16 mean BLEU and chrF > 0.8, int8
    within 0.15 of it with fewer bytes, calibrated w8a8 > 0.5, and the
    same grid dense horizon 1 and paged horizon 4;
  * ``launch.eval`` writes a report that ``repro.eval.load`` reads.
"""

import json
from dataclasses import astuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch  # noqa: E402

from repro.configs import REGISTRY, reduce_config as j_reduce  # noqa: E402
from repro.data import SyntheticTranslation as JSyntheticTranslation  # noqa: E402
from repro.eval import decode_token_grid as j_decode_token_grid  # noqa: E402
from repro.eval import evaluate_pairs as j_evaluate_pairs  # noqa: E402
from repro.eval import load as j_load  # noqa: E402
from repro.eval import make_report as j_make_report  # noqa: E402
from repro.eval import save as j_save  # noqa: E402
from repro.eval import metrics as jmet  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro.serving import impl_routes as j_impl_routes  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.data import SyntheticTranslation  # noqa: E402
from repro_torch.eval import (decode_token_grid, evaluate_pairs, load,  # noqa: E402
                              make_report, quant_sweep, render_markdown, save,
                              summarize)
from repro_torch.eval import metrics as tmet  # noqa: E402
from repro_torch.launch.eval import train_params  # noqa: E402
from repro_torch.models import Ctx  # noqa: E402
from repro_torch.serving import deploy, impl_routes  # noqa: E402

JCFG = j_reduce(REGISTRY["nllb600m"])
CFG = reduce_config(get_config("nllb600m"))
LANGS = ["hin", "eng"]
PAIRS = [("hin", "eng"), ("eng", "hin")]
N_SENT = 6
JAX_FIT_STEPS = 300
LAYOUTS = {"dense-h1": dict(horizon=1), "paged-h4": dict(paged=True, page_size=4, horizon=4)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's small training ops: their
    arithmetic, and so a fit's trajectory and scores, is then the same on
    every machine, and beside other test workers it runs faster."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _corpora(seed, n=40):
    rng = np.random.default_rng(seed)
    hyps, refs = [], []
    for _ in range(n):
        r = rng.integers(0, 12, rng.integers(0, 14)).tolist()
        h = [t if rng.random() < 0.7 else int(rng.integers(0, 12)) for t in r]
        h = h[:int(rng.integers(0, len(h) + 1))] + rng.integers(0, 12, rng.integers(0, 3)).tolist()
        hyps.append(h)
        refs.append(r)
    return hyps, refs


def _same_metrics(hyps, refs):
    for kw in (dict(), dict(smoothing="none"), dict(smoothing="floor"), dict(max_n=2)):
        assert astuple(tmet.corpus_bleu(hyps, refs, **kw)) == \
            astuple(jmet.corpus_bleu(hyps, refs, **kw))
    for kw in (dict(), dict(word_order=2), dict(beta=1.0, max_n=3)):
        assert tmet.corpus_chrf(hyps, refs, **kw) == jmet.corpus_chrf(hyps, refs, **kw)
    detok = " ".join
    strs = [[str(t) for t in h] for h in hyps], [[str(t) for t in r] for r in refs]
    assert astuple(tmet.corpus_bleu(*strs, detok=detok)) == \
        astuple(jmet.corpus_bleu(*strs, detok=detok))
    assert tmet.corpus_chrf(*strs, detok=detok, word_order=2) == \
        jmet.corpus_chrf(*strs, detok=detok, word_order=2)
    a, b = tmet.CorpusStat(), jmet.CorpusStat()
    for h, r in zip(hyps, refs):
        a.update(h, r)
        b.update(h, r)
        assert tmet.token_accuracy(h, r) == jmet.token_accuracy(h, r)
        assert tmet.exact_match(h, r) == jmet.exact_match(h, r)
    for sm in ("add-k", "none"):
        assert a.results(sm) == b.results(sm)
    half = len(hyps) // 2
    merged = []
    for mod in (tmet, jmet):
        m1, m2 = mod.CorpusStat(), mod.CorpusStat()
        for h, r in zip(hyps[:half], refs[:half]):
            m1.update(h, r)
        for h, r in zip(hyps[half:], refs[half:]):
            m2.update(h, r)
        merged.append(m1.merge(m2).results())
    assert merged[0] == merged[1]


@pytest.mark.parametrize("seed", range(4))
def test_metrics_equal_reference_on_seeded_corpora(seed):
    _same_metrics(*_corpora(seed))


def test_metrics_equal_reference_on_drawn_corpora():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    seqs = st.lists(st.integers(0, 9), max_size=12)

    @hypothesis.settings(max_examples=60, deadline=None)
    @hypothesis.given(st.lists(st.tuples(seqs, seqs), min_size=1, max_size=8))
    def check(pairs_):
        _same_metrics([h for h, _ in pairs_], [r for _, r in pairs_])

    check()


def _rows():
    """Two sweep-shaped rows with every column type a report holds."""
    pair = dict(src="hin", tgt="eng", bleu=0.9, chrf=0.95, token_acc=0.8, exact_match=0.5,
                n_sent=2, gen_tokens=20, tok_s=100.0, ttft_p50_ms=1.0, ttft_p95_ms=2.0,
                tpot_p50_ms=0.5, tpot_p95_ms=0.7, acceptance_rate=None)
    row = dict(fmt="bf16", spec="w16", model_bytes=10, fp_bytes=20, compression=2.0,
               kv_cache_bytes=5, mean_bleu=0.9, mean_chrf=0.95, mean_token_acc=0.8,
               mean_tok_s=100.0, gen_tokens=20, ttft_p95_ms=2.0, tpot_p95_ms=0.7,
               round_phases={"admit_ms": 1.0, "dispatch_ms": 2.0, "sync_ms": 0.0,
                             "walk_ms": 1.5},
               bleu_delta=None, chrf_delta=None, calibrated=False, pair_scores=[pair])
    return [row, dict(row, fmt="int8", spec="w8", bleu_delta=0.0, chrf_delta=float("nan"),
                      round_phases=None)]


def test_reports_cross_load_both_ways(tmp_path):
    cfg = {"formats": ["bf16", "int8"], "n_sent": 2}
    ours = make_report(arch="nllb600m-smoke", rows=_rows(), config=cfg)
    theirs = j_make_report(arch="nllb600m-smoke", rows=_rows(), config=cfg)
    assert ours == theirs
    save(ours, str(tmp_path / "t.json"))
    j_save(theirs, str(tmp_path / "j.json"))
    for name in ("t.json", "j.json"):
        text = (tmp_path / name).read_text()
        assert load(text) == j_load(text) == ours
    assert render_markdown(ours) == __import__("repro.eval", fromlist=["x"]).render_markdown(ours)
    v1 = {"schema": 1, "kind": "repro.eval", "arch": "a",
          "rows": [{k: v for k, v in r.items()
                    if k not in ("spec", "ttft_p95_ms", "tpot_p95_ms", "round_phases")}
                   for r in _rows()]}
    assert load(json.dumps(v1)) == j_load(json.dumps(v1))
    with pytest.raises(TypeError):
        make_report(arch="x", rows=[{"bad": object()}])


@pytest.fixture(scope="module")
def jax_fit():
    """The reference's train step, jitted, on the reduced NLLB for a short
    fit: far from converged, so its greedy grids are not trivial."""
    jm = j_build_model(JCFG)
    ds = JSyntheticTranslation(JCFG.vocab_size, JCFG.enc_len, seed=0, languages=LANGS)
    init, step = j_make_train_step(
        jm, lr_fn=lambda s: j_warmup_cosine(s, peak_lr=3e-3, warmup=20, total=JAX_FIT_STEPS),
        ctx=JCtx(compute_dtype=jnp.float32))
    state = init(jm.init(jax.random.PRNGKey(0)))
    step = jax.jit(step, donate_argnums=0)
    for _ in range(JAX_FIT_STEPS):
        b = ds.sample(32)
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()
                                if not isinstance(v, str)})
    return state["params"]


def _cells(scores):
    return [(s.src, s.tgt, s.bleu, s.chrf, s.token_acc, s.exact_match, s.n_sent,
             s.gen_tokens) for s in scores]


@pytest.mark.parametrize("spec", ["bf16", "int8"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_grid_equals_jax_engines_on_a_jax_fit(jax_fit, spec, layout):
    kw = dict(slots=4, max_len=16, **LAYOUTS[layout])
    jpipe = j_deploy(JCFG, spec, params=jax_fit, ctx=JCtx(compute_dtype=jnp.float32),
                     **kw, **j_impl_routes("xla"))
    tpipe = deploy(CFG, spec, params=jax_to_torch(jax_fit), ctx=Ctx(compute_dtype=torch.float32),
                   device="cpu", **kw, **impl_routes("torch"))
    grid_kw = dict(n_sent=N_SENT, seed=0, languages=LANGS)
    want = j_decode_token_grid(jpipe, PAIRS, **grid_kw)
    got = decode_token_grid(tpipe, PAIRS, **grid_kw)
    assert got == want
    # not the floor: the fit already translates part of each sentence
    assert any(len(set(toks)) > 3 for cell in got.values() for toks, _ in cell)
    ws = j_evaluate_pairs(jpipe, PAIRS, **grid_kw)
    ts = evaluate_pairs(tpipe, PAIRS, **grid_kw)
    assert _cells(ts) == _cells(ws)
    assert 0.05 < summarize(ts)["mean_bleu"] < 0.99


@pytest.fixture(scope="module")
def port_fit():
    """The port's own fit, by its TrainLoop, at the reference test's settings."""
    return train_params(CFG, LANGS, steps=1500, batch=32, lr=3e-3, seed=0, device="cpu",
                        log=lambda *_: None)


def _ctx(act="bf16"):
    return Ctx(compute_dtype=torch.float32, act_fmt=act)


def test_port_fit_meets_the_quality_bars(port_fit):
    def calib():
        ds = SyntheticTranslation(CFG.vocab_size, CFG.enc_len, seed=0, languages=LANGS)
        return ({k: torch.as_tensor(v) for k, v in ds.sample(8).items()
                 if not isinstance(v, str)} for _ in range(3))

    rows = quant_sweep(CFG, ["bf16", "int8", "w8a8"], params=port_fit, pair_list=PAIRS,
                       languages=LANGS, n_sent=N_SENT, seed=0, calib_batches_fn=calib,
                       deploy_kwargs={"slots": 4, "max_len": 16, "ctx": _ctx(),
                                      "device": "cpu"},
                       trace=True, log=lambda *_: None)
    bf16, int8, w8a8 = rows
    assert bf16.mean_bleu > 0.8 and bf16.mean_chrf > 0.8, bf16
    assert bf16.bleu_delta is None
    assert abs(int8.bleu_delta) <= 0.15 and abs(int8.chrf_delta) <= 0.15, int8
    assert int8.model_bytes < bf16.model_bytes and int8.compression > bf16.compression
    assert w8a8.calibrated and w8a8.mean_bleu > 0.5, w8a8
    assert {(p.src, p.tgt) for p in bf16.pair_scores} == set(PAIRS)
    assert all(set(r.round_phases) == {"admit_ms", "dispatch_ms", "sync_ms", "walk_ms"}
               for r in rows)
    report = make_report(arch=CFG.name, rows=[r.as_row() for r in rows])
    assert j_load(json.dumps(report)) == report


def test_port_fit_grid_does_not_depend_on_the_layout(port_fit):
    grids = {}
    for name, kw in LAYOUTS.items():
        pipe = deploy(CFG, "int8", params=port_fit, slots=4, max_len=16, ctx=_ctx(),
                      device="cpu", **kw)
        grids[name] = decode_token_grid(pipe, PAIRS, n_sent=N_SENT, seed=0, languages=LANGS)
    assert grids["dense-h1"] == grids["paged-h4"]


def test_evaluate_pairs_needs_an_encdec_pipeline():
    class Pipe:
        cfg = CFG.__class__(**{**CFG.__dict__, "family": "dense"})

    with pytest.raises(TypeError, match="enc-dec"):
        evaluate_pairs(Pipe(), PAIRS, n_sent=1)
    with pytest.raises(TypeError, match="enc-dec"):
        decode_token_grid(Pipe(), PAIRS, n_sent=1)


def test_launch_eval_smoke_cpu(tmp_path, capsys):
    from repro_torch.launch.eval import main
    path = tmp_path / "report.json"
    main(["--smoke", "--device", "cpu", "--formats", "bf16,int8", "--train-steps", "40",
          "--n-sent", "2", "--json", str(path), "--parity-tol", "-1"])
    out = capsys.readouterr().out
    assert "[report] wrote" in out and "| int8 |" in out
    report = j_load(path.read_text())
    assert [r["fmt"] for r in report["rows"]] == ["bf16", "int8"]
    assert report["config"]["impl"] == "kernels" and report["config"]["device"] == "cpu"
