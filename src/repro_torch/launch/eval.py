"""Quality-evaluation launcher: the paper's experimental grid, end to end.

Train the synthetic many-to-many task to convergence (``train.TrainLoop``),
deploy the checkpoint at every requested precision preset, run the
bidirectional pair matrix through the serving engine per format, and
write the JSON + markdown quality report:

  PYTHONPATH=src python -m repro_torch.launch.eval --smoke --device cpu \
      --formats bf16,int8 --pairs hin-eng,eng-hin --json out.json

The reference launcher's flags plus ``--device`` (default ``cuda``, which
raises without a card). ``--impl`` defaults to the ``"kernels"`` bundle,
as serving does; training always runs the plain torch routes. Without
``--train-steps`` the smoke default (1500 steps) drives the reduced NLLB
to BLEU ~1.0 on the held-out split, so per-format deltas measure
quantization, not an untrained model.

When both ``bf16`` and ``int8`` are requested, the run asserts the
paper's parity claim: int8 mean BLEU within ``--parity-tol`` of the
bf16 anchor (exit 1 otherwise).
"""

from __future__ import annotations

import argparse
import tempfile
import time

import torch

from ..configs import REGISTRY, get_config, reduce_config
from ..core import ALIASES, resolve_spec
from ..data import LANG_CODES, SyntheticTranslation, pairs as fig9_pairs
from ..eval import make_report, quant_sweep, render_markdown, save
from ..eval.suite import _ordered_langs
from ..models import Ctx, build_model
from ..optim import warmup_cosine
from ..random import prng_key
from ..serving import DEFAULT_IMPL, IMPL_CHOICES, impl_routes
from ..train import TrainLoop, make_train_step
from .train import training_device

__all__ = ["main", "parse_pairs", "train_params"]


def parse_pairs(text: str):
    """'hin-eng,eng-hin' -> [('hin', 'eng'), ('eng', 'hin')]."""
    out = []
    for chunk in text.split(","):
        parts = chunk.strip().split("-")
        if len(parts) != 2 or not all(parts):
            raise argparse.ArgumentTypeError(
                f"bad pair {chunk!r}; expected src-tgt like hin-eng")
        out.append((parts[0], parts[1]))
    return out


def _pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _tensors(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()
            if not isinstance(v, str)}


def train_params(cfg, langs, *, steps: int, batch: int, lr: float,
                 seed: int, device="cuda", log=print):
    """Fit the synthetic task (train split) via the TrainLoop; returns the
    trained parameter tree on ``device``."""
    dev = training_device(device)
    model = build_model(cfg, dev)
    ctx = Ctx(compute_dtype=torch.float32)
    ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=seed,
                              languages=langs)

    def batches():
        while True:
            yield _tensors(ds.sample(batch), dev)

    init_state, step = make_train_step(
        model, lr_fn=lambda s: warmup_cosine(s, peak_lr=lr, warmup=20,
                                             total=steps), ctx=ctx)
    # the reference's initial weights for this seed (random.prng_key)
    state = init_state(model.init(prng_key(seed, dev)))
    with tempfile.TemporaryDirectory(prefix="repro_torch_eval_ckpt_") as ckpt:
        loop = TrainLoop(step, ckpt, ckpt_every=0, log_every=max(steps // 5, 1),
                         log_fn=log)
        state, history = loop.run(state, batches(), steps)
    log(f"[train] {len(history)} steps, loss {history[0]:.4f} -> "
        f"{history[-1]:.4f}")
    return state["params"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", "--arch", dest="model", default="nllb600m",
                    choices=sorted(REGISTRY))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, f32 compute (CPU-runnable)")
    ap.add_argument("--formats", default="bf16,int8,int4",
                    help="comma list of quantization specs: aliases "
                         f"({', '.join(sorted(ALIASES))}) and/or grammar "
                         "strings like w4a8kv8 / wfp8e4m3afp8kvfp8")
    ap.add_argument("--pairs", type=parse_pairs, default=None,
                    help="comma list of src-tgt directions (hin-eng,eng-hin);"
                         " default: --smoke 2 directions, else the full "
                         "bidirectional Indic<->overseas Fig. 9 grid")
    ap.add_argument("--n-sent", type=int, default=8,
                    help="held-out sentences per direction")
    ap.add_argument("--train-steps", type=int, default=None,
                    help="convergence-fit steps before evaluating "
                         "(default: 1500 under --smoke, else 0 = skip; "
                         "0 evaluates the random init — floor scores)")
    ap.add_argument("--train-batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    # serving knobs, mirrored from launch.serve
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=0,
                    help="engine decode budget; 0 = smallest power of two "
                         "covering lang-code prompt + reference length")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--horizon", type=int, default=1)
    ap.add_argument("--draft-spec", default=None, metavar="SPEC",
                    help="speculative-decoding draft arm for every "
                         "deployed format (same alias/grammar as "
                         "--formats); grids are token-identical by the "
                         "greedy-equivalence invariant, pair rows gain "
                         "an acceptance_rate column")
    ap.add_argument("--draft-lookahead", type=int, default=4)
    ap.add_argument("--no-overlap", action="store_true",
                    help="serve the grid with serial dispatch-then-walk "
                         "rounds (default: overlapped scheduler; grids "
                         "are token-identical either way)")
    ap.add_argument("--trace", action="store_true",
                    help="serve the grid with lifecycle tracing on: each "
                         "report row gains its round_phases column — "
                         "where serving time went, per scheduler phase "
                         "(grids are token-identical either way)")
    ap.add_argument("--impl", choices=IMPL_CHOICES, default=DEFAULT_IMPL)
    ap.add_argument("--calib-batches", type=int, default=4,
                    help="calibration batches for act-quantizing presets "
                         "(w8a8); 0 = dynamic per-token act quantization")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and serve on (the tests pass cpu)")
    # artifacts + gating
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the round-trip-guaranteed report JSON")
    ap.add_argument("--markdown", default=None, metavar="PATH",
                    help="also write the rendered markdown report")
    ap.add_argument("--parity-tol", type=float, default=0.1,
                    help="max allowed bf16->int8 mean-BLEU drop when both "
                         "formats run (negative disables the check)")
    args = ap.parse_args(argv)

    formats = [f.strip() for f in args.formats.split(",") if f.strip()]
    # fail on argument typos BEFORE the multi-minute training fit
    for f in formats:
        try:
            resolve_spec(f)
        except ValueError as e:
            raise SystemExit(f"bad --formats entry: {e}")
    if args.draft_spec is not None:
        try:
            resolve_spec(args.draft_spec)
        except ValueError as e:
            raise SystemExit(f"bad --draft-spec: {e}")
    pair_list = args.pairs if args.pairs is not None else (
        [("hin", "eng"), ("eng", "hin")] if args.smoke else fig9_pairs())
    bad = sorted({lang for p in pair_list for lang in p
                  if lang not in LANG_CODES})
    if bad:
        raise SystemExit(f"unknown languages {bad} in --pairs; "
                         f"have {sorted(LANG_CODES)}")
    same = [f"{s}-{t}" for s, t in pair_list if s == t]
    if same:
        raise SystemExit(f"--pairs needs two distinct languages, got {same}")
    langs = _ordered_langs(pair_list)
    cfg = get_config(args.model)
    if args.smoke:
        cfg = reduce_config(cfg)
    if cfg.family != "encdec":
        raise SystemExit(f"--model {args.model} is family {cfg.family!r}; "
                         "quality eval needs an enc-dec NMT model")
    train_steps = args.train_steps if args.train_steps is not None \
        else (1500 if args.smoke else 0)

    t0 = time.perf_counter()
    dev = training_device(args.device)
    if train_steps > 0:
        params = train_params(cfg, langs, steps=train_steps,
                              batch=args.train_batch, lr=args.lr,
                              seed=args.seed, device=dev)
    else:
        print("[train] skipped (--train-steps 0): evaluating the random "
              "init — scores are the task floor, not the paper's grid")
        params = build_model(cfg, dev).init(prng_key(args.seed, dev))

    def calib_batches_fn():
        ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len,
                                  seed=args.seed, languages=langs)
        return (_tensors(ds.sample(16), dev) for _ in range(args.calib_batches))

    gen = cfg.enc_len - 2
    max_len = args.max_len or _pow2_at_least(gen + 1)
    deploy_kwargs = dict(
        slots=args.slots, max_len=max_len, paged=args.paged,
        page_size=args.page_size, num_pages=args.num_pages,
        horizon=args.horizon, draft_spec=args.draft_spec,
        draft_lookahead=args.draft_lookahead, overlap=not args.no_overlap,
        ctx=Ctx(compute_dtype=torch.float32 if args.smoke else torch.bfloat16),
        device=dev, **impl_routes(args.impl))
    rows = quant_sweep(
        cfg, formats, params=params, pair_list=pair_list, languages=langs,
        n_sent=args.n_sent, seed=args.seed,
        calib_batches_fn=calib_batches_fn if args.calib_batches else None,
        deploy_kwargs=deploy_kwargs, trace=args.trace)
    dt = time.perf_counter() - t0

    report = make_report(
        arch=cfg.name,
        rows=[r.as_row() for r in rows],
        config={"formats": formats,
                "pairs": [f"{s}-{t}" for s, t in pair_list],
                "n_sent": args.n_sent, "seed": args.seed,
                "train_steps": train_steps, "train_batch": args.train_batch,
                "lr": args.lr, "slots": args.slots, "max_len": max_len,
                "paged": args.paged, "horizon": args.horizon,
                "overlap": not args.no_overlap,
                "draft_spec": args.draft_spec,
                "draft_lookahead": args.draft_lookahead,
                "impl": args.impl, "calib_batches": args.calib_batches,
                "trace": args.trace, "device": str(dev),
                "smoke": args.smoke, "wall_s": round(dt, 1)})
    print()
    print(render_markdown(report))
    if args.json:
        save(report, args.json)
        print(f"[report] wrote {args.json}")
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(render_markdown(report) + "\n")
        print(f"[report] wrote {args.markdown}")

    by_fmt = {r.fmt: r for r in rows}
    if args.parity_tol >= 0 and "bf16" in by_fmt and "int8" in by_fmt:
        drop = by_fmt["bf16"].mean_bleu - by_fmt["int8"].mean_bleu
        if drop > args.parity_tol:
            raise SystemExit(
                f"quality parity violated: int8 mean BLEU "
                f"{by_fmt['int8'].mean_bleu:.4f} is {drop:.4f} below bf16 "
                f"{by_fmt['bf16'].mean_bleu:.4f} (tol {args.parity_tol}) — "
                "the paper's sub-octet parity claim does not hold here")
        print(f"[parity] int8 within {drop:.4f} BLEU of bf16 "
              f"(tol {args.parity_tol}): OK")


if __name__ == "__main__":
    main()
