"""Training launcher: any arch of the registry on synthetic data (the
enc-dec and audio families on the translation task, the LMs on the
``SyntheticLM`` stream).

  python -m repro_torch.launch.train --steps 200 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 20 --ckpt-dir build/train_ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b --smoke \\
      --device cpu --steps 3

The reference launcher's flags plus ``--device`` (default ``cuda``, which
raises without a card). The step runs the plain torch routes (the
kernels have no backward).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import REGISTRY, get_config, reduce_config
from ..data import SyntheticLM, SyntheticTranslation
from ..models import Ctx, build_model
from ..optim import warmup_cosine
from ..random import prng_key
from ..train import TrainLoop, make_train_step

__all__ = ["main", "batches_for", "training_device"]


def training_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on the CUDA device and none is "
                           "available; pass --device cpu to train on the CPU")
    return dev


def batches_for(cfg, batch: int, seq: int, seed: int = 0, device="cpu"):
    """Endless batches as tensors on ``device``: SyntheticTranslation for
    the enc-dec and audio families, ``{"tokens"}`` from SyntheticLM for
    an LM, as the reference's launcher yields them."""
    if cfg.family in ("encdec", "audio"):
        ds = SyntheticTranslation(cfg.vocab_size, min(seq, cfg.enc_len or seq), seed)
        while True:
            b = ds.sample(batch)
            yield {k: torch.as_tensor(v, device=device) for k, v in b.items()
                   if not isinstance(v, str)}
    lm = SyntheticLM(cfg.vocab_size, seq, seed)
    while True:
        yield {"tokens": torch.as_tensor(lm.sample(batch)["tokens"], device=device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="nllb600m", choices=sorted(REGISTRY))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, f32 compute (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--state-bits", type=int, default=32, choices=(8, 32))
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (the tests pass cpu)")
    args = ap.parse_args(argv)

    dev = training_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    model = build_model(cfg, dev)
    ctx = Ctx(compute_dtype=torch.float32 if args.smoke else torch.bfloat16)
    init_state, step = make_train_step(
        model, lr_fn=lambda s: warmup_cosine(s, peak_lr=args.lr, warmup=10,
                                             total=args.steps),
        microbatches=args.microbatches, remat=args.remat,
        state_bits=args.state_bits, ctx=ctx)

    loop = TrainLoop(step, args.ckpt_dir, ckpt_every=args.ckpt_every)
    state = init_state(model.init(prng_key(0, dev)))     # the reference's init
    state, start = loop.maybe_resume(state)
    state, history = loop.run(state, batches_for(cfg, args.batch, args.seq, device=dev),
                              args.steps, start_step=start)
    if history:
        print(f"done: {len(history)} steps, loss {history[0]:.4f} -> "
              f"{history[-1]:.4f}, stragglers={loop.stragglers}")
    else:
        print(f"done: nothing to run (resumed at step {start} of {args.steps})")


if __name__ == "__main__":
    main()
