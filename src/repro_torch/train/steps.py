"""Loss and train-step factories (full training and QLoRA finetuning).

The reference's ``train/steps.py`` on the port's parameter trees.

Loss: the enc-dec and audio families' teacher-forced cross-entropy
against ``tgt_out`` with label smoothing 0.1; the LM families'
next-token cross-entropy (logits[:, :-1] against tokens[:, 1:], label
smoothing 0; a VLM with image embeddings scores the text-aligned slice
logits[:, P - 1:P + S - 1] against its unshifted tokens); each a masked
token mean in f32, plus the MoE load-balancing term weighted by
``cfg.moe.aux_loss_weight``.

Steps:
  * ``make_train_step`` — full AdamW training with optional microbatch
    gradient accumulation, per-layer activation recomputation
    (``remat``), 8-bit moments and bf16 live parameters with an f32
    master copy (``param_dtype``).
  * ``make_qlora_step`` — base weights stay quantized and frozen; only
    the LoRA adapters receive gradients and updates.

Both return ``(init_state, step)``; ``step`` takes and returns a state
dict laid out as the reference's. Parameters are the port's nested dicts
of tensors; the step sets ``requires_grad`` on its own detached view of
them, so a tree from ``convert.py`` trains as it is. Forward and backward
run through the plain torch routes, as the reference's training runs
through the XLA routes: the hand-written kernels have no backward, so a
context that routes through them is refused.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.qlora import extract_adapters, inject_adapters
from ..models.layers import Ctx
from ..optim import adamw_init, adamw_update
from ..tree import map_like

__all__ = ["compute_loss", "make_train_step", "make_qlora_step"]

_METRICS = ("loss", "aux_loss", "total_loss")


def _xent(logits, labels, mask, label_smoothing: float = 0.0):
    """Masked token-mean cross-entropy, f32. logits (B, S, V)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0:
        smooth = -torch.mean(logp, dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def compute_loss(ctx: Ctx, model, params, batch, *, remat: bool = False,
                 label_smoothing: Optional[float] = None):
    """(total, {"loss", "aux_loss", "total_loss"}) of one batch dict
    (numpy arrays or tensors; string entries are ignored). An LM batch's
    ``loss_mask`` defaults to ones."""
    cfg = model.cfg
    logits, aux = model.forward(ctx, params, batch, remat=remat)

    def on(key):
        return torch.as_tensor(batch[key], device=logits.device)

    if cfg.family in ("encdec", "audio"):
        ls = 0.1 if label_smoothing is None else label_smoothing
        loss = _xent(logits, on("tgt_out"), on("loss_mask"), ls)
    else:
        tokens = on("tokens")
        mask = on("loss_mask") if "loss_mask" in batch else torch.ones_like(
            tokens, dtype=torch.float32)
        if cfg.family == "vlm" and "img_embeds" in batch:
            P, S = batch["img_embeds"].shape[1], tokens.shape[1]
            # position P - 1 + i predicts text token i: already shifted
            logits = logits[:, P - 1:P + S - 1]
        else:
            logits, tokens, mask = logits[:, :-1], tokens[:, 1:], mask[:, 1:]
        ls = 0.0 if label_smoothing is None else label_smoothing
        loss = _xent(logits, tokens, mask, ls)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    total = loss + aux_w * aux
    return total, {"loss": loss, "aux_loss": aux, "total_loss": total}


def _check_training_ctx(ctx: Ctx) -> None:
    if ctx.matmul_impl != "torch" or ctx.use_fasst_kernel:
        raise ValueError(
            "training runs the plain torch routes (matmul_impl='torch', "
            "use_fasst_kernel=False): the qmm and FASST kernels have no "
            f"backward, in the reference or in the port; got {ctx}")


def _is_float(p) -> bool:
    return isinstance(p, torch.Tensor) and p.is_floating_point()


def _value_and_grad(loss_fn, tree):
    """(metrics, grads) of ``loss_fn(tree)``: gradients of every float
    leaf (zeros for an unused one, as JAX gives), None elsewhere."""
    live = map_like(lambda p: p.detach().requires_grad_() if _is_float(p) else p, tree)
    with torch.enable_grad():
        total, metrics = loss_fn(live)
    leaves = []
    map_like(lambda p: leaves.append(p) if _is_float(p) else None, live)
    gs = iter(torch.autograd.grad(total, leaves, allow_unused=True))

    def grad_of(p):
        if not _is_float(p):
            return None
        g = next(gs)
        return torch.zeros_like(p) if g is None else g

    grads = map_like(grad_of, live)
    return {k: v.detach() for k, v in metrics.items()}, grads


def _split_microbatches(batch, n: int):
    """One batch dict per microbatch (arrays split along the leading axis;
    entries that do not split, such as language names, are dropped)."""
    parts = [{} for _ in range(n)]
    for k, x in batch.items():
        if hasattr(x, "shape") and len(x.shape) >= 1 and x.shape[0] % n == 0:
            m = x.shape[0] // n
            for i in range(n):
                parts[i][k] = x[i * m:(i + 1) * m]
    return parts


def make_train_step(model, *, lr_fn, weight_decay=0.01, clip_norm=1.0,
                    state_bits=32, microbatches: int = 1, remat: bool = False,
                    label_smoothing: Optional[float] = None,
                    ctx: Optional[Ctx] = None, param_dtype=None):
    """Returns (init_state_fn, step_fn); step(state, batch) -> (state, metrics).

    param_dtype=torch.bfloat16 keeps live parameters in bf16 and an f32
    master copy and the moments in the optimizer state. Metrics are
    device tensors: the step reads nothing back to the host.
    """
    ctx = ctx or Ctx()
    _check_training_ctx(ctx)
    master = param_dtype is not None

    def init_state(params):
        if master:
            params = map_like(lambda p: p.to(param_dtype) if _is_float(p) else p, params)
        return {"params": params,
                "opt": adamw_init(params, state_bits=state_bits, master=master)}

    def loss_fn(batch):
        return lambda params: compute_loss(ctx, model, params, batch, remat=remat,
                                           label_smoothing=label_smoothing)

    def step(state, batch):
        params = state["params"]
        if microbatches > 1:
            grads = metrics = None
            for mb in _split_microbatches(batch, microbatches):
                m, g = _value_and_grad(loss_fn(mb), params)
                g = map_like(lambda x: None if x is None else x.to(torch.float32), g)
                if grads is None:
                    grads, metrics = g, m
                else:
                    grads = map_like(lambda a, b: None if a is None else a + b, grads, g)
                    metrics = {k: metrics[k] + m[k] for k in _METRICS}
            grads = map_like(lambda g: None if g is None else g / microbatches, grads)
            metrics = {k: v / microbatches for k, v in metrics.items()}
        else:
            metrics, grads = _value_and_grad(loss_fn(batch), params)

        lr = lr_fn(state["opt"]["step"])
        new_params, new_opt, om = adamw_update(
            grads, state["opt"], params, lr=lr, weight_decay=weight_decay,
            clip_norm=clip_norm, state_bits=state_bits)
        return {"params": new_params, "opt": new_opt}, dict(metrics, **om, lr=lr)

    return init_state, step


def make_qlora_step(model, *, lr_fn, clip_norm=1.0, remat=False,
                    label_smoothing=None, ctx: Optional[Ctx] = None):
    """QLoRA finetune step: gradients and updates on the adapters only.
    step(state, qparams, batch) -> (state, metrics); ``qparams`` (the
    quantized base with its adapters attached) is never modified."""
    ctx = ctx or Ctx()
    _check_training_ctx(ctx)

    def init_state(qparams):
        adapters = extract_adapters(qparams)
        return {"adapters": adapters, "opt": adamw_init(adapters, state_bits=32)}

    def step(state, qparams, batch):
        def loss_fn(adapters):
            p = inject_adapters(qparams, adapters)
            return compute_loss(ctx, model, p, batch, remat=remat,
                                label_smoothing=label_smoothing)

        metrics, grads = _value_and_grad(loss_fn, state["adapters"])
        lr = lr_fn(state["opt"]["step"])
        new_ad, new_opt, om = adamw_update(
            grads, state["opt"], state["adapters"], lr=lr, weight_decay=0.0,
            clip_norm=clip_norm)
        return {"adapters": new_ad, "opt": new_opt}, dict(metrics, **om, lr=lr)

    return init_state, step
