"""Mixture-of-Experts FFN (the paper's Fig. 3b MoE layer, and the MoE LMs).

Top-k gating with a load-balancing auxiliary loss and a sort-based
capacity dispatch of static shape, as in the reference:

  1. every token emits top_k (expert, weight) assignments, routed in f32;
  2. assignments are sorted by expert id (a stable sort); a token's rank
     within its expert is its sorted offset minus the expert's start;
  3. assignments past an expert's capacity C are dropped (routed to a
     trash row);
  4. the experts' FFNs run as batched products over the (G, E, C, d)
     buffer, their activation through ``ctx.naf`` (the FASST kernel when
     it is on);
  5. each token sums its gate-weighted rows.

Dispatch is group-local: tokens sort within ``dispatch_groups`` leading
batch groups (one group per row up to 32 rows), so capacity is counted
per sequence, pad tokens included.

Expert parallelism (a tensor-parallel engine's rank, ``Ctx.tp``): the
rank holds ``E_l = E / tp`` of the stacked experts whole
(``parallel.sharding``), ranks ``[r E_l, (r+1) E_l)``. Everything up to
the buffer (routing, capacity, dispatch, drops) runs on every rank on the
same replicated activations, so every rank's ``(G, E, C, d)`` buffer is
one device's. The rank runs its experts on its ``E_l`` slice of the
buffer, and ``TPGroup.gather`` concatenates the ranks' ``(G, E_l, C, d)``
outputs along E, exactly; the combine below then runs as on one device.
Summing per-rank partial combines instead would reorder each token's
sum. Under the reference's ``("model",)`` serving mesh its sharding
hints compute the same: E-local experts, gathered back to replicated.
``parallel_mode`` ("expert" or "tensor") places and computes the same
here, as in the reference's serving engine, which places every
parameter with the default expert mode. Where tp does not divide E the
stacks replicate and a rank runs every expert.

The combine gathers each token's rows through the inverse of the sort
permutation and adds them in the order of the sorted assignments
(ascending expert id), from zeros in the compute dtype, as the
reference's scatter-add applies them. It uses no atomics, so two runs
give the same bits on the card.
"""

from __future__ import annotations

import torch

from ..core.qtensor import maybe_dequantize
from .layers import GLU_ACTS, Ctx, draw_sources, mlp, normal_init, rank_ctx

__all__ = ["moe_init", "moe_apply", "route", "capacity", "layer_ffn"]

_PARALLEL_MODES = ("expert", "tensor")


def moe_init(g, d_model: int, d_ff: int, num_experts: int, act: str, layers=None):
    """MoE parameters with the reference's shapes and scales: ``router``
    (d, E) f32 and the expert stacks (E, d, ff) / (E, ff, d), stacked on
    a leading ``layers`` axis (unstacked for None).

    ``g`` is a torch.Generator (draws on its device) or a key from
    ``random.prng_key`` / ``random.split``: the reference's own 4-way
    split and normal draws for that key, one layer."""
    E, d, ff = num_experts, d_model, d_ff
    s_in, s_out = d ** -0.5, ff ** -0.5
    glu = act in GLU_ACTS
    names = ("w_gate", "w_up", "w_down") if glu else ("w_in", "w_out")
    shapes = [(E, d, ff)] * (len(names) - 1) + [(E, ff, d)]
    scales = [s_in] * (len(names) - 1) + [s_out]
    lead = () if layers is None else (layers,)
    k1, *ks = draw_sources(g, 4)
    return {"router": normal_init(k1, lead + (d, E), s_in),
            "experts": {n: normal_init(k, lead + sh, s)
                        for n, k, sh, s in zip(names, ks, shapes, scales)}}


def _expert_ffn(ctx: Ctx, experts, buf, act: str):
    """buf (G, E, C, d) -> (G, E, C, d): each expert's FFN over its C rows,
    on the dequantized expert stacks, in the compute dtype."""
    cd = ctx.compute_dtype
    buf = buf.to(cd)
    if "w_gate" in experts:
        wg, wu, wd = (maybe_dequantize(experts[n], cd) for n in ("w_gate", "w_up", "w_down"))
        h = ctx.naf(torch.einsum("gecd,edf->gecf", buf, wg), GLU_ACTS[act])
        h = h * torch.einsum("gecd,edf->gecf", buf, wu)
        return torch.einsum("gecf,efd->gecd", h.to(cd), wd)
    wi, wo = (maybe_dequantize(experts[n], cd) for n in ("w_in", "w_out"))
    h = ctx.naf(torch.einsum("gecd,edf->gecf", buf, wi), act)
    return torch.einsum("gecf,efd->gecd", h.to(cd), wo)


def _local_experts(ctx: Ctx, experts, buf, act: str):
    """buf (G, E, C, d) -> (G, E, C, d) where the stacks hold all E
    experts; a tensor-parallel rank holding ``E_l < E`` of them runs its
    slice ``[r E_l, (r+1) E_l)`` of the buffer and gathers the ranks'
    outputs along E (the module docstring)."""
    E, E_l = buf.shape[1], next(iter(experts.values())).shape[-3]
    if E_l == E:
        return _expert_ffn(ctx, experts, buf, act)
    if ctx.tp is None or E_l * ctx.tp.size != E:
        raise ValueError(f"{E_l} of {E} experts need a tensor-parallel group of "
                         f"{E // E_l} ranks, got {ctx.tp}")
    r = ctx.tp.rank
    return ctx.tp.gather(_expert_ffn(ctx, experts, buf[:, r * E_l:(r + 1) * E_l], act), dim=1)


def _pick_groups(B: int, target: int = 32) -> int:
    """Largest divisor of B not exceeding ``target``."""
    g = min(target, B)
    while g > 1 and B % g:
        g -= 1
    return max(g, 1)


def route(router, xt, top_k: int):
    """f32 routing of tokens xt (G, Tg, d): (probs (G, Tg, E), gate weights
    (G, Tg, k) renormalized, expert ids (G, Tg, k)). The top k are taken
    by a stable descending sort, so a tie goes to the lower expert id, as
    ``jax.lax.top_k`` gives it."""
    logits = torch.einsum("gtd,de->gte", xt.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = w[..., :top_k], e[..., :top_k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_w, gate_e


def capacity(Tg: int, top_k: int, E: int, capacity_factor: float, dropless: bool) -> int:
    """Rows per expert and group: the reference's expression, Python's
    round (half to even) included; every token when ``dropless``."""
    if dropless:
        return Tg
    return int(max(1, round(Tg * top_k / E * capacity_factor)))


def _dispatch(flat_e, E: int, C: int):
    """Assignments' expert ids (G, TK) -> (order: the stable sort by
    expert id, buf_idx: each sorted assignment's buffer row, its expert's
    block of C rows at its rank there, or the trash row E * C past the
    capacity)."""
    TK = flat_e.shape[1]
    order = torch.argsort(flat_e, dim=1, stable=True)
    e_sorted = torch.gather(flat_e, 1, order)
    counts = torch.nn.functional.one_hot(flat_e, E).sum(dim=1)         # (G, E)
    starts = torch.cumsum(counts, dim=1) - counts
    pos_in_e = torch.arange(TK, device=flat_e.device)[None] - torch.gather(starts, 1, e_sorted)
    return order, torch.where(pos_in_e < C, e_sorted * C + pos_in_e, E * C)


def moe_apply(ctx: Ctx, params, x, *, top_k: int, capacity_factor: float = 1.25,
              act: str = "silu_glu", parallel_mode: str = "expert",
              dropless: bool = False, dispatch_groups: int = 0):
    """x (B, S, d) -> (y (B, S, d), aux_loss f32 scalar).

    ``dropless`` sets C = Tg (no assignment dropped): the decode steps use
    it, so train and serve routing agree."""
    if parallel_mode not in _PARALLEL_MODES:
        raise ValueError(f"parallel_mode must be one of {_PARALLEL_MODES}, "
                         f"got {parallel_mode!r}")
    B, S, d = x.shape
    E = params["router"].shape[-1]
    G = dispatch_groups or _pick_groups(B)
    Tg = B * S // G
    cd = ctx.compute_dtype
    dev = x.device
    xt = x.reshape(G, Tg, d)

    probs, gate_w, gate_e = route(params["router"], xt, top_k)
    # load-balancing aux loss (Switch / GShard form)
    me = probs.mean(dim=(0, 1))
    counts_tok = torch.nn.functional.one_hot(gate_e, E).to(torch.float32).sum(dim=2)
    ce = counts_tok.mean(dim=(0, 1)) / top_k
    aux = E * torch.sum(me * ce)

    # group-local sort-based capacity dispatch
    C = capacity(Tg, top_k, E, capacity_factor, dropless)
    TK = Tg * top_k
    order, buf_idx = _dispatch(gate_e.reshape(G, TK), E, C)
    t_sorted = order // top_k                                          # token of each
    w_sorted = torch.gather(gate_w.reshape(G, TK), 1, order)

    # the trash row takes every dropped assignment and is sliced off
    buf = torch.zeros((G, E * C + 1, d), dtype=cd, device=dev)
    src = torch.gather(xt.to(cd), 1, t_sorted[..., None].expand(G, TK, d))
    buf.scatter_(1, buf_idx[..., None].expand(G, TK, d), src)
    out_buf = _local_experts(ctx, params["experts"], buf[:, :E * C].reshape(G, E, C, d), act)

    # combine: a token's k rows, through the inverse permutation, in the
    # order of the sorted assignments; the appended zero row is the trash
    rows = torch.cat([out_buf.reshape(G, E * C, d),
                      torch.zeros((G, 1, d), dtype=out_buf.dtype, device=dev)], dim=1)
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(TK, device=dev).expand(G, TK))
    pos = torch.sort(inv.reshape(G, Tg, top_k), dim=-1).values.reshape(G, TK)
    idx_tok = torch.gather(buf_idx, 1, pos)
    w_tok = torch.gather(w_sorted, 1, pos).to(rows.dtype)
    contrib = (torch.gather(rows, 1, idx_tok[..., None].expand(G, TK, d))
               * w_tok[..., None]).reshape(G, Tg, top_k, d)
    y = torch.zeros((G, Tg, d), dtype=cd, device=dev)
    for r in range(top_k):
        y = y + contrib[:, :, r]
    return y.reshape(B, S, d), aux


def layer_ffn(ctx: Ctx, cfg, lp, h, site: str = "ffn", dropless: bool = False):
    """A layer's FFN: (y, aux). An MoE layer (``cfg.moe``) dispatches
    with capacity, or dropless (the decode steps); a dense FFN's aux is
    None (a rank holding it whole runs it with no collective,
    ``rank_ctx``)."""
    if cfg.moe is None:
        return mlp(rank_ctx(ctx, cfg, "ffn"), lp["mlp"], h, cfg.mlp_act, site=site), None
    m = cfg.moe
    return moe_apply(ctx, lp["moe"], h, top_k=m.top_k, capacity_factor=m.capacity_factor,
                     act=cfg.mlp_act, parallel_mode=m.parallel_mode, dropless=dropless,
                     dispatch_groups=m.dispatch_groups)
