"""The tensor-parallel serving engine's shard and collectives.

The design is SPMD: every rank of a ``("model",)`` mesh runs the same
host scheduler on the same requests, with a model of its own local
widths (``H / tp`` query heads, ``d_ff / tp`` FFN columns; ``d_model``
and the vocabulary unchanged) over its shard of the quantized weights.
It serves the text enc-dec family and the decoder-only dense and VLM
families (gemma3, qwen2.5, internlm2, nemotron-4, llava-next). Only three
places talk to the other ranks:

* every row-parallel product (a matmul site ending in ``.out``: the
  attention and FFN output projections) is summed over the ranks
  (``Ctx.dot``), a bias added once after the sum;
* a vocabulary-split embedding looks up the rows it holds, zeroes the
  rest and sums over the ranks (exact: one term is nonzero);
* the head computes the logits of the rank's vocabulary slice and
  gathers them by an all-reduce into a zero-filled buffer (exact: one
  term of each sum is nonzero; gloo's CUDA support covers all-reduce,
  not all-gather, so one path serves every backend). A prefill gathers
  only the rows the engine samples from (one a request), never the
  whole ``(B, S, V)``.

KV heads. Where tp divides ``Hkv`` a rank keeps ``Hkv / tp`` of them.
Where ``Hkv`` divides tp (gemma3's one KV head at any tp, the reduced
configs' one KV head) each rank keeps the one KV head its query heads
read, and ``tp / Hkv`` ranks hold a copy of it: rank r's query heads
``[r H/tp, (r+1) H/tp)`` lie in one GQA group (``G = H / Hkv`` is a
multiple of ``H / tp``), the group of KV head ``r // (tp / Hkv)``
(``parallel.sharding`` layout (d)). Attention then runs unchanged on the
local model with no collective, and the result is exact. The reference's
GSPMD layout splits such a dense cache's sequence (a paged pool's head
dim) instead; the port does not, since its gate is the streams and the
sequence split would add a cross-rank softmax combine to every layer.
Any other ``Hkv`` (neither divides the other) raises, naming the later
slice that brings the sequence split.

After the gather every rank holds logits with the same bits, so the
sampler, retirement and paging decisions agree with no control channel.
The paged allocator, block tables and lengths stay host state on every
rank, as in the reference.

The sums run in f32: a bf16 partial product is widened, summed and
rounded once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..core.qlinear import embed_lookup
from ..core.qtensor import QTensor
from ..unported import later
from .sharding import param_specs, shard_tree

__all__ = ["TPGroup", "tp_engine_parts", "refuse_under_mesh", "local_config", "kv_replicas"]


class TPGroup:
    """One rank's view of a tensor-parallel group: the process group, the
    rank within it, its size and the backend."""

    def __init__(self, group, rank: int, size: int, backend: str):
        self.group, self.rank, self.size, self.backend = group, rank, size, backend

    @classmethod
    def of(cls, mesh) -> "TPGroup":
        import torch.distributed as dist
        group = mesh.get_group()
        return cls(group, mesh.get_local_rank(), mesh.size(), str(dist.get_backend(group)))

    def __repr__(self) -> str:
        return f"TPGroup(rank {self.rank} of {self.size}, {self.backend})"

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, in f32, cast back once."""
        if self.size == 1:
            return x
        import torch.distributed as dist
        y = x.to(torch.float32).contiguous()
        if y.data_ptr() == x.data_ptr():
            y = y.clone()
        dist.all_reduce(y, group=self.group)
        return y.to(x.dtype)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' slices of the last dim, concatenated in rank order."""
        if self.size == 1:
            return x
        import torch.distributed as dist
        n = x.shape[-1]
        out = x.new_zeros(*x.shape[:-1], n * self.size)
        out[..., self.rank * n:(self.rank + 1) * n] = x
        dist.all_reduce(out, group=self.group)
        return out

    def embed(self, table: Any, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
        """Embedding rows of ``ids`` from a vocabulary-split table: the
        rank's rows looked up, the others zero, summed over the ranks."""
        rows = table.shape[0]
        local = ids.long() - self.rank * rows
        hit = (local >= 0) & (local < rows)
        x = embed_lookup(table, torch.where(hit, local, 0), compute_dtype)
        return self.all_reduce(torch.where(hit[..., None], x, torch.zeros_like(x)))


_MESH_FAMILIES = ("encdec", "dense", "vlm")


def refuse_under_mesh(cfg, *, tp: Optional[int] = None, act_fmt: str = "bf16",
                      attn_fmt: str = "bf16", calibrated: bool = False,
                      adapters: bool = False, draft: bool = False, sla: bool = False,
                      faults: bool = False) -> None:
    """Raise, naming the later slice, for what a mesh does not serve yet:
    a family other than the text enc-dec and the dense and VLM LMs (MoE
    expert parallelism, the SSM, hybrid and audio meshes), a KV-head
    count that neither divides ``tp`` nor is divided by it (when ``tp``
    is given), act-quantizing specs and calibration (a per-token absmax
    over a split K needs an all-reduce max), QLoRA adapters (their
    ``lora_a`` K splits too), a draft arm, and what reads a clock (SLA
    admission, fault injection: the ranks' clocks differ)."""
    if cfg.family not in _MESH_FAMILIES or cfg.moe is not None:
        what = f"{cfg.name} ({cfg.family}{', MoE' if cfg.moe else ''})"
        raise later(f"a tensor-parallel mesh for {what}: the port shards the text "
                    "enc-dec and the dense and VLM LM families", 6)
    if tp is not None:
        local_config(cfg, tp)
    for on, what in ((act_fmt != "bf16" or attn_fmt != "bf16",
                      "an act-quantizing spec under a mesh (its per-token absmax "
                      "over a split K needs an all-reduce max)"),
                     (calibrated, "calib_batches under a mesh"),
                     (adapters, "QLoRA adapters under a mesh (lora_a's K splits too)"),
                     (draft, "a speculative draft arm under a mesh"),
                     (sla, "sla= under a mesh (it reads the clock, and the ranks' "
                           "clocks differ)"),
                     (faults, "faults= under a mesh (clock skew and injection "
                              "rounds read the clock)")):
        if on:
            raise later(what, 6)


def kv_replicas(cfg, tp: int) -> int:
    """How many ranks hold a copy of each KV head: 1 where tp divides
    ``Hkv`` (each rank its ``Hkv / tp``), ``tp / Hkv`` where ``Hkv``
    divides tp (each rank the one head its query heads read)."""
    hkv = cfg.num_kv_heads
    return tp // hkv if hkv < tp and tp % hkv == 0 else 1


def local_config(cfg, tp: int):
    """The rank-local config: query heads and FFN width over ``tp``; KV
    heads over ``tp``, or the one KV head a rank's query heads read
    where ``Hkv`` divides tp (the module docstring)."""
    for name in ("num_heads", "d_ff"):
        if getattr(cfg, name) % tp:
            raise later(f"{cfg.name}'s {name} {getattr(cfg, name)} over tp{tp}, which "
                        "does not divide it", 6)
    hkv = cfg.num_kv_heads
    if hkv % tp and tp % hkv:
        raise later(f"{cfg.name}'s num_kv_heads {hkv} over tp{tp} (neither divides the "
                    "other: the reference's sequence split)", 6)
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=max(hkv // tp, 1), d_ff=cfg.d_ff // tp)


def _has_adapters(params) -> bool:
    if isinstance(params, dict):
        return any(_has_adapters(v) for v in params.values())
    return isinstance(params, QTensor) and params.lora_a is not None


def tp_engine_parts(model, params, ctx, mesh, device, draft=None, sla=None, faults=None):
    """(local model, local params, ctx with the group) of this rank's
    engine: the reference's ``fsdp_scope="none"`` specs on the mesh, one
    shard per rank, checked against the local widths."""
    from ..models import Ctx, build_model
    ctx = ctx if ctx is not None else Ctx()
    cfg = model.cfg
    refuse_under_mesh(cfg, act_fmt=ctx.act_fmt, attn_fmt=ctx.attn_act_fmt,
                      calibrated=ctx.act_scales is not None,
                      adapters=_has_adapters(params), draft=draft is not None,
                      sla=sla is not None, faults=faults is not None)
    group = TPGroup.of(mesh)
    local = local_config(cfg, group.size)
    specs = param_specs(params, {"model": group.size}, fsdp_scope="none")
    shard = shard_tree(params, specs, group.rank, {"model": group.size},
                       kv_replicas=kv_replicas(cfg, group.size))
    lmodel = build_model(local, device)
    _check_widths(shard, lmodel, cfg)
    return lmodel, shard, dataclasses.replace(ctx, tp=group)


def _check_widths(shard, lmodel, cfg) -> None:
    """Every projection of the shard has the local model's widths: a
    weight that the reference's rules would replicate (a dim the mesh
    does not divide) cannot serve in a split model."""
    lc = lmodel.cfg
    hd = lc.head_dim
    expect = {"wq": (cfg.d_model, lc.num_heads * hd), "wk": (cfg.d_model, lc.num_kv_heads * hd),
              "wv": (cfg.d_model, lc.num_kv_heads * hd), "wo": (lc.num_heads * hd, cfg.d_model),
              "w_in": (cfg.d_model, lc.d_ff), "w_out": (lc.d_ff, cfg.d_model)}

    def walk(node, name: Optional[str]):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif name in expect and tuple(node.shape[-2:]) != expect[name]:
            raise later(f"{cfg.name}'s {name} {tuple(node.shape[-2:])} does not split into "
                        f"the local widths {expect[name]}", 6)

    walk(shard, None)
