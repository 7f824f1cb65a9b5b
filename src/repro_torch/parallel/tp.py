"""The tensor-parallel serving engine's shard and collectives.

The design is SPMD: every rank of a ``("model",)`` mesh runs the same
host scheduler on the same requests, with a model of its own local
widths (``H / tp`` query heads, ``d_ff / tp`` FFN columns; ``d_model``
and the vocabulary unchanged) over its shard of the quantized weights.
It serves the text enc-dec and audio families and every decoder-only
family: dense, VLM, MoE, SSM and hybrid (nllb600m and its MoE variant,
whisper-base, gemma3, qwen2.5, internlm2, nemotron-4, llava-next, olmoe,
moonshot, mamba2, recurrentgemma). Only these places talk to the other
ranks:

* the control channel (:meth:`TPGroup.broadcast`): where an engine has
  an arm that reads a clock (``sla``, ``faults``, a request's
  ``deadline_ms``), each round boundary broadcasts rank 0's decisions
  (the requests it expired on its clock, its SLA observations since the
  last boundary) in one small f64 tensor, and every rank applies them
  there (``serving.engine``). An engine with no such arm runs none;

* every row-parallel product (a matmul site ending in ``.out``: the
  attention and FFN output projections; an SSM's and an RG-LRU's
  ``out_proj``, unlabelled, passed as ``row_split``) is summed over the
  ranks (``Ctx.dot``), a bias added once after the sum. w8a8's integer
  route sums its int32 products before their rescale, so its product is
  one device's, bit for bit;
* an act-quantizing spec's dynamic per-token scale at such a product:
  the rank holds a K slice of each row, so it takes its slice's absmax,
  the max over the ranks (:meth:`TPGroup.all_max`) gives the whole row's,
  and the rank quantizes its slice on that scale: one device's codes and
  scale, exactly. A static (calibrated) site and a column-parallel site
  (the whole row on every rank) take no collective, nor does the x<fmt>
  attention slot: each of its operands is quantized along ``head_dim``
  or the key axis of one head, both whole on the rank;
* calibration (``core.calibration``) runs on the rank's shard and merges
  the ranks' site tables by the same max, once, so every rank holds one
  device's table;
* a vocabulary-split embedding looks up the rows it holds, zeroes the
  rest and sums over the ranks (exact: one term is nonzero);
* the head computes the logits of the rank's vocabulary slice and
  gathers them by an all-reduce into a zero-filled buffer (exact: one
  term of each sum is nonzero; gloo's CUDA support covers all-reduce,
  not all-gather, so one path serves every backend). A prefill gathers
  only the rows the engine samples from (one a request), never the
  whole ``(B, S, V)``. A vocabulary that tp does not divide (whisper's
  51865) replicates, as the reference's rule does: the whole-table
  lookup and head run on every rank with no collective;
* an MoE layer's experts (expert parallelism, ``models.moe``): a rank
  holds ``E / tp`` of the stacked experts whole and keeps every FFN
  width (an expert is not split by width). Routing, capacity, dispatch
  and drops run on every rank on the same replicated activations, so
  every rank's buffer ``(G, E, C, d)`` is one device's; a rank runs its
  experts on its slice of the buffer and :meth:`TPGroup.gather` puts
  the ``(G, E / tp, C, d)`` outputs back together along E, after which
  the combine runs as on one device. Where tp does not divide E the
  stacks replicate and every rank runs every expert, with no
  collective. The router is replicated and reads all E;
* an SSM (Mamba-2) layer on the rank's SSD heads (``parallel.sharding``
  layout (e)): the conv and the recurrence run locally, the gated
  RMSNorm over the split ``d_inner`` sums each row's f32 sum of squares
  over the ranks (a norm over the rank's columns alone would be Mamba-2's
  grouped norm, another function), and ``out_proj``'s partial products
  are summed over the ranks;
* an RG-LRU layer on the rank's ``d_rec / tp`` channels (layout (f)): the
  conv output is gathered along channels before the gates, since a
  channel's gates read every channel (``w_rg`` / ``w_ig``; the rank holds
  their columns of its channels), and ``out_proj`` is summed over the
  ranks. The recurrent sites are unlabelled, as the reference leaves
  them, so these two sums are explicit in the model code, not a
  ``.out`` site's.

KV heads. Where tp divides ``Hkv`` a rank keeps ``Hkv / tp`` of them.
Where ``Hkv`` divides tp (gemma3's one KV head at tp2 and tp4, the
reduced configs' one KV head) each rank keeps the one KV head its query
heads read, and ``tp / Hkv`` ranks hold a copy of it: rank r's query
heads ``[r H/tp, (r+1) H/tp)`` lie in one GQA group (``G = H / Hkv`` is a
multiple of ``H / tp``), the group of KV head ``r // (tp / Hkv)``
(``parallel.sharding`` layout (d)). Attention then runs unchanged on the
local model with no collective, and the result is exact.

Any tp. Each sublayer splits where tp divides its width and is
replicated otherwise (``local_config``, the reference's rule of
splitting what the mesh divides): the attention where tp divides H and
``Hkv`` and tp divide one another, the FFN where tp divides ``d_ff``,
the RG-LRU where it divides ``d_rec``, the SSM where it divides the SSD
heads, the experts where it divides E. A rank holds a replicated
sublayer's weights whole (their scales, biases and adapters with them)
and runs it as one device does, under a ctx without the group
(``models.layers.rank_ctx``), so it takes no collective. A replicated
attention's dense self-attention cache splits its sequence instead,
where tp divides the cache's S (``max_len``; a hybrid's rolling buffer
W), as the reference's ``cache_shardings`` does: rank r holds rows
``[r S/tp, (r+1) S/tp)`` of every K/V leaf (``pos``, ``len`` and
``pos_roll`` stay whole), writes only those, and a decode step combines
the ranks' softmax partials (``models.layers.decode_attn_apply``): the
max over the ranks, then one sum of the packed denominators and PV
products, 2 collectives a layer (3 with an x<fmt> slot's dynamic PV
scale). Where tp does not divide S, the cache is whole on every rank.
A replicated attention's cross-attention cache and paged pool stay
whole (ROADMAP.md, queue 3).

After the gather every rank holds logits with the same bits, so the
sampler, retirement on eos or length, paging, preemption, admission
order and draft acceptance agree with no control channel; only what
reads a clock is rank 0's, through the channel. The paged allocator,
block tables and lengths stay host state on every rank, as in the
reference.

The sums run in f32: a bf16 partial product is widened, summed and
rounded once. A gather widens too (exact: every sum has one nonzero
term), and so does a max (exact).

QLoRA adapters split with their weights (``lora_a``'s K, ``lora_b``'s N),
so at a row-parallel site ``(x_r A_r) B`` is the rank's partial of
``(x A) B`` and rides the product's sum; ``lora_alpha / r`` is unchanged.
A speculative draft arm is sharded like the target (:func:`shard_params`)
and decodes through the same group; its acceptance reads the gathered
logits, the same bits on every rank.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch

from ..configs.base import ModelConfig, RankConfig
from ..core.qlinear import embed_lookup
from ..models.ssm import ssd_ranks
from .sharding import param_specs, shard_tree

__all__ = ["TPGroup", "tp_engine_parts", "shard_params", "refuse_under_mesh", "local_config",
           "replicated_kinds", "kv_replicas", "experts_per_rank", "ssd_heads"]


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
        """The sum of ``x`` over the ranks, in f32, cast back once; an
        integer ``x`` (w8a8's int32 products) sums in its own dtype,
        exactly."""
        if self.size == 1:
            return x
        y = (x.to(torch.float32) if x.is_floating_point() else x).contiguous()
        return self._sum(y.clone() if y.data_ptr() == x.data_ptr() else y).to(x.dtype)

    def _sum(self, y: torch.Tensor) -> torch.Tensor:
        """The contiguous f32 ``y`` summed over the ranks, in place."""
        import torch.distributed as dist
        dist.all_reduce(y, group=self.group)
        return y

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over the ranks, in f32, cast back
        once (exact)."""
        if self.size == 1:
            return x
        y = x.to(torch.float32).contiguous()
        return self._max(y.clone() if y.data_ptr() == x.data_ptr() else y).to(x.dtype)

    def _max(self, y: torch.Tensor) -> torch.Tensor:
        """The contiguous f32 ``y``'s elementwise max over the ranks, in place."""
        import torch.distributed as dist
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' slices of ``x`` along ``dim``, concatenated in rank
        order: each rank's slice written into f32 zeros and the buffers
        summed (one term of each sum is nonzero, so the bits are kept)."""
        if self.size == 1:
            return x
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.size
        out = x.new_zeros(shape, dtype=torch.float32)
        out.narrow(dim, self.rank * n, n).copy_(x)
        return self._sum(out).to(x.dtype)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Group rank 0's ``x`` on every rank of the group (the engine's
        control channel): one broadcast on the group's own process group
        (in a composed stack each replica is a group of its own), so
        every rank passes an ``x`` of the same shape and dtype. Under
        gloo it travels from host memory; under NCCL through the rank's
        card, and reading it back then waits for that card's stream."""
        if self.size == 1:
            return x
        import torch.distributed as dist
        wire = (torch.device("cuda", torch.cuda.current_device())
                if self.backend == "nccl" else torch.device("cpu"))
        y = x.to(wire, copy=True).contiguous()
        dist.broadcast(y, src=dist.get_global_rank(self.group, 0), group=self.group)
        return y.to(x.device)

    def embed(self, table: Any, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
        """Embedding rows of ``ids`` from a vocabulary-split table: the
        rank's rows looked up, the others zero, summed over the ranks."""
        rows = table.shape[0]
        local = ids.long() - self.rank * rows
        hit = (local >= 0) & (local < rows)
        x = embed_lookup(table, torch.where(hit, local, 0), compute_dtype)
        return self.all_reduce(torch.where(hit[..., None], x, torch.zeros_like(x)))


_MESH_FAMILIES = ("encdec", "audio", "dense", "vlm", "moe", "ssm", "hybrid")


def refuse_under_mesh(cfg, *, tp: Optional[int] = None) -> None:
    """Raise ValueError for what no mesh serves: a family the registry
    does not know, or a group of fewer than one rank. Every family serves
    at every tp (``local_config``), with every quantization arm and every
    arm that reads a clock (rank 0's clock decides, through the engine's
    control channel)."""
    if cfg.family not in _MESH_FAMILIES:
        raise ValueError(f"a tensor-parallel mesh for {cfg.name}: unknown family "
                         f"{cfg.family!r}, a mesh serves {_MESH_FAMILIES}")
    if tp is not None and tp < 1:
        raise ValueError(f"a tensor-parallel group needs at least one rank, got tp{tp}")


def ssd_heads(cfg) -> int:
    """An SSM config's SSD head count, ``expand * d_model / ssm.head_dim``
    (its ``num_heads`` is not read by the model)."""
    return cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim


def replicated_kinds(cfg, tp: int) -> tuple:
    """The sublayer kinds of ``cfg`` that ``tp`` ranks hold whole, the rest
    splitting: "attn" unless tp divides the query heads and ``Hkv`` and tp
    divide one another, "ffn" (a dense FFN) unless tp divides ``d_ff``,
    "rec" (a hybrid's RG-LRU) unless it divides ``d_rec``, "ssd" (an SSM)
    unless it divides the SSD heads. MoE experts follow
    ``experts_per_rank``; the vocabulary splits by shape."""
    if cfg.family == "ssm":
        return ("ssd",) if ssd_heads(cfg) % tp else ()
    H, hkv = cfg.num_heads, cfg.num_kv_heads
    rep = ()
    if H % tp or (hkv % tp and tp % hkv):
        rep += ("attn",)
    if cfg.moe is None and cfg.d_ff % tp:
        rep += ("ffn",)
    if cfg.family == "hybrid" and cfg.d_rec % tp:
        rep += ("rec",)
    return rep


def kv_replicas(cfg, tp: int) -> int:
    """How many ranks hold a copy of each KV head of a split attention: 1
    where tp divides ``Hkv`` (each rank its ``Hkv / tp``), ``tp / Hkv``
    where ``Hkv`` divides tp (each rank the one head its query heads
    read); 1 where the attention is replicated (every rank all of them)."""
    hkv = cfg.num_kv_heads
    if cfg.family == "ssm" or "attn" in replicated_kinds(cfg, tp):
        return 1
    return tp // hkv if hkv < tp and tp % hkv == 0 else 1


def local_config(cfg, tp: int) -> RankConfig:
    """The rank-local config (a ``RankConfig``): query heads and KV heads
    over ``tp`` (or the one KV head a rank's query heads read where
    ``Hkv`` divides tp), ``d_ff`` and a hybrid's ``d_rec`` over ``tp``,
    each where it splits (``replicated_kinds``) and whole where it does
    not. An MoE config keeps ``d_ff`` whole (every FFN is an expert, and
    experts are not split by width) and ``moe.num_experts`` global (the
    router reads all E). An SSM config keeps its fields: the rank-local
    widths of split SSD heads come from the group (``models.ssm._dims``,
    ``models.ssm.ssd_ranks``), since the config's fields mirror the
    reference's."""
    rep = replicated_kinds(cfg, tp)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    if cfg.family != "ssm":
        if "attn" not in rep:
            fields.update(num_heads=cfg.num_heads // tp,
                          num_kv_heads=max(cfg.num_kv_heads // tp, 1))
        if cfg.moe is None and "ffn" not in rep:
            fields["d_ff"] = cfg.d_ff // tp
        if "rec" not in rep:
            fields["d_rec"] = cfg.d_rec // tp
    return RankConfig(**fields, tp=tp, replicated=rep)


def tp_engine_parts(model, params, ctx, mesh, device):
    """(local model, local params, ctx with the group) of this rank's
    engine: the reference's ``fsdp_scope="none"`` specs on the mesh, one
    shard per rank, checked against the local widths."""
    from ..models import Ctx, build_model
    cfg = model.cfg
    refuse_under_mesh(cfg)
    group = TPGroup.of(mesh)
    lc = local_config(cfg, group.size)
    lmodel = build_model(lc, device)
    ctx = ctx if ctx is not None else Ctx()
    return lmodel, shard_params(params, cfg, lmodel, group), dataclasses.replace(ctx, tp=group)


def shard_params(params, cfg, lmodel, group: TPGroup):
    """The rank's shard of the whole (quantized) tree ``params`` of
    ``cfg``, checked against the rank-local model ``lmodel``: the
    target's weights, and a draft arm's (the same checkpoint quantized
    again), placed alike. A replicated sublayer's leaves come whole."""
    tp = group.size
    rep = replicated_kinds(cfg, tp)
    specs = {path: () if _SUBLAYER_KIND.get(_sublayer(path)) in rep else spec
             for path, spec in param_specs(params, {"model": tp}, fsdp_scope="none").items()}
    shard = shard_tree(params, specs, group.rank, {"model": tp},
                       kv_replicas=kv_replicas(cfg, tp),
                       recurrent=not {"rec", "ssd"} & set(rep))
    _check_widths(shard, lmodel, cfg, tp)
    return shard


# the param dicts of each sublayer kind (``replicated_kinds``)
_SUBLAYER_KIND = {"attn": "attn", "cross": "attn", "mlp": "ffn", "rglru": "rec", "ssm": "ssd"}


def _sublayer(path: str) -> Optional[str]:
    """The innermost param dict of ``_SUBLAYER_KIND`` a leaf's path runs
    through, or None."""
    found = re.findall(r"\['(attn|cross|mlp|rglru|ssm)'\]", path)
    return found[-1] if found else None


def experts_per_rank(cfg, tp: int) -> int:
    """The experts a rank holds: ``E / tp``, or all E where tp does not
    divide E (the reference's rule replicates the stacks)."""
    E = cfg.moe.num_experts
    return E // tp if E % tp == 0 else E


def _check_widths(shard, lmodel, cfg, tp: int) -> None:
    """Every projection of the shard has the local model's widths (a
    replicated sublayer's whole), every expert stack ``E / tp`` experts
    (or all E, replicated) of the whole widths, and every SSM and RG-LRU
    leaf its layout's (e) / (f) widths, or whole where replicated."""
    lc = lmodel.cfg
    hd, d = lc.head_dim, cfg.d_model
    expect = {None: {"wq": (d, lc.num_heads * hd), "wk": (d, lc.num_kv_heads * hd),
                     "wv": (d, lc.num_kv_heads * hd), "wo": (lc.num_heads * hd, d),
                     "w_in": (d, lc.d_ff), "w_out": (lc.d_ff, d)}}
    if cfg.moe is not None:
        e, ff = experts_per_rank(cfg, tp), cfg.d_ff
        expect["experts"] = {n: (e, d, ff) for n in ("w_gate", "w_up", "w_in")}
        expect["experts"].update({n: (e, ff, d) for n in ("w_down", "w_out")})
    if cfg.family == "ssm":
        n = ssd_ranks(lc)
        di, ds, nh = cfg.ssm.expand * d // n, cfg.ssm.state_dim, ssd_heads(cfg) // n
        expect["ssm"] = {"in_proj": (d, 2 * di + 2 * ds + nh), "out_proj": (di, d),
                         "conv_w": (4, di + 2 * ds)}
    if cfg.family == "hybrid":
        r, rl = cfg.d_rec, lc.d_rec
        expect["rglru"] = {"gate_proj": (d, rl), "in_proj": (d, rl), "w_rg": (r, rl),
                           "w_ig": (r, rl), "out_proj": (rl, d)}

    def walk(node, keys):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + (k,))
            return
        name = keys[-1] if keys else None
        mixer = next((m for m in ("experts", "ssm", "rglru") if m in keys[:-1]), None)
        want = expect.get(mixer, {}).get(name)
        if want is not None and tuple(node.shape[-len(want):]) != want:
            raise ValueError(f"{cfg.name}'s {'.'.join(keys)} {tuple(node.shape[-len(want):])} "
                             f"does not split into the local widths {want}")

    walk(shard, ())
