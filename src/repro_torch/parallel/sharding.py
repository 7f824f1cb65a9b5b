"""Logical sharding rules and the slicing of one rank's shard.

The reference (``repro/parallel/sharding.py``) gives every leaf of a
parameter tree, a decode cache, a paged pool or a batch a
``PartitionSpec`` and lets GSPMD place it. The port keeps the same rules
as pure functions over its tree paths (``tree.keystr`` spells a path as
``jax.tree_util.keystr`` does; a QTensor child adds ``.data``,
``.scales``, ...), and returns each spec as a tuple: one entry per dim,
``None``, an axis name or a tuple of names, and ``()`` for a replicated
leaf, as ``tuple(PartitionSpec(...))`` reads.

A mesh is anything with axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh``, an object with
``axis_names`` and a ``shape`` mapping (a jax ``Mesh``, the reference
tests' ``_FakeMesh``) or a mapping of name to size. "pod" and "data" form
the data-parallel domain, "model" the tensor-parallel one.

The port's tensor parallelism is explicit SPMD (``parallel.tp``): every
rank runs a model of its own local widths, and the model sums its
row-parallel products over the ranks where they are computed. So the
reference's ``set_mesh`` / ``hint`` / ``hint_pick`` (GSPMD constraints
inside model code) have no counterpart here.

:func:`shard_tree` slices one rank's shard by these specs. The stacked
experts ``(L, E, d, ff)`` / ``(L, E, ff, d)`` take the expert axis (the
reference's default ``expert_mode="expert"``; "tensor" mode places the
same in its serving engine): rank r holds experts ``[r E/tp, (r+1)
E/tp)`` whole, their scales with them, and where tp does not divide E
the stacks replicate. Four layouts differ from the reference's on
purpose:

(a) A QTensor's scales (and QLoRA adapters) and a projection's bias
    (``bias_q`` beside ``wq``) follow their weight's split. The reference
    replicates them and lets GSPMD slice them; a kernel needs its local
    scales.
(b) A row-parallel cut may fall inside a quantization block (smoke-size
    ``w_out``: K 96 in one block, cut at 48 by two ranks). The shard then
    takes the finer sub-block ``gcd(block, K_local)``, and every
    sub-block inherits its parent block's scale: the dequantized values
    are the same, with no re-quantization. 4-bit codes are packed two per
    byte along K, so K_local must be even.
(c) A double-quantized weight (``nf4``) packs its scales in flattened
    256-value chunks that no split respects. Its scales are decoded once
    to f32 (``QTensor.block_scales()``) before slicing, so the shard holds
    f32 scales: 4 bytes a block where the packed scales took about 1.
(d) KV-head replication (``kv_replicas`` > 1: ``Hkv`` divides tp and is
    smaller, e.g. gemma3's one KV head). ``wk`` and ``wv``, their scales
    and ``bias_k`` / ``bias_v`` give rank r the columns of KV head
    ``r // kv_replicas`` whole, where the reference's even column split
    would cut a head across ranks; ``kv_replicas`` ranks hold each head
    (``parallel.tp``). ``q_norm`` / ``k_norm`` (``(head_dim,)``) replicate,
    as every 1-D leaf does.
(e) The SSM (Mamba-2; ``recurrent`` on). Rank r holds SSD heads ``[r nh/tp,
    (r+1) nh/tp)``. The packed ``in_proj`` columns (z, x, B, C, dt) give it
    its heads' z and x columns, all of B and C (one group: every head reads
    them) and its heads' dt columns, in that order, where the reference's
    even column split would cut across segments; ``conv_w`` / ``conv_bias``
    its heads' x channels and all of B and C; ``a_log``, ``dt_bias`` and
    ``D`` its heads; ``norm_scale`` its ``d_inner`` columns; ``out_proj``
    its rows (the reference's split). The scales follow (a). The engine's
    conv state keeps the same channels (x's heads, B and C whole), not the
    reference cache rule's even split of ``conv_dim``; its SSD state takes
    the rank's heads, as the reference's does.
(f) The RG-LRU (``recurrent`` on). ``gate_proj`` / ``in_proj`` columns,
    ``conv_w`` / ``conv_bias`` / ``a_param`` and ``out_proj`` rows split by
    channel; ``w_rg`` and ``w_ig``, which the reference replicates, give
    rank r their columns ``[r d_rec/tp, (r+1) d_rec/tp)``: the gates of its
    channels, computed from the whole (gathered) conv output.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..core.formats import get_format
from ..core.qtensor import QTensor
from ..tree import flat_leaves, keystr

__all__ = ["mesh_axes", "batch_axes", "param_specs", "cache_specs",
           "paged_pool_specs", "batch_specs", "shard_tree"]

Spec = Tuple[Any, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's axis order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "axis_names", None) or getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError(f"a mesh needs named axes, got {mesh!r}")
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {n: int(shape[n]) for n in names}
    return {n: int(s) for n, s in zip(names, shape)}


def batch_axes(mesh) -> tuple:
    """Mesh axes forming the DP domain ('pod' + 'data' when present)."""
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def _dp(axes: Dict[str, int]):
    dp = batch_axes(axes)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def _resolve(axes: Dict[str, int], logical: Optional[str]):
    if logical is None:
        return None
    if logical in ("batch", "fsdp"):       # the parameter-shard domain is DP
        return _dp(axes)
    return logical if logical in axes else None


def _size(axes: Dict[str, int], ax) -> int:
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= axes[a]
    return n


def _divides(axes: Dict[str, int], ax, dim: int) -> bool:
    if ax is None:
        return False
    size = _size(axes, ax)
    return size > 0 and dim % size == 0


# (path regex, spec for the last N dims, N), matched top-down against a
# leaf's path, the first hit winning: the reference's rules
_RULES = [
    (r"'(embedding|pos_embed)'", ("model", "fsdp"), 2),
    (r"'lm_head'", ("fsdp", "model"), 2),
    (r"'(wq|wk|wv|wqkv|w_gate|w_up|w_in)'", ("fsdp", "model"), 2),
    (r"'(wo|w_down|w_out)'", ("model", "fsdp"), 2),
    (r"'router'", (None, None), 2),
    (r"'(in_proj|gate_proj)'", ("fsdp", "model"), 2),
    (r"'(out_proj)'", ("model", "fsdp"), 2),
    (r"'conv_w'", (None, "model"), 2),
]


def _leaf_spec(axes: Dict[str, int], path: str, shape, expert_axis: Optional[str],
               fsdp_scope: str = "all") -> Spec:
    """The reference's ``_leaf_spec``: column-parallel projections split
    their last dim on "model", row-parallel ones their second to last,
    the embedding its vocabulary; stacked experts take the expert axis;
    a dim the axes do not divide replicates; scales, adapters, norms and
    biases replicate."""
    ndim = len(shape)
    if ndim <= 1:
        return ()
    if re.search(r"(scales|cscale|offset)", path) and "embedding" not in path:
        return ()
    if re.search(r"(lora_a|lora_b)", path):
        return ()
    use_fsdp = (fsdp_scope == "all"
                or (fsdp_scope == "opt" and re.search(r"'opt'", path)))
    for pat, spec, n in _RULES:
        if not re.search(pat, path):
            continue
        if ndim < n:
            return ()
        lead: list = [None] * (ndim - n)
        spec = list(spec)
        if not use_fsdp:
            spec = [None if s == "fsdp" else s for s in spec]
        if expert_axis and re.search(r"experts", path) and ndim >= n + 1:
            lead[-1] = expert_axis
            spec = [None if s == expert_axis else s for s in spec]
        out = []
        for dim, ax in zip(shape, lead + spec):
            if ax is None:
                out.append(None)
                continue
            resolved = []
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                r = _resolve(axes, a)
                if r is not None:
                    resolved.extend(r if isinstance(r, tuple) else [r])
            if resolved and dim % _size(axes, tuple(resolved)) == 0:
                out.append(tuple(resolved) if len(resolved) > 1 else resolved[0])
            else:
                out.append(None)
        return tuple(out)
    return ()


def param_specs(params: Any, mesh, expert_mode: str = "expert",
                fsdp_scope: str = "all") -> Dict[str, Spec]:
    """Path -> spec of every parameter tensor (the reference's
    ``param_shardings``). fsdp_scope: "all" (FSDP x TP), "opt" (TP-only
    live params, FSDP optimizer state), "none" (TP only: the serving
    engines' layout)."""
    axes = mesh_axes(mesh)
    expert_axis = "model" if expert_mode == "expert" else None
    return {path: _leaf_spec(axes, path, tuple(t.shape), expert_axis, fsdp_scope)
            for path, t in flat_leaves(params)}


def batch_specs(batch: Any, mesh) -> Dict[str, Spec]:
    """Every batch leaf's leading (batch) dim on the DP domain where it
    divides (the reference's ``batch_shardings``)."""
    axes = mesh_axes(mesh)
    dp = _dp(axes)
    out = {}
    for path, t in flat_leaves(batch):
        shape = tuple(getattr(t, "shape", ()))
        out[path] = ((dp,) + (None,) * (len(shape) - 1)
                     if len(shape) >= 1 and _divides(axes, dp, shape[0]) else ())
    return out


_KV = r"'(k|v|k_codes|v_codes|cross_k|cross_v|cross_k_codes|cross_v_codes|b_k|b_v)'"
_KV_SCALES = r"'(k_scales|v_scales|cross_k_scales|cross_v_scales)'"


def cache_specs(cache: Any, mesh) -> Dict[str, Spec]:
    """Dense decode-cache specs (the reference's ``cache_shardings``): KV
    leaves (L, B, S, Hkv, hd) put B on the DP axes and Hkv on "model"
    where it divides, else the sequence; recurrent states split their
    channel dim on "model"."""
    axes = mesh_axes(mesh)
    dp = _dp(axes)
    out = {}
    for path, t in flat_leaves(cache):
        shape = tuple(t.shape)
        nd = len(shape)
        if re.search(r"'(pos|len|pos_roll)'", path) or nd <= 1:
            out[path] = ()
            continue
        spec: list = [None] * nd
        if (re.search(_KV, path) and nd == 5) or (re.search(_KV_SCALES, path) and nd == 4):
            if _divides(axes, dp, shape[1]):
                spec[1] = dp
            if _divides(axes, "model", shape[3]):
                spec[3] = "model"
            elif _divides(axes, "model", shape[2]):
                spec[2] = "model"
        elif re.search(r"'(conv|b_conv1|b_conv2|t_conv)'", path) and nd == 4:
            if _divides(axes, dp, shape[1]):
                spec[1] = dp
            if _divides(axes, "model", shape[3]):
                spec[3] = "model"
        elif (re.search(r"'ssd'", path) and nd == 5) \
                or (re.search(r"'(b_h1|b_h2|t_h)'", path) and nd == 3):
            if _divides(axes, dp, shape[1]):
                spec[1] = dp
            if _divides(axes, "model", shape[2]):
                spec[2] = "model"
        out[path] = tuple(spec)
    return out


def paged_pool_specs(cache: Any, mesh) -> Dict[str, Spec]:
    """Paged-pool specs (the reference's ``paged_pool_shardings``): pool
    leaves (L, P, ps, Hkv, hd) split Hkv on "model" where it divides,
    else hd; scale leaves (L, P, ps, Hkv) split Hkv alike; block tables,
    lengths and active flags stay replicated host state."""
    axes = mesh_axes(mesh)
    out = {}
    for path, t in flat_leaves(cache):
        shape = tuple(t.shape)
        nd = len(shape)
        if re.search(r"'(block_tables|len|active|cross_len|pos)'", path) or nd <= 1:
            out[path] = ()
            continue
        spec: list = [None] * nd
        if re.search(_KV.replace("|b_k|b_v", ""), path) and nd == 5:
            if _divides(axes, "model", shape[3]):
                spec[3] = "model"
            elif _divides(axes, "model", shape[4]):
                spec[4] = "model"
        elif re.search(_KV_SCALES, path) and nd == 4:
            if _divides(axes, "model", shape[3]):
                spec[3] = "model"
        out[path] = tuple(spec)
    return out


# ---------------------------------------------------------------------------
# one rank's shard
# ---------------------------------------------------------------------------

def _coords(axes: Dict[str, int], rank: int) -> Dict[str, int]:
    """A rank's coordinate on every axis (row-major over the axis order)."""
    total = math.prod(axes.values())
    if not 0 <= rank < total:
        raise ValueError(f"rank {rank} is outside a mesh of {total} devices")
    out, rest = {}, rank
    for name in reversed(list(axes)):
        rest, out[name] = divmod(rest, axes[name])
    return out


def _part(axes, coords, ax) -> Tuple[int, int]:
    """(this rank's piece, pieces) of a dim split on ``ax``."""
    if ax is None:
        return 0, 1
    idx = 0
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        idx = idx * axes[a] + coords[a]
    return idx, _size(axes, ax)


def _full(spec: Spec, ndim: int) -> Spec:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _even(idx: int, n: int):
    """``last`` of an even split: piece ``idx`` of ``n`` of the last dim."""
    def ranges(size):
        if size % n:
            raise ValueError(f"a last dim of {size} does not split {n} ways")
        return [(idx * (size // n), size // n)]
    return ranges


def _slice(t: torch.Tensor, spec: Spec, axes, coords, last=None) -> torch.Tensor:
    """The rank's piece of ``t``: a copy where a dim splits (a view would
    keep the whole tensor's storage alive beside the shard), ``t`` itself
    where it replicates. ``last`` (the last dim's length -> the (start,
    length) ranges the rank keeps, in order) overrides the last dim's
    split (layouts (d)-(f))."""
    split = False
    spec = _full(spec, t.ndim)
    for d, ax in enumerate(spec):
        if last is not None and d == t.ndim - 1:
            t = torch.cat([t.narrow(d, a, k) for a, k in last(t.shape[d])], dim=d)
            split = True
            continue
        idx, n = _part(axes, coords, ax)
        if n > 1:
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not split {n} ways")
            size = t.shape[d] // n
            t, split = t.narrow(d, idx * size, size), True
    return t.clone(memory_format=torch.contiguous_format) if split else t.contiguous()


def _block_scales(qt: QTensor) -> torch.Tensor:
    """f32 block scales of every layer. A layer-stacked double-quantized
    QTensor packs each layer's scales in chunks of its own (padded to 256
    values), so it decodes layer by layer: ``block_scales()`` of the whole
    stack reads one flat run of chunks, as the reference's does, and is
    right per layer only."""
    if qt.scales is not None or qt.data.ndim < 3:
        return qt.block_scales()
    return torch.stack([qt.select(i).block_scales() for i in range(qt.data.shape[0])])


def _shard_qtensor(qt: QTensor, spec: Spec, axes, coords, last=None) -> QTensor:
    """A QTensor's shard by its codes' spec: scales and adapters follow
    the split (a), a cut inside a block takes sub-blocks (b), and
    double-quantized scales are decoded first (c); ``last`` as in
    :func:`_slice` (d)."""
    nd = qt.data.ndim
    spec = _full(spec, nd)
    q = qt.q_axis % nd
    scales = _block_scales(qt).to(torch.float32)
    shape = list(qt.shape)
    for d, ax in enumerate(spec):
        if last is not None and d == nd - 1:
            if d == q:
                raise ValueError("a last-dim layout needs the codes' K on another dim")
            shape[d] = sum(k for _, k in last(shape[d]))
            continue
        n = _part(axes, coords, ax)[1]
        if n == 1:
            continue
        shape[d] //= n
        if d == q:
            k, k_loc = qt.shape[d], qt.shape[d] // n
            if get_format(qt.fmt).bits == 4 and k_loc % 2:
                raise ValueError(f"a {qt.fmt} shard needs an even K, got {k_loc}")
            block = k // scales.shape[d]
            sub = math.gcd(block, k_loc)
            if sub != block:
                scales = scales.repeat_interleave(block // sub, dim=d)
    lora_a = lora_b = None
    if qt.lora_a is not None:
        lora_a = _slice(qt.lora_a, spec[:-1] + (None,), axes, coords)
        lora_b = _slice(qt.lora_b, spec[:-2] + (None, spec[-1]), axes, coords, last)
    scales = _slice(scales, spec, axes, coords, last)
    return QTensor(_slice(qt.data, spec, axes, coords, last), scales, lora_a=lora_a,
                   lora_b=lora_b, fmt=qt.fmt, q_axis=qt.q_axis, shape=tuple(shape),
                   scales_shape=tuple(scales.shape), lora_alpha=qt.lora_alpha)


def _spec_of(specs: Mapping[str, Spec], keys: Tuple[str, ...], node) -> Spec:
    path = keystr(keys)
    return specs.get(path + ".data" if isinstance(node, QTensor) else path, ())


def _ssm_last(p, name: str, r: int, tp: int):
    """Layout (e): the ``last`` of an SSM leaf ``name`` of the param dict
    ``p`` (layer-stacked or not) on rank ``r`` of ``tp``, or None (its
    spec's split: ``out_proj``'s rows)."""
    nh, di = p["a_log"].shape[-1], p["norm_scale"].shape[-1]
    if nh % tp:
        raise ValueError(f"{nh} SSD heads do not split {tp} ways")
    ds = (p["conv_w"].shape[-1] - di) // 2
    hl, dl = nh // tp, di // tp
    heads, cols = [(r * hl, hl)], [(r * dl, dl)]
    ranges = {"in_proj": [(r * dl, dl), (di + r * dl, dl), (2 * di, 2 * ds),
                          (2 * di + 2 * ds + r * hl, hl)],
              "conv_w": [(r * dl, dl), (di, 2 * ds)], "conv_bias": [(r * dl, dl), (di, 2 * ds)],
              "a_log": heads, "dt_bias": heads, "D": heads, "norm_scale": cols}.get(name)
    return None if ranges is None else (lambda size: ranges)


_RGLRU_CHANNELS = ("gate_proj", "in_proj", "conv_w", "conv_bias", "a_param", "w_rg", "w_ig")


def shard_tree(tree: Any, specs: Mapping[str, Spec], rank: int, mesh,
               kv_replicas: int = 1, recurrent: bool = False) -> Any:
    """Rank ``rank``'s shard of ``tree`` under ``specs`` (path -> spec, as
    :func:`param_specs` / :func:`cache_specs` give them): every split dim
    sliced to the rank's contiguous piece, with the layouts (a)-(f) of the
    module docstring (``kv_replicas`` > 1 turns on (d): that many ranks of
    the "model" axis hold each KV head; ``recurrent`` turns on (e) and (f)
    for the SSM and RG-LRU param dicts, the tensor-parallel engine's
    layout). A path absent from ``specs`` replicates."""
    axes = mesh_axes(mesh)
    coords = _coords(axes, rank)
    kv_last = None
    if kv_replicas > 1:
        tp = axes["model"]
        kv_last = _even(coords["model"] // kv_replicas, tp // kv_replicas)
    mixer = recurrent and "model" in axes and axes["model"] > 1

    def layout(parent, name):
        """The last-dim layout of leaf ``name`` of ``parent``: (d)-(f)."""
        if mixer and "a_log" in parent:
            return _ssm_last(parent, name, coords["model"], axes["model"])
        if mixer and "w_rg" in parent:
            return _even(coords["model"], axes["model"]) if name in _RGLRU_CHANNELS else None
        return kv_last if name in ("wk", "wv", "bias_k", "bias_v") else None

    def walk(node, keys, parent):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,), node) for k, v in node.items()}
        if node is None:
            return None
        name = keys[-1] if keys else None
        last = layout(parent, name) if parent is not None else None
        if isinstance(node, QTensor):
            return _shard_qtensor(node, _spec_of(specs, keys, node), axes, coords, last)
        spec = specs.get(keystr(keys), ())
        m = re.fullmatch(r"bias_(\w+)", name) if keys else None
        weight = parent.get(f"w{m.group(1)}") if m and parent is not None else None
        if weight is not None:           # (a) a bias follows its weight's columns
            wspec = _full(_spec_of(specs, keys[:-1] + (f"w{m.group(1)}",), weight),
                          len(weight.shape))
            spec = (None,) * (node.ndim - 1) + (wspec[-1],)
        return _slice(node, spec, axes, coords, last)

    return walk(tree, (), None)
