"""Rank bodies for the tensor-parallel tests (tests/test_torch_tp.py).

They run in processes that ``repro_torch.cluster.launch_ranks`` spawns,
so they live in a module of their own that imports torch and the port
only (no JAX): each rank deploys the reduced nllb600m on its shard of the
same weights and serves the reference TP test's grids.
"""

import torch

from repro_torch.cluster import tp_mesh
from repro_torch.convert import from_numpy_tree
from repro_torch.core import tree_nbytes
from repro_torch.models import Ctx
from repro_torch.optim import compressed_psum
from repro_torch.serving import SamplingParams, deploy

CTX = Ctx(compute_dtype=torch.float32)
GREEDY = SamplingParams(max_new_tokens=8)
SAMPLED = SamplingParams(max_new_tokens=8, temperature=0.8, top_k=8, seed=7)


def common(paged: bool, horizon: int) -> dict:
    """The reference TP test's engine shape."""
    return dict(smoke=True, slots=2, max_len=16, ctx=CTX, paged=paged, page_size=4,
                horizon=horizon)


def grids(pipe, src):
    """The greedy grid (to ita) and the seeded sampled grid (to hin):
    (tokens, finish reason) per source row."""
    return ([(o.token_ids, o.finish_reason) for o in pipe.translate(src, "ita", GREEDY)],
            [(o.token_ids, o.finish_reason) for o in pipe.translate(src, "hin", SAMPLED)])


def prefill_logits(pipe, src, code: int):
    """One prefill's logits through the engine's own (rank-local) model,
    shard and ctx: the source's first row prompted with ``code``."""
    eng = pipe.engine
    cache = eng.model.init_cache(1, 16, eng.kv_dtype, enc_len=eng.enc_cap)
    batch = {"src_tokens": torch.as_tensor(src[:1]),
             "tgt_in": torch.full((1, 1), code, dtype=torch.int32)}
    with torch.no_grad():
        return eng.model.prefill(eng.ctx, eng.params, cache, batch)[1].numpy()


def tp_grid(rank, world, device, params_np, cases, src, grads):
    """Every case (spec, paged, horizon) deployed on this rank's shard of
    ``params_np``; then, with ``grads`` (one tree per rank), the
    compressed all-reduce of this rank's tree. Returns the grids, one
    prefill's logits and the reduced tree."""
    params = from_numpy_tree(params_np, "cpu")
    mesh = tp_mesh(world)
    out = {"mesh": repr(mesh), "grids": {}}
    for spec, paged, horizon in cases:
        pipe = deploy("nllb600m", spec, params=params, mesh=mesh, device=device,
                      **common(paged, horizon))
        out["grids"][spec, paged, horizon] = grids(pipe, src)
        if "logits" not in out:
            out["logits"] = prefill_logits(pipe, src, 7)
            out["shard_heads"] = pipe.engine.model.cfg.num_heads
            # the pipeline keeps the engine's shard, not the whole tree
            out["weight_bytes"] = (pipe.params is pipe.engine.params,
                                   tree_nbytes(pipe.params), pipe.quantized_bytes)
    if grads is not None:
        tree = {k: None if v is None else torch.from_numpy(v) for k, v in grads[rank].items()}
        out["psum"] = {k: None if v is None else v.numpy()
                       for k, v in compressed_psum(tree, mesh).items()}
    return out

