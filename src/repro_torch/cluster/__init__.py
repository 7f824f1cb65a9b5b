"""Cluster serving: tensor-parallel engines and data-parallel routing.

Two scale-out layers over the single serving engine, and their
composition:

* **Tensor parallel** — ``deploy(..., mesh=tp_mesh(K))`` on each of K
  ranks that :func:`launch_ranks` started: every rank serves the same
  requests on its shard of the weights and KV storage, and the model sums
  its row-parallel products over the ranks (``parallel/tp.py``). The text
  and audio enc-decs and every LM family (an MoE model's experts split E
  over the ranks; an SSM's heads and an RG-LRU's channels split, with
  the collectives their norm and gates need), at every quantization arm
  (act-quantizing specs, calibration, QLoRA adapters, a draft arm), with
  every arm that reads a clock (``sla=``, ``faults=``, ``max_pending``,
  a request's ``deadline_ms``: rank 0's clock decides, through the
  engine's control channel).
* **Data parallel** — :class:`ReplicaRouter` balances requests over N
  independent engine replicas; :func:`deploy_replicas` builds them
  behind the ordinary ``TranslationPipeline`` surface, replica ``i`` on
  ``cuda:i`` where the process sees N cards, else all on one device.
* **dp x tp** — ``deploy_replicas(replicas=N, tp=K)`` on each of the N·K
  ranks of ``launch_ranks(fn, world=N*K)``: rank r deploys replica
  ``r // K``'s tensor-parallel engine on the ``("model",)`` row of a
  ``("dp", "model")`` mesh, and every rank runs the same
  :class:`GroupRouter` over the N replicas (its own engine and mirrors
  of the others, kept in step by small host records; ``router.py``),
  with ``on_token`` streaming on every rank and the clock-driven arms
  decided by each group's rank 0.

All keep the engine's standing invariant: routed and sharded token
streams are those of a single-device engine serving the same requests.

The backend follows the device layout: NCCL when every rank has a card of
its own, gloo when ranks share one card (NCCL refuses two ranks on one
device) or run on the CPU. Under gloo the tensors stay on the card; the
backend only carries the collectives. The mesh's repr names it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import re
import sys
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Tuple

import torch

from .router import GroupReplica, GroupRouter, ReplicaRouter

__all__ = ["ReplicaRouter", "GroupRouter", "deploy_replicas", "parse_mesh_spec", "tp_mesh",
           "launch_ranks", "rank_backend"]


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """Parse the CLI mesh convention ``"dp2,tp2"`` -> ``(dp, tp)``:
    comma-separated ``dp<N>`` / ``tp<N>`` factors in either order, an
    omitted factor 1. dp is the replica count, tp the per-replica mesh
    width."""
    dp = tp = 1
    seen = set()
    for part in filter(None, (p.strip() for p in spec.split(","))):
        m = re.fullmatch(r"(dp|tp)(\d+)", part)
        if m is None:
            raise ValueError(f"bad mesh factor {part!r} in {spec!r}; expected "
                             "comma-separated dp<N>/tp<N>, e.g. 'dp2,tp2'")
        axis, n = m.group(1), int(m.group(2))
        if axis in seen:
            raise ValueError(f"duplicate {axis!r} factor in {spec!r}")
        seen.add(axis)
        if n < 1:
            raise ValueError(f"mesh factor {part!r} must be >= 1")
        if axis == "dp":
            dp = n
        else:
            tp = n
    return dp, tp


def rank_backend(device, world: int) -> str:
    """NCCL when each of ``world`` ranks gets a card of its own, gloo when
    they would share one card or run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, world: int, fn: Callable, args: tuple, device: str,
               backend: str, tmpdir: str, timeout: Optional[float] = None) -> None:
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else (dev.index or 0))
        torch.cuda.set_device(dev)
    else:
        # the ranks share the host's cores, and idle OpenMP threads
        # spinning beside a rank that waits in a collective slow every
        # rank several-fold: one intra-op thread a rank
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmpdir, 'store')}",
                            world_size=world, rank=rank,
                            **({} if timeout is None
                               else {"timeout": datetime.timedelta(seconds=timeout)}))
    try:
        out = fn(rank, world, dev, *args)
        dist.barrier()
    except BaseException:
        # a rank's error reaches its peers as a closed connection, and the
        # spawn raises whichever failed rank it sees first: the first
        # cause goes to stderr here
        print(f"rank {rank} of {world} raised:", file=sys.stderr)
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmpdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def launch_ranks(fn: Callable, world: int, *, device="cuda", args: tuple = (),
                 tmpdir: Optional[str] = None, timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` on ``world`` processes of a
    fresh process group and return each rank's result, in rank order.

    The processes start with ``torch.multiprocessing``'s spawn method
    and meet through a ``file://`` store in a temporary directory (under
    ``tmpdir`` when given), so no TCP port is claimed. The backend is
    :func:`rank_backend`'s: NCCL with rank r on ``cuda:r`` when the
    process sees ``world`` cards, else gloo with every rank on ``device``.
    ``fn`` must be importable by name (a module-level function); its
    result is pickled back. A rank that raises prints its traceback to
    stderr and stops the others, and a failed rank's error is raised here
    (perhaps a peer's closed connection: the first cause is on stderr).
    ``timeout`` (seconds) bounds every collective of the process group
    (None: the backend's default, 30 minutes): ranks whose schedules
    parted, one waiting in a collective that another never joins, then
    raise instead of hanging.
    """
    import torch.multiprocessing as mp
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    backend = rank_backend(device, world)
    with tempfile.TemporaryDirectory(dir=tmpdir) as tmp:
        mp.start_processes(_rank_main,
                           args=(world, fn, args, str(device), backend, tmp, timeout),
                           nprocs=world, join=True, start_method="spawn")
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _need_world(world: int, what: str) -> None:
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"{what} needs a process group of {world} ranks: run the "
                           f"caller inside cluster.launch_ranks(fn, world={world})")
    if dist.get_world_size() != world:
        raise ValueError(f"{what} needs a process group of {world} ranks, this one "
                         f"has {dist.get_world_size()}")


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A DeviceMesh of ``shape`` over the ranks of the process group, in
    rank order; its repr names the backend."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    class TPMesh(DeviceMesh):
        def __repr__(self) -> str:
            return f"{super().__repr__()} over {dist.get_backend()}"

    # a rank on a card has set its device (launch_ranks), which starts CUDA
    on_card = dist.get_backend() == "nccl" or (torch.cuda.is_available()
                                                 and torch.cuda.is_initialized())
    ranks = torch.arange(dist.get_world_size()).reshape(shape).tolist()
    return TPMesh("cuda" if on_card else "cpu", ranks, mesh_dim_names=names)


def tp_mesh(tp: int):
    """A ``("model",)`` DeviceMesh over the ``tp`` ranks of the process
    group this process has joined (``launch_ranks``): the serving
    engine's tensor-parallel domain. Raises when no group is up or its
    world size is not ``tp``; it never falls back to one device."""
    _need_world(tp, f"tensor parallelism tp={tp}")
    return _device_mesh((tp,), ("model",))


def _to_device(tree, dev):
    from ..core.qtensor import QTensor
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, **{n: getattr(tree, n).to(dev)
                                            for n in QTensor._CHILDREN
                                            if getattr(tree, n) is not None})
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def deploy_replicas(arch_or_cfg, policy="int4", *, replicas: int = 2, tp: int = 1,
                    device=None, **deploy_kwargs):
    """Deploy ``replicas`` independent engines behind a ReplicaRouter.

    Each replica is a full ``serving.deploy`` of the same config and spec
    (``params=`` shares one checkpoint; otherwise ``init_seed`` makes
    every replica initialize alike). With ``tp == 1``, replica ``i`` sits
    on ``cuda:i`` when ``device`` is the CUDA default (None or "cuda") and
    the process sees at least ``replicas`` cards; otherwise every replica
    sits on ``device`` (routing and backpressure still apply, device
    concurrency is lost).

    ``tp > 1`` is the composed stack, called on each of the
    ``replicas * tp`` ranks of ``launch_ranks`` (it raises outside such a
    process group): replica ``i`` is the tensor-parallel engine of ranks
    ``[i*tp, (i+1)*tp)`` on the ``("model",)`` row of a ``("dp",
    "model")`` mesh, each rank deploys only its own group's engine, on
    ``device`` (None: the rank's current card), and the router is a
    :class:`GroupRouter` that every rank runs alike. ``sla=``,
    ``faults=`` and ``max_pending=`` reach each rank's engine; each
    group's rank 0 decides its group's expiries and retunes, and
    ``submit(on_token=)`` streams on every rank.

    Returns a ``TranslationPipeline`` whose ``engine`` is the router;
    ``translate`` / ``generate`` fan over replicas (``translate_stream``
    needs a single-engine pipeline). The engines stay reachable through
    ``pipe.engine.replicas`` (a composed stack's as handles; this rank's
    own engine is ``pipe.engine.own``).
    """
    from ..serving import deploy
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if tp > 1:
        return _deploy_groups(arch_or_cfg, policy, replicas, tp, device, deploy_kwargs)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.device_count() >= replicas:
        devs = [torch.device("cuda", i) for i in range(replicas)]
    else:
        devs = [dev] * replicas
    params = deploy_kwargs.pop("params", None)
    pipes = [deploy(arch_or_cfg, policy, device=d, **deploy_kwargs,
                    params=None if params is None else _to_device(params, d))
             for d in devs]
    router = ReplicaRouter([p.engine for p in pipes])
    return dataclasses.replace(pipes[0], engine=router)


def _deploy_groups(arch_or_cfg, policy, replicas: int, tp: int, device, deploy_kwargs):
    """This rank's share of a dp x tp stack (``deploy_replicas``)."""
    import torch.distributed as dist
    from ..serving import deploy
    _need_world(replicas * tp, f"dp{replicas},tp{tp}")
    rank = dist.get_rank()
    group = rank // tp
    mesh = _device_mesh((replicas, tp), ("dp", "model"))["model"]
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    pipe = deploy(arch_or_cfg, policy, mesh=mesh, device=device, **deploy_kwargs)
    eng = pipe.engine
    handles = [GroupReplica(i * tp, eng if i == group else None, eng.max_len,
                            eng.max_pending) for i in range(replicas)]
    return dataclasses.replace(pipe, engine=GroupRouter(handles, group))
