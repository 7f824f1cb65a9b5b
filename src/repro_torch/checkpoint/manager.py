"""Checkpointing in the reference's on-disk format.

A checkpoint is a directory ``step_{N}`` holding one ``.npy`` per leaf
and a ``manifest.json`` that lists each leaf's path (spelled as
``jax.tree_util.keystr`` spells it, e.g. ``['decoder']['layers']['attn']['wq']``,
a QTensor's fields as ``...['wq'].data``), file, dtype and shape. bf16
and float8 leaves are stored as their raw bits (``uint16`` / ``uint8``)
with the dtype's name in the manifest. Leaves are written in the order
JAX flattens the same tree (dict keys sorted, None leaves dropped), so a
checkpoint written here restores in ``repro.checkpoint.restore_tree``,
and one written there restores here: this package matches the leaves by
path, since its dicts keep insertion order.

As in the reference: atomic publish (write ``step_N.tmp``, then rename),
keep-last-k garbage collection, step discovery, async save on a
background thread (the host copy is taken before ``save`` returns) and a
SIGTERM hook that sets ``preempted`` for the train loop to poll.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import signal
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..convert import from_raw, to_raw
from ..core.qtensor import QTensor
from ..parallel.sharding import shard_tree
from ..tree import flat_leaves, keystr

__all__ = ["save_tree", "restore_tree", "latest_step", "CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _rebuild(template, leaves: dict, path: str = ""):
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, path + keystr((k,))) for k, v in template.items()}
    if isinstance(template, QTensor):
        return dataclasses.replace(template, **{
            n: leaves[f"{path}.{n}"] for n in QTensor._CHILDREN
            if getattr(template, n) is not None})
    return None if template is None else leaves[path]


def _host(tree):
    """[(path, raw numpy array, dtype name)] — the host copy a save writes."""
    return [(p, *to_raw(leaf)) for p, leaf in flat_leaves(tree)]


def _write(path: str, host_leaves, step: int, extra: Optional[dict]):
    final = os.path.join(path, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (kp, arr, dtype_name) in enumerate(host_leaves):
        name = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, name), arr)
        manifest["leaves"].append({"path": kp, "file": name, "dtype": dtype_name,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)      # atomic publish
    return final


def save_tree(path: str, tree: Any, step: int, extra: Optional[dict] = None):
    """Atomic full-array checkpoint at ``path/step_{step}``."""
    return _write(path, _host(tree), step, extra)


def restore_tree(path: str, template: Any, step: Optional[int] = None,
                 shardings: Any = None):
    """Restore into ``template``'s structure, each leaf on the device of
    the template's leaf at its path. Returns (tree, step, extra).
    ``shardings`` = ``(specs, rank, mesh)`` reshards on restore: the tree
    is one rank's shard (``parallel.shard_tree``) of the checkpoint."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = list(flat_leaves(template))
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, template "
            f"expects {len(flat)} — incompatible tree")
    by_path = {m["path"]: m for m in manifest["leaves"]}
    leaves = {}
    for kp, tmpl in flat:
        if kp not in by_path:
            raise ValueError(f"checkpoint has no leaf {kp}")
        meta = by_path[kp]
        arr = np.load(os.path.join(d, meta["file"]))
        dev = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
        leaves[kp] = from_raw(arr, meta["dtype"], dev)
    tree = _rebuild(template, leaves)
    if shardings is not None:
        specs, rank, mesh = shardings
        tree = shard_tree(tree, specs, rank, mesh)
    return tree, manifest["step"], manifest["extra"]


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for n in os.listdir(path)
             if (m := _STEP_RE.match(n))]
    return max(steps) if steps else None


class CheckpointManager:
    """keep-last-k + async save + preemption handling."""

    def __init__(self, path: str, keep: int = 3, async_save: bool = True,
                 install_sigterm: bool = False):
        self.path = path
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.preempted = False
        os.makedirs(path, exist_ok=True)
        if install_sigterm:
            signal.signal(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, signum, frame):   # pragma: no cover
        self.preempted = True

    def _gc(self):
        steps = sorted(int(m.group(1)) for n in os.listdir(self.path)
                       if (m := _STEP_RE.match(n)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, tree: Any, step: int, extra: Optional[dict] = None,
             blocking: Optional[bool] = None):
        self.wait()                      # one in-flight save at a time
        host_leaves = _host(tree)

        def run():
            _write(self.path, host_leaves, step, extra)
            self._gc()

        if blocking is False or (blocking is None and self.async_save):
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            run()

    def restore_latest(self, template: Any, shardings: Any = None):
        return restore_tree(self.path, template, None, shardings)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.path)
