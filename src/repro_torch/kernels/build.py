"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under ``build/repro_torch/``
at the repository root. The library name carries a hash of its source,
of the ``csrc/`` headers it includes (``#include "..."``, followed
through the headers) and of the compiler flags, so an edited kernel,
header or flag rebuilds the libraries that use it, and a built one is
reused. Builds of several sources run in parallel (one ``nvcc`` process
each). A failed build raises with the compiler's output; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "build", "library", "library_path", "build_dir", "sm_count",
           "H100_SMS"]

SOURCES = ("qmm", "paged_attn", "decode_attn")
H100_SMS = 132              # the card the launch plans are written for
_CSRC = Path(__file__).resolve().parent / "csrc"
_LIBS: Dict[str, ctypes.CDLL] = {}
_SMS: Dict[int, int] = {}
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)
# what ptxas reported for each kernel built by this process (registers,
# shared memory, spills)
PTXAS_LOG: Dict[str, str] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# qmm.cu holds 80 kernel instances: -split-compile=0 optimizes them on
# every core, and ptxas gives each the registers and tensor-core
# instructions of the one-process build. paged_attn.cu's kernels took
# other registers and ran slower split, so the other sources stay whole.
_SOURCE_FLAGS = {"qmm": ("-split-compile=0",)}


def _flags(name: str) -> tuple:
    return _FLAGS + _SOURCE_FLAGS.get(name, ())


def _target(name: str) -> Path:
    h = hashlib.sha256("\0".join(_flags(name)).encode() + b"\0")
    todo, seen = [f"{name}.cu"], set()
    while todo:                       # the source, then the headers it names
        file = todo.pop(0)
        if file in seen:
            continue
        seen.add(file)
        text = (_CSRC / file).read_bytes()
        h.update(file.encode() + b"\0" + text)
        todo += [m.decode() for m in _INCLUDE.findall(text)]
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source whose library is missing, all at once."""
    procs = {}
    build_dir().mkdir(parents=True, exist_ok=True)
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        PTXAS_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    return _target(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]


def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device, read once per device
    (the launch plans spread their blocks over them)."""
    if device_index not in _SMS:
        import torch
        _SMS[device_index] = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    return _SMS[device_index]
