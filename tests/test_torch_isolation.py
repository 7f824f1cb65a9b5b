"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU silently."""

import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
                        re.MULTILINE)


def test_importing_every_module_loads_no_jax():
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_source_has_no_jax_or_reference_imports(path):
    assert path.exists(), path
    assert not _FORBIDDEN.search(path.read_text()), path


def test_deploy_without_device_needs_cuda(monkeypatch):
    from repro_torch.serving import deploy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        deploy("nllb600m", "int4", smoke=True, paged=True)


def test_default_deploy_without_device_needs_cuda(monkeypatch):
    """deploy() with its defaults (the dense engine) runs on the card too."""
    from repro_torch.serving import deploy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        deploy("nllb600m", "int4", smoke=True)


def test_kernel_calls_refuse_cpu_tensors():
    """The launchers never take the plain route themselves."""
    from repro_torch.kernels.fasst import fasst_act_call
    from repro_torch.kernels.paged_attn import paged_attn_call
    from repro_torch.kernels.qmm import qmm_kernel_call
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        qmm_kernel_call(x, torch.zeros(32, 8, dtype=torch.uint8),
                        torch.zeros(1, 8), fmt_name="int4", sub_block=64)
    with pytest.raises(ValueError, match="CUDA"):
        fasst_act_call(x, mode="relu")
    q = torch.zeros(1, 1, 1, 8)
    pages = torch.zeros(2, 4, 1, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attn_call(q, pages, None, pages, None,
                        torch.zeros(1, 1, dtype=torch.int32),
                        torch.ones(1, dtype=torch.int32), sm_scale=1.0)


def test_scale_out_modules_stand_alone_and_never_fall_back(monkeypatch):
    """The scale-out modules are among the files checked above; a mesh
    needs a process group of its width (no quiet single-device serving),
    and the backend follows the device layout: NCCL when every rank has
    a card of its own, gloo when ranks share one or run on the CPU."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix() for p in PORT_FILES[:-1]}
    assert {"parallel/sharding.py", "parallel/tp.py", "cluster/__init__.py",
            "cluster/router.py"} <= names
    from repro_torch.cluster import rank_backend, tp_mesh
    with pytest.raises(RuntimeError, match="process group"):
        tp_mesh(2)
    assert rank_backend("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rank_backend("cuda", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rank_backend("cuda", 2) == "nccl"
    assert rank_backend("cuda:0", 2) == "gloo"     # pinned to one card: shared
