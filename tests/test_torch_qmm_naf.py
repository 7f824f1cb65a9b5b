"""The FASST activation in qmm's epilogue, on the CPU: ``ops.qmm(x, w,
naf=m)`` is ``ops.fasst(ops.qmm(x, w), m)`` bit for bit (the wrapper's
plain route runs qmm's plain version, then the activation's), and the FFN
takes that route only where its input product goes to the qmm kernel at
decode rows, with the same output as the unfused route."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.qlinear import qmatmul, qmm_route  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fasst import MODES  # noqa: E402
from repro_torch.kernels.qmm import DECODE_MAX_M  # noqa: E402
from repro_torch.models.layers import Ctx, mlp  # noqa: E402


def _case(fmt, m=5, k=128, n=96, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)) * 0.05
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    return x, QTensor.quantize(w, fmt, 32, double_quant=(fmt == "nf4"))


@pytest.mark.parametrize("fmt", ["int4", "fp4", "nf4"])
@pytest.mark.parametrize("mode", MODES)
def test_fused_naf_equals_qmm_then_fasst(mode, fmt):
    x, w = _case(fmt)
    for dt in (torch.float32, torch.bfloat16):
        fused = ops.qmm(x, w, compute_dtype=dt, naf=mode)
        unfused = ops.fasst(ops.qmm(x, w, compute_dtype=dt), mode)
        assert fused.dtype == dt and torch.equal(fused, unfused)
    if mode == "identity":
        assert torch.equal(ops.qmm(x, w, naf=mode), ops.qmm(x, w))


def test_fused_naf_refuses_unknown_modes_and_other_routes():
    x, w = _case("int4")
    with pytest.raises(ValueError, match="NAF mode"):
        ops.qmm(x, w, naf="softplus")
    # only the kernel route fuses; any other product leaves the NAF to its caller
    assert qmm_route(w, "kernel") and not qmm_route(w, "torch")
    assert not qmm_route(QTensor.quantize(torch.zeros(128, 8), "int8", 32), "kernel")
    assert not qmm_route(torch.zeros(128, 8), "kernel")
    with pytest.raises(ValueError, match="qmm kernel only"):
        qmatmul(x, w, impl="torch", naf="relu")
    assert torch.equal(qmatmul(x, w, impl="kernel", naf="relu"),
                       ops.fasst(qmatmul(x, w, impl="kernel"), "relu"))


@pytest.mark.parametrize("rows", [(2, 3), (1, DECODE_MAX_M), (2, 9)])
@pytest.mark.parametrize("w_fmt", ["int4", "int8"])
@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_mlp_fuses_only_on_the_qmm_route(impl, w_fmt, rows, monkeypatch):
    """Decode rows (at most DECODE_MAX_M) fuse; prefill rows (2 x 9) take
    qmm, then the FASST activation."""
    rng = np.random.default_rng(1)
    d, ff = 64, 128
    params = {"w_in": QTensor.quantize(torch.from_numpy(
                  rng.standard_normal((d, ff)).astype(np.float32)) * 0.1, w_fmt, 32),
              "w_out": QTensor.quantize(torch.from_numpy(
                  rng.standard_normal((ff, d)).astype(np.float32)) * 0.1, w_fmt, 32)}
    x = torch.from_numpy(rng.standard_normal((*rows, d)).astype(np.float32))
    nafs = []
    real_qmm = ops.qmm

    def spy(*a, **kw):
        nafs.append(kw.get("naf"))
        return real_qmm(*a, **kw)

    monkeypatch.setattr(ops, "qmm", spy)
    outs = {}
    for fasst_on in (True, False):
        nafs.clear()
        ctx = Ctx(compute_dtype=torch.bfloat16, matmul_impl=impl,
                  use_fasst_kernel=fasst_on)
        outs[fasst_on] = mlp(ctx, params, x, "relu")
        fused = (fasst_on and qmm_route(params["w_in"], impl)
                 and rows[0] * rows[1] <= DECODE_MAX_M)
        assert nafs == (["relu", None] if fused
                        else [None, None] if qmm_route(params["w_in"], impl) else [])
    assert torch.equal(outs[True], outs[False])
