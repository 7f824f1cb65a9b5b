"""The qmm kernel's launch plan (``kernels/qmm.py::qmm_plan``), held on
the CPU: regime by M, K splits that cover K in whole scale rows, enough
blocks at the served decode shapes, and the workspace size."""

import math

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.qmm import (BK, DECODE_MAX_M, H100_SMS,  # noqa: E402
                                     REGIMES, qmm_plan)

SERVED_KN = [(1024, 1024), (1024, 8192), (8192, 1024)]
# (M, K, N, sub_block): served decode rows (M = 1, 8 = slots), the dense
# engine's 64-row and a batched 512-row prefill on the served (K, N),
# then the shapes of test_torch_kernels.py's qmm parity test
SHAPES = ([(m, k, n, 64) for k, n in SERVED_KN for m in (1, 8, 64, 512)]
          + [(8, 128, 64, 32), (48, 256, 128, 64), (1, 64, 96, 16), (130, 512, 256, 128)])


@pytest.mark.parametrize("fmt", ["int4", "int8"])
@pytest.mark.parametrize("m,k,n,block", SHAPES)
def test_qmm_plan_invariants(m, k, n, block, fmt):
    plan = qmm_plan(m, n, k, block, fmt)
    assert plan.regime == ("decode" if m <= DECODE_MAX_M else "prefill")
    bm, bn = REGIMES[plan.regime]
    assert plan.grid == (math.ceil(n / bn), math.ceil(m / bm), plan.splits)

    # the splits' K ranges tile [0, K) exactly, none empty, each in whole
    # scale rows (so even: a packed byte never straddles two splits) and,
    # where K is split, in whole 64-deep slabs but for the last
    bounds = [(z * plan.k_per_split, min(k, (z + 1) * plan.k_per_split))
              for z in range(plan.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a < b for a, b in bounds)
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    for a, b in bounds:
        assert (b - a) % block == 0 and (b - a) % 2 == 0
    if plan.splits > 1:
        assert all((b - a) % BK == 0 for a, b in bounds[:-1])

    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    if (k, n) in SERVED_KN and m in (1, 8):
        assert plan.regime == "decode" and blocks >= H100_SMS
    assert plan.workspace_elems == (plan.splits * m * n if plan.splits > 1 else 0)
