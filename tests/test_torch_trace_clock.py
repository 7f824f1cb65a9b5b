"""The traced prefill span lies inside its request's span on any host
clock: the engine clock is replaced by one whose ticks grow with every
read (a host that slows down as the run goes on), and the trace of a
dense and a paged run must still check clean. A duration read after the
span's end once put the span's start before its request's arrival under
load (``tests/test_torch_obs.py::test_deploy_trace_exposes_tracer``
failed so, now and then, in parallel test runs)."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import TraceConfig  # noqa: E402
from repro_torch.serving import SamplingParams, deploy  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402


class _SlowingClock:
    """perf_counter() whose n-th read returns n * n microseconds."""

    def __init__(self):
        self.n = 0

    def perf_counter(self):
        self.n += 1
        return self.n * self.n * 1e-6


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_span_starts_inside_its_request(monkeypatch, paged):
    monkeypatch.setattr(engine_mod, "time", types.SimpleNamespace(
        perf_counter=_SlowingClock().perf_counter))
    pipe = deploy("nllb600m", "int4", smoke=True, device="cpu", slots=2, max_len=16,
                  paged=paged, page_size=4, trace=TraceConfig())
    rng = np.random.default_rng(0)
    prompts = [{"src_tokens": rng.integers(16, 256, (1, 5)).astype(np.int32),
                "tgt_in": np.full((1, 1), 8, np.int32)} for _ in range(2)]
    outs = pipe.generate(prompts, SamplingParams(max_new_tokens=3))
    assert all(len(o.token_ids) == 3 for o in outs)
    assert pipe.tracer.check() == []
