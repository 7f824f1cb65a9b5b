"""The serving launcher and the synthetic corpus it draws prompts from:
the port's ``repro_torch.launch.serve`` against the reference's
``repro.launch.serve`` (smoke nllb600m on the CPU).

The port's SyntheticTranslation draws the reference's batches byte for
byte; the launcher prints the reference's lines (the same model-bytes
line, queue lines, per-request lines and counters; times and tokens
differ, since each package draws its own random weights); its
``[req N]`` streams are the streams of the same requests served through
``deploy()``; ``--max-pending`` prints ``saturated`` lines and counts the
rejections; act-quantizing and fp8 specs serve as ``--policy`` and
``--draft-spec``; ``--mesh`` keeps the reference's grammar: tp2 serves
on two ranks, dp2 through the replica router and dp2,tp2 on four ranks,
each with the single engine's streams, and so does tp2 with an
act-quantizing policy and a draft arm; dp2,tp2 serves the SLA controller,
deadlines and a live metrics port.
"""

import json
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cluster import parse_mesh_spec as j_parse_mesh_spec  # noqa: E402
from repro.data import SyntheticTranslation as JSyntheticTranslation  # noqa: E402
from repro.data import pairs as j_pairs  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import resolve_spec  # noqa: E402
from repro_torch.data import SyntheticTranslation, pairs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import SamplingParams, deploy  # noqa: E402

SMOKE = ["--smoke", "--requests", "4", "--gen", "6", "--max-len", "32"]
_REQ = re.compile(r"^\[req (\d+)\] slot (\d+) (\w+)\s+ttft .*: (\[.*\])$")


def run_port(capsys, *argv):
    serve.main([*SMOKE, "--impl", "torch", "--device", "cpu", *argv])
    return capsys.readouterr().out.splitlines()


def streams(lines):
    """Request id -> (finish reason, tokens) from the ``[req N]`` lines."""
    out = {}
    for line in lines:
        m = _REQ.match(line)
        if m:
            out[int(m.group(1))] = (m.group(3), json.loads(m.group(4)))
    return out


def shape(line: str) -> str:
    """A line with its times and token lists masked."""
    line = re.sub(r"\[[\d, ]*\]$", "[..]", line)
    line = re.sub(r"\d+\.\d+", "#", line)
    return re.sub(r"\s+", " ", line)


@pytest.mark.parametrize("seed,split,pair", [(0, "train", None), (3, "eval", None),
                                             (5, "train", ("hin", "ita"))])
def test_synthetic_translation_equals_reference(seed, split, pair):
    a = SyntheticTranslation(1000, 24, seed=seed, split=split)
    b = JSyntheticTranslation(1000, 24, seed=seed, split=split)
    for batch in (1, 3, 2):
        x, y = a.sample(batch, pair), b.sample(batch, pair)
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes(), k
            else:
                assert x[k] == y[k], k
    assert pairs() == j_pairs()


@pytest.mark.parametrize("spec", ["dp2,tp2", "tp4", "dp3", " tp2 , dp1 ", ""])
def test_parse_mesh_spec_equals_reference(spec):
    assert serve.parse_mesh_spec(spec) == j_parse_mesh_spec(spec)


def test_launcher_prints_the_reference_lines(capsys, monkeypatch):
    """Same flags, both launchers: every line has the reference's shape,
    and the model-bytes, queue, fault and counter lines are equal."""
    monkeypatch.setattr(sys, "argv", ["serve", *SMOKE, "--impl", "xla"])
    j_serve.main()
    ref = capsys.readouterr().out.splitlines()
    got = run_port(capsys)
    assert [shape(x) for x in got] == [shape(x) for x in ref]
    for a, b in zip(got, ref):
        if not (_REQ.match(a) or a.startswith(("served", "latency"))):
            assert a == b       # lines without times or tokens
    counters = re.compile(r"(\d+ prefill compiles, \d+ decode syncs @ [\d.]+ tok/sync, "
                          r"\d+ overlapped rounds, occupancy [\d.]+)")
    assert counters.search(got[-3]).group(1) == counters.search(ref[-3]).group(1)
    assert got[0] == "model bytes 0.6 MB -> 0.1 MB (int4 = w4kv8, 6.49x)"
    assert got[-1] == ("faults: 0 preemptions (0 resumed), 0 deadline expirations, "
                       "0 admission rejections, 0 slot errors")


def test_launcher_streams_equal_deploy(capsys):
    """Paged, an nf4 draft arm, horizon 4: the printed streams are those
    of the same requests served through deploy() directly."""
    flags = ["--paged", "--page-size", "4", "--draft-spec", "nf4", "--horizon", "4"]
    lines = run_port(capsys, *flags)
    got = streams(lines)
    assert any(line.startswith("speculative draft arm: nf4 = wnf4kv8dq") for line in lines)
    assert "verify rounds" in next(x for x in lines if x.startswith("served"))
    pipe = deploy("nllb600m", "int4", smoke=True, device="cpu", slots=4, max_len=32,
                  paged=True, page_size=4, draft_spec="nf4", horizon=4,
                  matmul_impl="torch", paged_attn_impl="gather")
    cfg = reduce_config(get_config("nllb600m"))
    ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=0)
    reqs = []
    for _ in range(4):
        b = ds.sample(1)
        reqs.append({"src_tokens": b["src_tokens"], "tgt_in": b["tgt_in"][:, :1]})
    outs = [pipe.generate([r], SamplingParams(max_new_tokens=6, seed=i))[0]
            for i, r in enumerate(reqs)]
    assert got == {i: (o.finish_reason, o.token_ids) for i, o in enumerate(outs)}


def test_launcher_max_pending_prints_saturated(capsys):
    """Paged admission waits for the next round, so a queue of 2 fills:
    the launcher steps and retries, and the fault line counts the
    rejections."""
    lines = run_port(capsys, "--paged", "--max-pending", "2", "--requests", "6")
    sat = [x for x in lines if x.startswith("saturated")]
    assert sat and all(x.startswith("saturated (2/2 pending), stepping + retrying")
                       for x in sat)
    assert len(streams(lines)) == 6
    assert f"{len(sat)} admission rejections" in lines[-1]


@pytest.mark.parametrize("flags", [["--policy", "w8a8", "--paged", "--page-size", "4"],
                                   ["--policy", "fp8e2e"],
                                   ["--draft-spec", "w4a8kv8", "--paged", "--page-size", "4"]],
                         ids=["w8a8-paged", "fp8e2e-dense", "w4a8kv8-draft"])
def test_launcher_serves_act_and_fp8_specs(capsys, flags):
    """--policy and --draft-spec take the act-quantizing and fp8 specs, as
    the reference's do; the launcher calibrates nothing, so an act spec
    warns that it quantizes dynamically per token."""
    with pytest.warns(UserWarning, match="dynamic per-token"):
        lines = run_port(capsys, *flags)
    assert len(streams(lines)) == 4
    policy = flags[1] if flags[0] == "--policy" else "int4"
    assert f"({policy} = {resolve_spec(policy)}, " in lines[0]


@pytest.mark.parametrize("mesh", ["tp2", "dp2", "dp2,tp2"])
def test_launcher_scale_out_raises(capfd, mesh):
    """``--mesh tp2`` serves on two gloo CPU ranks (rank 0 prints),
    ``--mesh dp2`` through two routed replicas and ``--mesh dp2,tp2`` on
    four ranks, two tensor-parallel replicas behind the replicated router:
    the same [req N] streams as the single engine."""
    argv = [*SMOKE, "--impl", "torch", "--device", "cpu", "--paged"]
    serve.main(argv)
    want = streams(capfd.readouterr().out.splitlines())
    serve.main([*argv, "--mesh", mesh])
    lines = capfd.readouterr().out.splitlines()
    assert streams(lines) == want and len(want) == 4
    head = {"tp2": "tensor parallel: tp2 ('model',) mesh", "dp2": "cluster: 2 replicas x tp1",
            "dp2,tp2": "cluster: 2 replicas x tp2 over 4 ranks"}[mesh]
    assert any(line.startswith(head) for line in lines), lines[:3]
    if mesh != "dp2":
        assert any("over gloo" in line for line in lines)
    assert sum(line.startswith("served 4 requests") for line in lines) == 1


def test_launcher_quant_arms_under_a_mesh(capfd):
    """``--mesh tp2 --policy w8a8 --draft-spec nf4``: two gloo CPU ranks
    serve the act-quantizing target (dynamic per-token scales, the
    row-parallel ones the ranks' absmax) with its nf4 draft arm, and
    rank 0 prints the single engine's [req N] streams and draft line."""
    argv = [*SMOKE, "--impl", "torch", "--device", "cpu", "--paged", "--policy", "w8a8",
            "--draft-spec", "nf4"]
    with pytest.warns(UserWarning, match="dynamic per-token"):
        serve.main(argv)
    want = streams(capfd.readouterr().out.splitlines())
    serve.main([*argv, "--mesh", "tp2"])
    lines = capfd.readouterr().out.splitlines()
    assert streams(lines) == want and len(want) == 4
    assert any(line.startswith("tensor parallel: tp2") for line in lines), lines[:3]
    assert any(line.startswith("speculative draft arm: nf4 = wnf4kv8dq") for line in lines)
    served = [line for line in lines if line.startswith("served 4 requests")]
    assert len(served) == 1 and "verify rounds" in served[0]


def test_launcher_clock_arms_and_metrics_port_over_dp_tp(capfd):
    """``--mesh dp2,tp2 --metrics-port 0 --sla-ttft-ms 1 --deadline-ms
    600000``: four gloo CPU ranks serve under the SLA controller and the
    deadlines (each group's rank 0 decides), rank 0 serves the snapshot
    that every rank refreshes once a round, and prints the live endpoint,
    the four requests, the ``faults:`` line and the ``sla:`` line."""
    serve.main([*SMOKE, "--impl", "torch", "--device", "cpu", "--paged", "--mesh", "dp2,tp2",
                "--metrics-port", "0", "--sla-ttft-ms", "1", "--deadline-ms", "600000"])
    lines = capfd.readouterr().out.splitlines()
    assert sum(line.startswith("metrics: live at http://127.0.0.1:") for line in lines) == 1
    got = streams(lines)
    assert sorted(got) == [0, 1, 2, 3] and all(r == "length" for r, _ in got.values())
    assert any(line.startswith("faults: 0 preemptions (0 resumed), 0 deadline expirations")
               for line in lines)
    sla = [line for line in lines if line.startswith("sla: target ttft_p95 1.0 ms")]
    assert len(sla) == 1 and "retunes" in sla[0], lines[-4:]


def test_launcher_unit_mesh_and_bad_specs(capsys):
    """dp1,tp1 is the single engine; a bad mesh or policy fails before
    any build work."""
    assert len(streams(run_port(capsys, "--mesh", "dp1,tp1", "--requests", "1"))) == 1
    with pytest.raises(ValueError, match="mesh factor"):
        run_port(capsys, "--mesh", "pp2")
    with pytest.raises(ValueError, match="unknown quantization spec"):
        run_port(capsys, "--policy", "w3")
