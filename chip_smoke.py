#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card's name and power limit; build the CUDA kernels (one nvcc per
   source, in parallel) and compile the Triton kernels;
2. each of the five kernels against its plain PyTorch version on CUDA
   tensors, at the reference tests' shapes and at the shapes of the
   served path, with times (CUDA events) of kernel, plain version, one
   library call for the same function, and the least time the card
   could take; and qmm with the FASST activation in its epilogue
   (``qmm_naf``, the served FFN-in route at decode rows) against the
   plain versions and against qmm then FASST;
3. full-width NLLB-600M, int4 weights, int8 embedding, paged int8 KV:
   deploy(paged=True) serves 8 requests through the kernels, with every
   launch counter set to 0 just before and read just after ([serve]);
   decode rows carry the FFN activation in qmm's epilogue, the encoder's
   prefill rows take qmm, then the FASST kernel;
4. one decode step of the served engine state through the "kernels" and
   the "torch" route bundles: logits agree within the reference engine's
   int8-KV bound ([routes]);
5. where one decode micro-step's time goes (torch.profiler), and its
   launches (exactly one qmm_naf per layer, no FASST launch);
6. deploy() with its defaults (the dense int8 KV engine) serves the same
   8 requests on the same weights ([serve-dense]), profiled as in 5,
   greedy and sampled; its greedy streams equal the paged engine's, or
   part only at a near tie ([dense-vs-paged]);
7. seeded temperature / top-p requests on both engines: in the
   vocabulary, repeatable, and dense equal to paged up to near ties
   ([sampled]);
8. on-demand paging on a 10-page pool, where whole budgets would need
   24: every request ends ``length`` with preempt_limit 16 (overlapped
   and serial rounds), some end ``preempted_limit`` with preempt_limit 0,
   streams equal [serve]'s or part only where a prefill replay's rounding
   meets a near tie, the allocator clean after each drain
   ([serve-preempt]);
9. overlapped against serial rounds, paged and dense: token-identical,
   with host wall per step, tokens/s and idle share, and one steady
   overlapped round traced with exactly one host wait on the device
   ([overlap]); streaming and a mid-stream abort ([stream]); the
   engine's TTFT / TPOT percentiles and a traced run token-identical to
   the untraced one ([metrics]);
10. speculative decoding on [serve]'s prompts and weights: a paged
   engine with an nf4 draft arm and a dense one with an int4 draft (the
   target itself, so every drafted token is accepted); greedy streams
   equal [serve]'s and [serve-dense]'s up to near ties; the draft's
   served FFN-in, fused with its NAF, within the plain versions' bound;
   one round of lookahead K launches qmm 96 x K and (paged) paged_attn
   12 x K times and waits on the device once ([spec]);
11. fault injection on the [serve] configuration: a page steal that
   forces preemption, a NaN on one slot, a clock skew past two requests'
   deadlines and a submit past max_pending; survivors equal [serve]'s
   streams, casualties keep prefixes, the allocator is clean ([faults]);
12. the serving launcher, ``python -m repro_torch.launch.serve``, in a
   process of its own on the card ([launch]);
13. the quantization routes on [serve]'s prompts and raw weights, one
   deploy per arm: w8a8 (integer matmuls) calibrated, fp8e2e paged and
   dense (float8 pools, streams equal up to near ties), w4a8kv8
   calibrated (fake-quantized qmm inputs, kernels vs torch bundle) and
   int4 with QLoRA adapters (no epilogue NAF for an adapted FFN-in, the
   served FFN-in against the plain relu(x @ W + lora)); tokens/s, a
   profiled horizon and the launches of each arm ([quant]);
14. training ([train]): one f32 step of the reduced config on the card
   against the CPU (loss, every gradient leaf, the update); full-width
   NLLB-600M training with f32 AdamW, 8-bit moments and QLoRA on an nf4
   base (loss finite and falling, the base unchanged), a checkpoint save
   and restore byte-equal; step ms, tokens/s, peak memory, model FLOPs;
15. the quality grid ([eval]): the reduced config trained by the port's
   TrainLoop (the reference test's fit), swept over bf16 / int8 / int4 /
   fp4 / nf4 / w8a8 / fp8e2e through the "kernels" bundle with the
   reference test's quality bars, the int8 grid dense against paged and
   overlapped against serial rounds, and the [train] weights deployed at
   full width (int4, paged) and scored on hin<->eng;
16. the ops API path of the dense decode attention, the row softmax and
   the standalone FASST activation, driven on the dense engine's live
   caches, logits and FFN weights, with the launch counters set to 0
   just before and read just after ([api]);
17. LM training ([train-lm]): one f32 AdamW step with remat of each LM
   family's reduced config on the card against the CPU (qwen2.5-14b,
   gemma3-1b, llava-next-mistral-7b with image rows, olmoe-1b-7b,
   mamba2-780m, recurrentgemma-9b); then full width, 6 or 20 steps
   each with the loss falling: gemma3-1b whole (f32 AdamW, remat, two
   microbatches, 4 x 640 tokens past its 512-token windows), mamba2-780m
   whole (8 x 256, two SSD chunks) and olmoe-1b-7b cut to 3 of its 16
   layers (8 x 64, the aux loss finite), then 8-bit AdamW on that cut
   (the loss finite); step ms, tokens/s, peak memory, one profiled step
   each, and no kernel launch;
18. the decoder-only LMs, each deploy freed before the next: qmm and
   paged attention at qwen2.5-14b's served shapes against their plain
   versions; qwen2.5-14b at full width, 12 of its 48 layers, int4 paged
   and dense ([lm]); gemma3-1b at full width, 13 of its 26 layers, paged
   and dense, prompts past its 512-token local windows and no
   paged-attention launch ([lm-gemma]);
   llava-next-mistral-7b at 16 of its 32 layers, dense, with image rows
   ([vlm]). Each
   engine holds qmm and the FASST activation against their plain
   versions at every shape its warm-up gave them; each phase checks the
   kernel bundle against the torch bundle, and dense against paged up
   to near ties (a first token may part there at an exact bf16 tie);
19. (run right after [quant], before the scale-out phases, which hold
   their ranks to these streams) the MoE, audio and SSM families, int4:
   olmoe-1b-7b (8 of 16 layers) paged and
   dense ([moe], [moe-dense]; 64 experts top-8, the experts' SiLU
   through the FASST kernel on 4-D inputs), whisper-base paged and dense
   on 1500 random frames a request ([audio], [audio-dense]) and
   nllb600m-moe paged on [serve]'s prompts ([moe-nllb]); each engine
   holds qmm, the FASST activation and the paged attention at every
   shape its warm-up gave them, runs twice with every stream repeated
   bit for bit, meets the kernel bundle within the torch bundle's bound,
   and parts from the other layout only at near ties (an MoE slot routed
   to other experts at a router near tie is exempt from then on); the
   paged attention is timed at the served shapes; then mamba2-780m whole,
   dense (as in the reference: no paged cache, no draft arm) on 8 prompts
   of 256-512 tokens, one of prime length (one-row SSD chunks) ([ssm];
   qmm alone, at the in_proj's N 6448, no multiple of 64, held against
   its plain version at decode and prefill rows and timed over one decode
   step), held as 20 says;
20. (after the LM phases) recurrentgemma-9b whole, int4, dense, on 8
   prompts of 2100-2400 tokens, past its
   2048-token local window, so the rolling KV buffer wraps in prefill and
   again in decode ([hybrid]; qmm and the FASST activation on the RG-LRU
   gates and the GELU-GLU); each recurrent engine holds its kernels at
   every shape its warm-up gave them, launches exactly the counts a
   decode step derives from the model, meets the torch bundle's bound and
   repeats its 8 streams bit for bit on a second run;
21. scale-out on [serve]'s prompts and weights: two tensor-parallel
   ranks sharing the card over gloo (``cluster.launch_ranks``; NCCL
   refuses two ranks on one device), each deploy(mesh=tp_mesh(2)) of
   full-width nllb600m int4, paged ([tp]) then dense ([tp-dense]): both
   ranks' streams equal, the single-device engine's up to near ties
   replayed on both sides, qmm, the FASST activation and the paged
   attention held at every shard shape, a decode step's launches exactly
   one device's, each rank's resident bytes and deploy peak printed
   beside the single device's; inside the same ranks the int8
   compressed all-reduce on the card byte-equal to the CPU's
   ([compress]); in the same two ranks, gemma3-1b cut to 13 of its 26
   layers (its one KV head copied on both ranks; against one device's
   engine of the cut), paged ([tp-lm]) then dense ([tp-lm-dense]), on
   [lm-gemma]'s prompts past its 512-token windows, and qwen2.5-14b at
   full width cut to 4 of its 48 layers, paged ([tp-qwen]; the single
   device's streams served before the spawn), each held as [tp] is;
   then expert parallelism and the audio mesh, paged: nllb600m-moe
   whole on [serve]'s prompts ([tp-moe], 8 of 16 experts a rank) and
   whisper-base whole, its vocabulary replicated ([tp-audio]), against
   the streams of 19, and olmoe-1b-7b cut to 4 of its 16 layers on
   [moe]'s prompts ([tp-olmoe], 32 of 64 experts a rank), against a
   single-device engine of that cut served in the spawn; each MoE engine
   run twice with the same bits; then the SSM and hybrid meshes, dense:
   mamba2-780m whole on [ssm]'s prompts against [ssm]'s streams
   ([tp-ssm], 24 of 48 SSD heads a rank) and recurrentgemma-9b at full
   width cut to 5 of its 38 layers on [hybrid]'s prompts, past its window,
   against a single-device engine of that cut served in the spawn
   ([tp-hybrid], half the RG-LRU channels a rank), each with its
   collectives a decode step held exactly; then the quantization arms
   under the mesh, full-width nllb600m paged on [quant]'s raw weights and
   calibration batches: w8a8 and w4a8kv8 calibrated on the shards (every
   rank's site table equal), fp8e2e dynamic (every rank's row-parallel
   codes and per-token scales one device's bit for bit) and int4 with
   [quant]'s QLoRA adapters ([tp-quant-<arm>]), each against [quant]'s
   streams up to near ties, every step teacher-forced within its bound,
   a step's collectives exactly [tp]'s plus one max a row-parallel site
   for fp8e2e; and the int4 target with a calibrated w4a8kv8 draft arm
   ([tp-spec]): every rank's acceptance counters equal, the streams
   [tp]'s target-only streams up to near ties; on [tp]'s engine, before
   it is freed, the clock-driven arms under the mesh: [faults]'s plan
   ([tp-faults]: every rank's reasons, events and counters equal,
   survivors [tp]'s streams up to a resume's near tie, casualties
   prefixes, the pool clean; then again with rank 1's clock an hour
   ahead, every rank taking rank 0's expiries) and an SLA target that
   retunes at every window ([tp-sla]: every rank's controller equal
   after every round, the streams prefixes of [tp]'s), each broadcasting
   exactly once a round and summing exactly [tp]'s collectives a decode
   step; the tp phases run no warm-up (each holds its kernels at the
   shapes of its measured run);
   then three ranks sharing the card over gloo (any tp: a width 3 does
   not divide is replicated): full-width nllb600m int4, whose 16 heads,
   4096 FFN columns and 256204-token vocabulary 3 divides none of, paged
   ([tp3]: the attention's pool whole, no collective, every rank's
   streams [serve]'s bit for bit) and dense at max_len 42 ([tp3-dense]:
   the self-attention cache split 14 rows a rank, every rank's block
   reached, 2 collectives a layer a decode step), then gemma3-1b cut to
   13 layers, dense at 768 ([tp3-lm]: its 4 heads replicated with the
   cache split 256 rows a rank, its 6912 FFN columns split 2304 a rank;
   2 + 1 collectives a layer) on [lm-gemma]'s prompts, against [tp-lm-
   dense]'s single device; each held as [tp] is, with its collectives a
   decode step held exactly, and both dense phases' teacher-forced
   logits held to TP3_LOGIT_TOL at every step;
   then two routed replicas on the card (deploy_replicas, [dp]): each
   replica's streams a lone engine's bit for bit, [serve]'s up to near
   ties, the merged metrics the sums; then the composed stack on four
   ranks sharing the card over gloo (deploy_replicas(replicas=2, tp=2),
   [dp-tp]): every rank's outputs equal, the placements [dp]'s, each
   replica a lone tp2 engine's bit for bit and one device's up to near
   ties, a decode step's launches a tp2 rank's, the merged metrics the
   sums, every rank's ``on_token`` streams the drained outputs;
22. a launch-count line, the kernels' JSON line, the card line, and last
   {"ok": true, "device": {...}}.

It needs a CUDA device and the repository's ``src/repro_torch``; without
either it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_MS = 3.35e12 / 1e3
BF16_FLOPS_PER_MS = 989e12 / 1e3
F32_FLOPS_PER_MS = 67e12 / 1e3

SEED = 0
SLOTS, MAX_LEN, PAGE, HORIZON, GEN = 8, 128, 16, 16, 32


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 10):
    """Device time of one ``fn()`` alone: the self device time of every
    kernel that ``torch.profiler`` records over ``reps`` calls, per call
    (host gaps between launches left out). None where two profiles in a
    row record no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):          # a profile now and then records no device event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    return None


def times(kernel, plain, library, plain_reps: int = 5) -> dict:
    """CUDA-event times of the kernel, its plain version and the library
    call (host gaps inside the window included), and the device-only
    times of the kernel and the library call."""
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain, reps=plain_reps),
            "library_ms": cuda_ms(library), "device_ms": device_ms(kernel),
            "library_device_ms": device_ms(library)}


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def log_time(e, card, pre=""):
    """The [time] line of a kernel entry's timed work (keys ``pre``...)."""
    log(f"[time] {e['name']}{' ' + pre.rstrip('_') if pre else ''}: kernel "
        f"{e[pre + 'ms']:.4f} ms, plain {e[pre + 'plain_ms']:.4f} ms, library "
        f"{fmt_ms(e[pre + 'library_ms'])}, bound {e[pre + 'bound_ms']:.4f} ms "
        f"({e[pre + 'bound_by']}); device only: kernel {fmt_ms(e[pre + 'device_ms'])}, "
        f"library {fmt_ms(e[pre + 'library_device_ms'])} — {e[pre + 'work']}; on {card}")


def _short(fn: str) -> str:
    """A demangled kernel name without namespaces and parameter list."""
    return fn.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")


def _demangle(names):
    tool = shutil.which("c++filt")
    if not (tool and names):
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         timeout=60)
    out = res.stdout.splitlines() if res.returncode == 0 else names
    return {n: _short(d) for n, d in zip(names, out)}


def ptxas_lines(text: str):
    """(kernel, what ptxas said) for every kernel in ``nvcc -Xptxas -v``
    output: registers, barriers and shared memory, and spills where
    there are any, one line per kernel instance."""
    fn, said = "?", {}
    for line in text.splitlines():
        line = line.strip()
        if "Function properties for " in line:
            fn = line.split("Function properties for ", 1)[1].strip()
        elif "Compiling entry function '" in line:
            fn = line.split("'")[1]
        elif "registers" in line:
            said.setdefault(fn, []).insert(0, line.removeprefix("ptxas info    : "))
        elif "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
            said.setdefault(fn, []).append(line)
    names = _demangle(sorted(said))
    return sorted((names[f], "; ".join(v)) for f, v in said.items())


def log_sass(name: str, lib: Path) -> None:
    """Where cuobjdump exists, how many tensor-core instructions (HMMA /
    HGMMA) the SASS of each kernel instance in ``lib`` holds."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log(f"[sass {name}] cuobjdump not found: not checked")
        return
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        log(f"[sass {name}] cuobjdump failed ({res.returncode}): {res.stderr[-300:]}")
        return
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    names = _demangle(sorted(counts))
    for regime in ("Prefill", "Decode"):
        ns = sorted(n for f, n in counts.items() if regime in f)
        log(f"[sass {name}] {regime.lower()} rows: {len(ns)} kernel instances, "
            f"HMMA/HGMMA instructions per instance {min(ns, default=0)}..{max(ns, default=0)}"
            f" (e.g. {next((names[f] for f in counts if regime in f), '-')})")
    if not counts or not all(counts.values()):
        raise AssertionError(f"[sass {name}] a kernel instance has no tensor-core "
                             f"instruction: {counts}")


def bound_ms(nbytes: float, flops: float, flops_per_ms: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, flops / flops_per_ms
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# the CPU tests' shapes; then every regime and edge: M on both sides of
# the decode/prefill switch and of the 16-row tile, N not a multiple of
# any tile (96 under one 128-column tile, 1000, and 1001, odd, whose rows
# are not 16-byte aligned), K split unevenly (1344 = 21 slabs, 1008 with
# a ragged last slab) and sub_block 16 / 32 / 64 / 128, and an odd
# sub_block (45: a pair of k straddles two scale rows) on rows that are not
# 16-byte aligned; then the served (K, N) shapes at decode and prefill rows
QMM_SERVED_KN = ((1024, 1024), (1024, 8192), (8192, 1024))
QMM_CASES = ([(8, 128, 64, 32), (48, 256, 128, 64), (1, 64, 96, 16), (130, 512, 256, 128)]
             + [(m, k, n, b) for m in (1, 8, 15, 16, 17, 64, 130, 512)
                for k, n, b in ((1344, 1000, 64), (1008, 96, 16), (960, 1001, 32),
                                (1536, 1000, 128))]
             + [(m, 90, 40, 45) for m in (8, 130)]
             + [(m, k, n, 64) for k, n in QMM_SERVED_KN for m in (1, 8, 64, 512)]
             # the reduced config of [eval]: d 64, d_ff 96 (FFN-out blocks
             # of 96), at decode rows (4 slots) and prefill rows (4 x 12)
             + [(m, k, n, b) for m in (4, 48)
                for k, n, b in ((64, 64, 64), (64, 96, 64), (96, 64, 96))])


def qmm_tol(torch, dt):
    """qmm's norm-relative bound against qmm_plain. f32 out: same bf16
    rounding points, only the f32 sum order differs (CPU test bound). bf16
    out: the two f32 sums round to bf16 independently, at most one bf16
    ulp (2^-8 relative) apart element by element."""
    return 1e-5 if dt == torch.float32 else 4e-3


def qmm_agree(torch, x, qt, where, naf=None):
    """Hold ops.qmm(x, qt) against qmm_plain on the f32 rows ``x``, f32 and
    bf16 out: two launches bit-identical (the split-K partials are summed
    in split order by the tile's last block), within qmm_tol, finite; with
    ``naf`` the fused epilogue within the plain versions' bound
    (naf_vs_plain). Returns the max abs error at f32 out and the plan."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.qmm import qmm_plain, qmm_plan
    k, n = qt.shape[-2:]         # a layer's select keeps the stacked shape
    m = x.shape[0]
    plan = qmm_plan(m, n, k, k // qt.scales_shape[-2], qt.fmt)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        xi = x.to(dt)
        y = ops.qmm(xi, qt, compute_dtype=dt, naf=naf)
        at = f"{where} {qt.fmt} M={m} K={k} N={n} {dt} ({plan})"
        if not torch.equal(y, ops.qmm(xi, qt, compute_dtype=dt, naf=naf)):
            raise AssertionError(f"{at}: two launches differ")
        p = qmm_plain(xi, qt.data, qt.block_scales(), qt.fmt, out_dtype=dt)
        if naf is not None:
            e = naf_vs_plain(torch, y, ops.qmm(xi, qt, compute_dtype=dt), p, naf, dt, at)
        else:
            y, p = y.float(), p.float()
            rel = float((y - p).norm() / (p.norm() + 1e-9))
            if not (rel <= qmm_tol(torch, dt) and bool(torch.isfinite(y).all())):
                raise AssertionError(f"{at}: rel err {rel:.3g} > {qmm_tol(torch, dt)}")
            e = float((y - p).abs().max())
        if dt == torch.float32:
            worst = e
    return worst, plan


def qmm_window(torch, g, dev, ws, m):
    """Kernel, plain and library calls over the int4 weights ``ws`` (sub-
    block 64) at M = m bf16 rows, one launch each, and the bound of that
    work."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.qmm import qmm_plain
    bf = torch.bfloat16
    xs = {k: torch.randn((m, k), generator=g, device=dev).to(bf)
          for k in sorted({qt.shape[0] for qt in ws})}
    dense = [qt.dequantize(bf) for qt in ws]
    scales = [qt.block_scales() for qt in ws]

    def run_kernel():
        for qt in ws:
            ops.qmm(xs[qt.shape[0]], qt, compute_dtype=bf)

    def run_plain():
        for qt, s in zip(ws, scales):
            qmm_plain(xs[qt.shape[0]], qt.data, s, "int4", out_dtype=bf)

    def run_library():
        for qt, wd in zip(ws, dense):
            torch.matmul(xs[qt.shape[0]], wd)

    nbytes = flops = 0
    for qt in ws:
        k, n = qt.shape
        nbytes += m * k * 2 + k * n // 2 + (k // 64) * n * 4 + m * n * 2
        flops += 2 * m * k * n
    return (run_kernel, run_plain, run_library), bound_ms(nbytes, flops, BF16_FLOPS_PER_MS)


def check_qmm(torch, dev):
    from repro_torch.core.qtensor import QTensor

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    regimes = set()
    for fmt in ("int4", "fp4", "nf4", "int8", "fp8"):
        for m, k, n, block in QMM_CASES:
            w = torch.randn((k, n), generator=g, device=dev) * 0.05
            qt = QTensor.quantize(w, fmt, block, double_quant=(fmt == "nf4"))
            x = torch.randn((m, k), generator=g, device=dev)
            err, plan = qmm_agree(torch, x, qt, f"qmm sub_block={block}")
            regimes.add((plan.regime, plan.splits > 1))
            if (k, n) in QMM_SERVED_KN:
                worst = max(worst, err)
    if regimes != {("decode", True), ("decode", False), ("prefill", True),
                   ("prefill", False)}:
        raise AssertionError(f"qmm cases cover only {sorted(regimes)}")
    log(f"[kernels] qmm: 5 formats x {len(QMM_CASES)} shapes x (f32, bf16) agree with "
        f"qmm_plain (norm-relative 1e-5 f32, 4e-3 bf16), decode and prefill rows, one "
        f"and several K splits; every case launched twice, bit-identical; max abs err "
        f"at the served shapes (f32 out) {worst:.3g}")

    # one decode step's qmm work at M = slots: 6 layers x (self q,k,v,o +
    # cross q,o at 1024x1024, ffn in 1024x8192, ffn out 8192x1024), every
    # launch on its own int4 weight as in the model (78 MB > the 50 MB L2)
    shapes = [(1024, 1024)] * 6 + [(1024, 8192), (8192, 1024)]
    weights = []
    for _ in range(6):
        for k, n in shapes:
            w = torch.randn((k, n), generator=g, device=dev) * 0.05
            weights.append(QTensor.quantize(w, "int4", 64))
    fns, (t, by) = qmm_window(torch, g, dev, weights, SLOTS)
    entry = {"name": "qmm", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/qmm.cu",
             "replaces": "src/repro/kernels/qmm.py:85",
             "max_abs_err": worst, **times(*fns), "bound_ms": t, "bound_by": by}
    # prefill rows: one launch on each served (K, N) shape, at the dense
    # engine's 64-row admission and a batched 512-row one
    firsts = [weights[0], weights[6], weights[7]]
    for m in (64, 512):
        fns, (t, by) = qmm_window(torch, g, dev, firsts, m)
        for key, val in times(*fns).items():
            entry.setdefault(f"prefill_{key}", {})[f"M={m}"] = val
        entry.setdefault("prefill_bound_ms", {})[f"M={m}"] = t
        entry.setdefault("prefill_bound_by", {})[f"M={m}"] = by
    entry["work"] = (f"one decode step: 48 int4 launches at M={SLOTS} (36 of 1024x1024, "
                     "6 of 1024x8192, 6 of 8192x1024); prefill: one int4 launch on each "
                     "of 1024x1024, 1024x8192, 8192x1024 at M=64 and at M=512")
    return entry


def fasst_tol(torch, p, dt):
    """The FASST activation's bound against its plain version: 1e-5 abs
    in f32 (the CPU test bound); in bf16 one bf16 ulp (the two f32 results
    may round to adjacent bf16 values), at most 2^-7 of the value, beside
    the CPU test's 2e-2."""
    return 1e-5 if dt == torch.float32 else torch.clamp(p.abs() * 2.0 ** -7, min=2e-2)


# how far each NAF can move a change of its input, the largest |naf'|:
# |naf(a) - naf(b)| <= NAF_LIP * |a - b| (squared_relu: (|a| + |b|) |a - b|)
NAF_LIP = {"relu": 1.0, "sigmoid": 0.25, "tanh": 1.0, "gelu": 1.13, "silu": 1.1,
           "selu": 1.76, "identity": 1.0}


def naf_vs_plain(torch, fused, y, q, mode, dt, where):
    """Hold the kernel's fused output against the plain versions on the same
    inputs, fasst_act_plain(q, mode): ``y`` is the kernel's qmm output (NAF
    identity), ``q`` qmm_plain's. y must be within qmm's bound of q; then
    each fused value within qmm's error |y - q|, as far as the NAF can move
    it, plus the FASST bound. Returns the largest abs error."""
    from repro_torch.kernels.fasst import fasst_act_plain
    y32, q32 = y.float(), q.float()
    rel = float((y32 - q32).norm() / (q32.norm() + 1e-9))
    if not rel <= qmm_tol(torch, dt):
        raise AssertionError(f"{where}: qmm rel err {rel:.3g} > {qmm_tol(torch, dt)} "
                             "against qmm_plain")
    p = fasst_act_plain(q, mode).float()
    lip = y32.abs() + q32.abs() if mode == "squared_relu" else NAF_LIP[mode]
    err = (fused.float() - p).abs()
    if not bool((err <= lip * (y32 - q32).abs() + fasst_tol(torch, p, dt)).all()):
        raise AssertionError(f"{where}: max abs err {float(err.max()):.3g} against "
                             "fasst_act_plain(qmm_plain)")
    return float(err.max())


# the FFN-in shape of the served model, the decode and prefill rows, and
# an odd N (rows not 16-byte aligned: the element-by-element epilogue)
# at one and several K splits
QMM_NAF_CASES = ([(m, 1024, 8192, 64) for m in (8, 64, 512)]
                 + [(m, 960, 1001, 32) for m in (8, 130)]
                 + [(4, 64, 96, 64)])         # [eval]'s reduced FFN-in


def check_qmm_naf(torch, dev, card):
    """The FASST activation in qmm's epilogue: ops.qmm(x, w, naf=m) against
    the plain versions, fasst_act_plain(qmm_plain(x, w), m), and bit for
    bit or within the FASST bound against ops.fasst(ops.qmm(x, w), m),
    every mode; then one decode step's 6 FFN-in launches fused against 6
    qmm + 6 FASST launches."""
    from repro_torch.core.qtensor import QTensor
    from repro_torch.kernels import ops
    from repro_torch.kernels.fasst import MODES, fasst_act_plain
    from repro_torch.kernels.qmm import qmm_plain, qmm_plan

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    exact = ("relu", "identity", "squared_relu")
    worst = worst_plain = 0.0
    for fmt in ("int4", "fp4", "nf4"):
        for m, k, n, block in QMM_NAF_CASES:
            w = torch.randn((k, n), generator=g, device=dev) * 0.05
            qt = QTensor.quantize(w, fmt, block, double_quant=(fmt == "nf4"))
            x = torch.randn((m, k), generator=g, device=dev)
            plan = qmm_plan(m, n, k, block, fmt)
            for dt in (torch.float32, torch.bfloat16):
                xi = x.to(dt)
                y = ops.qmm(xi, qt, compute_dtype=dt)
                q = qmm_plain(xi, qt.data, qt.block_scales(), fmt, out_dtype=dt)
                for mode in MODES:
                    where = (f"qmm naf={mode} {fmt} M={m} K={k} N={n} {dt} "
                             f"({plan.regime}, {plan.splits} splits)")
                    fused = ops.qmm(xi, qt, compute_dtype=dt, naf=mode)
                    if not torch.equal(fused, ops.qmm(xi, qt, compute_dtype=dt, naf=mode)):
                        raise AssertionError(f"{where}: two launches differ")
                    e = naf_vs_plain(torch, fused, y, q, mode, dt, where)
                    if dt == torch.float32:
                        worst_plain = max(worst_plain, e)
                    p = ops.fasst(y, mode)
                    if mode == "identity" and not torch.equal(fused, y):
                        raise AssertionError(f"{where}: not qmm's output bit for bit")
                    if mode in exact:
                        if not torch.equal(fused, p):
                            raise AssertionError(f"{where}: not ops.fasst(ops.qmm) bit "
                                                 "for bit")
                        continue
                    err = (fused.float() - p.float()).abs()
                    if not bool((err <= fasst_tol(torch, p.float(), dt)).all()):
                        raise AssertionError(f"{where}: max abs err {float(err.max()):.3g} "
                                             "against ops.fasst(ops.qmm)")
                    if (k, n) == (1024, 8192) and dt == torch.float32:
                        worst = max(worst, float(err.max()))
    log(f"[kernels] qmm_naf: 8 modes x int4/fp4/nf4 (nf4 double-quantized) x "
        f"M={sorted({c[0] for c in QMM_NAF_CASES})} "
        f"(1024x8192 and 960x1001, one and several K splits) x f32/bf16: "
        f"every mode within fasst_act_plain(qmm_plain) (qmm's bound, carried through the "
        f"NAF, plus the FASST bound; max abs err f32 {worst_plain:.3g}); "
        f"{'/'.join(exact)} equal ops.fasst(ops.qmm) bit for bit (identity also plain "
        f"qmm), the others within the FASST bound (1e-5 f32, one bf16 ulp); every case "
        f"launched twice, bit-identical; max abs err of the inexact modes against "
        f"ops.fasst(ops.qmm) at 1024x8192 f32 {worst:.3g}")

    # one decode step's FFN-in work: 6 int4 1024x8192 launches at M = slots
    # with relu, each on its own weight (the model's 6 decoder layers)
    ws = [QTensor.quantize(torch.randn((1024, 8192), generator=g, device=dev) * 0.05,
                           "int4", 64) for _ in range(6)]
    xs = [torch.randn((SLOTS, 1024), generator=g, device=dev).to(torch.bfloat16)
          for _ in range(6)]
    scales = [qt.block_scales() for qt in ws]
    bf = torch.bfloat16

    def fused():
        for x, qt in zip(xs, ws):
            ops.qmm(x, qt, compute_dtype=bf, naf="relu")

    def unfused():
        for x, qt in zip(xs, ws):
            ops.fasst(ops.qmm(x, qt, compute_dtype=bf), "relu")

    def plain():
        for x, qt, sc in zip(xs, ws, scales):
            fasst_act_plain(qmm_plain(x, qt.data, sc, "int4", out_dtype=bf), "relu")

    # an encoder prefill's FFN-in launch: 512 rows on the first weight
    x512 = torch.randn((512, 1024), generator=g, device=dev).to(bf)
    prefill = {"fused": lambda: ops.qmm(x512, ws[0], compute_dtype=bf, naf="relu"),
               "unfused": lambda: ops.fasst(ops.qmm(x512, ws[0], compute_dtype=bf), "relu"),
               "qmm": lambda: ops.qmm(x512, ws[0], compute_dtype=bf)}
    prefill = {k: device_ms(fn) for k, fn in prefill.items()}
    nbytes = 6 * (SLOTS * 1024 * 2 + 1024 * 8192 // 2 + 16 * 8192 * 4 + SLOTS * 8192 * 2)
    t, by = bound_ms(nbytes, 6 * 2 * SLOTS * 1024 * 8192, BF16_FLOPS_PER_MS)
    entry = {"name": "qmm_naf", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/qmm.cu",
             "replaces": "src/repro/kernels/fasst.py:63",
             "max_abs_err": worst_plain, "ms": cuda_ms(fused), "plain_ms": cuda_ms(plain, reps=5),
             "library_ms": None, "device_ms": device_ms(fused), "library_device_ms": None,
             "unfused_ms": cuda_ms(unfused), "unfused_device_ms": device_ms(unfused),
             "prefill_device_ms": {"M=512": prefill["fused"]},
             "prefill_unfused_device_ms": {"M=512": prefill["unfused"]},
             "prefill_qmm_device_ms": {"M=512": prefill["qmm"]},
             "bound_ms": t, "bound_by": by,
             "work": f"one decode step's FFN in: 6 int4 1024x8192 launches at M={SLOTS}, bf16, "
                     "relu in the epilogue (unfused: 6 qmm + 6 fasst_act launches; no one "
                     "PyTorch call computes relu(x @ W))"}
    log(f"[time] qmm_naf x6 fused {entry['ms']:.4f} ms (device {fmt_ms(entry['device_ms'])}), "
        f"qmm + fasst_act x6 {entry['unfused_ms']:.4f} ms (device "
        f"{fmt_ms(entry['unfused_device_ms'])}); one prefill launch at M=512: fused device "
        f"{fmt_ms(prefill['fused'])}, qmm + fasst_act {fmt_ms(prefill['unfused'])}, qmm "
        f"alone {fmt_ms(prefill['qmm'])}; on {card}")
    return entry


def _pool(torch, g, dev, P, ps, Hkv, d, kind):
    from repro_torch.kernels import ops
    k = torch.randn((P, ps, Hkv, d), generator=g, device=dev)
    v = torch.randn((P, ps, Hkv, d), generator=g, device=dev)
    if kind == "bf16":
        return k.to(torch.bfloat16), None, v.to(torch.bfloat16), None
    if kind == "int8":
        kc, ks = ops.quantize_kv(k)
        vc, vs = ops.quantize_kv(v)
        return kc, ks, vc, vs
    ks = k.abs().amax(-1).clamp_min(1e-6) / 448.0
    vs = v.abs().amax(-1).clamp_min(1e-6) / 448.0
    return ((k / ks[..., None]).to(torch.float8_e4m3fn), ks,
            (v / vs[..., None]).to(torch.float8_e4m3fn), vs)


def _paged_call(torch, q, kc, ks, vc, vs, tables, lens):
    from repro_torch.kernels import ops
    return ops.paged_decode_attention(q, kc, vc, tables, lens, k_scales=ks,
                                      v_scales=vs, out_dtype=torch.float32)


def paged_case(torch, g, dev, B, H, Hkv, d, P, ps, maxp, lengths, kind,
               q_dt=None, name=None, plans=None):
    """One paged-attention case on a random pool: launched twice
    (bit-identical), held against paged_attn_plain (< 1e-5), zero-length
    rows exactly 0. Returns the max abs error; records the split plan of
    a named int8 case in ``plans``."""
    from repro_torch.kernels.paged_attn import paged_attn_plain, paged_attn_plan
    q_dt = q_dt or torch.float32
    kc, ks, vc, vs = _pool(torch, g, dev, P, ps, Hkv, d, kind)
    perm = 1 + torch.randperm(P - 1, generator=g, device=dev)
    tables = perm[:B * maxp].reshape(B, maxp).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, d), generator=g, device=dev).to(q_dt)
    out = _paged_call(torch, q, kc, ks, vc, vs, tables, lens)
    where = f"paged_attn {kind} B={B} H={H} Hkv={Hkv} d={d} ps={ps} lengths {lengths}"
    # the splits are merged in split order by the last block of each
    # (row, kv head): reruns are bit-identical
    if not torch.equal(out, _paged_call(torch, q, kc, ks, vc, vs, tables, lens)):
        raise AssertionError(f"{where}: two launches differ")
    ref = paged_attn_plain(q.reshape(B, Hkv, H // Hkv, d), kc, ks, vc, vs,
                           tables, lens, d ** -0.5).reshape(B, H, d)
    err = float((out - ref).abs().max())
    if not err < 1e-5:
        raise AssertionError(f"{where}: max abs err {err:.3g}")
    if not bool((out[lens == 0] == 0).all()):
        raise AssertionError(f"{where}: a zero-length row is not exactly zero")
    if name and kind == "int8" and plans is not None:
        plan = paged_attn_plan(B, Hkv, H // Hkv, d, ps, maxp, kv_bytes=kc.element_size())
        plans[name] = f"{plan.splits} splits x {plan.tokens_per_split} tokens"
    return err


def check_paged_attn(torch, dev):
    from repro_torch.kernels.paged_attn import paged_attn_plan

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = 0.0
    plans = {}

    def call(q, kc, ks, vc, vs, tables, lens):
        return _paged_call(torch, q, kc, ks, vc, vs, tables, lens)

    def case(B, H, Hkv, d, P, ps, maxp, lengths, kind, q_dt=torch.float32, name=None):
        return paged_case(torch, g, dev, B, H, Hkv, d, P, ps, maxp, lengths, kind, q_dt,
                          name, plans)

    for kind in ("int8", "fp8", "bf16"):
        for H, Hkv, d in [(8, 2, 64), (4, 1, 128), (16, 16, 64), (10, 2, 64)]:
            case(2, H, Hkv, d, 17, 16, 4, [64, 33], kind)
        case(4, 8, 2, 64, 33, 8, 4, [32, 1, 17, 29], kind)
        case(3, 4, 2, 64, 9, 8, 2, [0, 5, 16], kind)
        case(4, 4, 4, 16, 17, 4, 4, [16, 1, 9, 12], kind)      # [eval]'s reduced config
        lens = torch.randint(1, 257, (SLOTS,), generator=g, device=dev).tolist()
        worst = max(worst, case(SLOTS, 16, 16, 64, SLOTS * 16 + 1, 16, 16, lens,
                                kind, torch.bfloat16, name="served"))

    # poisoned trash page: out-of-chain entries name page 0, and the slots
    # of the last live page past the length hold garbage too; neither may
    # change one output bit, with the chain split over several blocks
    kc, ks, vc, vs = _pool(torch, g, dev, 5, 8, 2, 64, "int8")
    q = torch.randn((1, 4, 64), generator=g, device=dev)
    tbl = torch.tensor([[1, 2, 3, 0, 0, 0]], dtype=torch.int32, device=dev)
    lens = torch.tensor([20], dtype=torch.int32, device=dev)
    plan = paged_attn_plan(1, 2, 2, 64, 8, 6)
    if plan.splits < 2:
        raise AssertionError(f"paged_attn: the trash-page case is not split ({plan})")
    base = call(q, kc, ks, vc, vs, tbl, lens)
    kc[0], vc[0], ks[0], vs[0] = 127, -127, 1e3, 1e3
    kc[3, 4:], vc[3, 4:], ks[3, 4:], vs[3, 4:] = -127, 127, 1e3, 1e3
    poisoned = call(q, kc, ks, vc, vs, tbl, lens)
    if not torch.equal(base, poisoned):
        raise AssertionError("paged_attn: the poisoned trash page changed the output")
    plans["trash page"] = f"{plan.splits} splits x {plan.tokens_per_split} tokens"

    # the served shape: B=slots, Hkv=16, G=1, d=64, ps=16, int8 pages,
    # ragged lengths up to 256; one decode step = 6 launches (one a layer)
    lens = torch.randint(1, 257, (SLOTS,), generator=g, device=dev)
    fns, (t, by), work = paged_window(torch, g, dev, 16, 16, 64, 16, 6, lens)

    # the split plan's edges, drawn after the timed inputs (so that those
    # stay the ones earlier runs timed): one long row over many splits;
    # lengths on both sides of a page and of a split, an idle row and a
    # full chain
    for kind in ("int8", "fp8", "bf16"):
        case(1, 8, 2, 64, 65, 16, 64, [1000], kind, name="long row")
        case(5, 16, 16, 64, 81, 16, 16, [0, 1, 16, 17, 256], kind, name="edges")
    log(f"[kernels] paged_attn: int8/fp8/bf16 pages agree with paged_attn_plain "
        f"(< 1e-5), a long row (length 1000), lengths 0/1/16/17/256, zero-length rows "
        f"exactly 0, every case launched twice and bit-identical; trash page and the "
        f"slots past the length unobservable; plans (int8): "
        + "; ".join(f"{k} {v}" for k, v in plans.items())
        + f"; max abs err at the served shape {worst:.3g}")

    return {"name": "paged_attn", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
            "replaces": "src/repro/kernels/paged_attn.py:105",
            "max_abs_err": worst, **times(*fns), "bound_ms": t, "bound_by": by,
            "work": f"one decode step: {work}"}


def paged_window(torch, g, dev, H, Hkv, d, maxp, layers, lens):
    """Kernel, plain and library calls over one decode step's paged
    attention: ``layers`` launches at B = slots, pages of PAGE tokens,
    each layer on its own int8 pool, ``lens`` (B,) the cached lengths;
    the library yardstick is SDPA on bf16 K/V already gathered dense and
    repeated to the H query heads (gather, dequantization and the repeat
    left out of its time). Returns the calls, the bound of that work and
    its description."""
    from repro_torch.kernels.paged_attn import paged_attn_plain, paged_attn_plan
    B, ps, G = SLOTS, PAGE, H // Hkv
    lens32 = lens.to(torch.int32)
    pools = [_pool(torch, g, dev, B * maxp + 1, ps, Hkv, d, "int8") for _ in range(layers)]
    tables = (1 + torch.arange(B * maxp, device=dev)).reshape(B, maxp).to(torch.int32)
    q = torch.randn((B, H, d), generator=g, device=dev).to(torch.bfloat16)

    def run_kernel():
        for kc, ks, vc, vs in pools:
            _paged_call(torch, q, kc, ks, vc, vs, tables, lens32)

    def run_plain():
        for kc, ks, vc, vs in pools:
            paged_attn_plain(q.reshape(B, Hkv, G, d), kc, ks, vc, vs, tables, lens32,
                             d ** -0.5)

    S = maxp * ps
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    kv = [tuple(torch.randn((B, Hkv, S, d), generator=g, device=dev).to(torch.bfloat16)
                .repeat_interleave(G, dim=1) for _ in range(2)) for _ in range(layers)]
    q4 = q[:, :, None, :]

    def run_library():
        for k, v in kv:
            torch.nn.functional.scaled_dot_product_attention(q4, k, v, attn_mask=mask)

    tokens = int(lens.sum())
    nbytes = layers * (B * H * d * 2 + tokens * Hkv * (2 * d + 2 * 4) + B * maxp * 4
                       + B * 4 + B * H * d * 4)
    plan = paged_attn_plan(B, Hkv, G, d, ps, maxp)
    return ((run_kernel, run_plain, run_library),
            bound_ms(nbytes, layers * 4 * tokens * H * d, F32_FLOPS_PER_MS),
            f"{layers} launches, B={B} H={H} Hkv={Hkv} G={G} d={d} ps={ps} int8 pages, "
            f"{tokens} cached tokens (lengths 1..{S}); grid {plan.grid}, "
            f"{plan.tokens_per_split} tokens a split")


def fasst_agree(torch, x, mode, where="", out_dtype=None):
    """ops.fasst(x, mode) against fasst_act_plain within fasst_tol;
    returns the max abs error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fasst import fasst_act_plain
    y = ops.fasst(x, mode, out_dtype=out_dtype).float()
    p = fasst_act_plain(x, mode, out_dtype=out_dtype).float()
    err = float((y - p).abs().max())
    if not bool(((y - p).abs() <= fasst_tol(torch, p, x.dtype)).all()):
        raise AssertionError(f"{where}fasst {mode} {x.dtype} {tuple(x.shape)}: max abs err "
                             f"{err:.3g}")
    return err


def check_fasst(torch, dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels.fasst import MODES, fasst_act_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    worst = 0.0
    for shape in ((37, 100), (48, 96), (SLOTS, 8192), (64, 8192)):
        x = torch.randn(shape, generator=g, device=dev) * 3
        for mode in MODES:
            for dt in (torch.float32, torch.bfloat16):
                err = fasst_agree(torch, x.to(dt), mode)
                if dt == torch.bfloat16 and shape[1] == 8192 and mode == "relu":
                    worst = err
    log("[kernels] fasst_act: 8 modes x (f32, bf16) agree with fasst_act_plain")

    # one decode step's worth: 6 relu launches on (slots, 8192) bf16 (the
    # served decode step fuses them into qmm; the served prefill rows and
    # other callers of ops.fasst launch this kernel)
    xs = [torch.randn((SLOTS, 8192), generator=g, device=dev).to(torch.bfloat16)
          for _ in range(6)]
    gelu_ms = cuda_ms(lambda: [torch.nn.functional.gelu(x, approximate="tanh") for x in xs])
    log(f"[kernels] fasst_act library yardsticks: relu in the entry below; "
        f"gelu(tanh) x6 {gelu_ms:.4f} ms")
    nbytes = 6 * SLOTS * 8192 * 2 * 2
    t, by = bound_ms(nbytes, 6 * SLOTS * 8192, F32_FLOPS_PER_MS)
    return {"name": "fasst_act", "route": "triton",
            "source": "src/repro_torch/kernels/fasst.py",
            "replaces": "src/repro/kernels/fasst.py:63",
            "max_abs_err": worst,
            **times(lambda: [ops.fasst(x, "relu") for x in xs],
                    lambda: [fasst_act_plain(x, "relu") for x in xs],
                    lambda: [torch.relu(x) for x in xs], plain_reps=20),
            "bound_ms": t, "bound_by": by,
            "work": f"6 relu launches on ({SLOTS}, 8192) bf16 (one unfused decode step)"}


def _int8_cache(torch, g, dev, B, S, Hkv, d):
    from repro_torch.kernels import ops
    kc, ks = ops.quantize_kv(torch.randn((B, S, Hkv, d), generator=g, device=dev))
    vc, vs = ops.quantize_kv(torch.randn((B, S, Hkv, d), generator=g, device=dev))
    return kc, ks, vc, vs


def check_decode_attn(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attn import decode_attn_plain, decode_attn_plan

    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    def call(q, kc, ks, vc, vs, lens, out_dt):
        return ops.decode_attention(q, kc, ks, vc, vs, lens, out_dtype=out_dt)

    def case(B, H, Hkv, d, S, lengths, q_dt=torch.float32, poison=False):
        kc, ks, vc, vs = _int8_cache(torch, g, dev, B, S, Hkv, d)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = torch.randn((B, H, d), generator=g, device=dev).to(q_dt)
        where = (f"decode_attn B={B} H={H} Hkv={Hkv} d={d} S={S} {q_dt} lengths {lengths} "
                 f"({decode_attn_plan(B, Hkv, H // Hkv, d, S)})")
        out = call(q, kc, ks, vc, vs, lens, torch.float32)
        # the splits are merged in split order by the last block of each
        # (row, kv head): reruns are bit-identical
        if not torch.equal(out, call(q, kc, ks, vc, vs, lens, torch.float32)):
            raise AssertionError(f"{where}: two launches differ")
        ref = decode_attn_plain(q.reshape(B, Hkv, H // Hkv, d), kc, ks, vc, vs, lens,
                                d ** -0.5).reshape(B, H, d)
        err = float((out - ref).abs().max())
        if not err < 1e-5:
            raise AssertionError(f"{where}: max abs err {err:.3g}")
        if not bool((out[lens == 0] == 0).all()):
            raise AssertionError(f"{where}: a zero-length row is not exactly zero")
        if poison:
            # codes 127 and NaN scales past each length: the kernel never
            # reads them, so not one output bit may move, in either output
            # type (kernel against kernel: the plain version reads them)
            clean_bf16 = call(q, kc, ks, vc, vs, lens, torch.bfloat16)
            for b, n in enumerate(lengths):
                kc[b, n:], vc[b, n:] = 127, 127
                ks[b, n:], vs[b, n:] = float("nan"), float("nan")
            if not (torch.equal(out, call(q, kc, ks, vc, vs, lens, torch.float32))
                    and torch.equal(clean_bf16, call(q, kc, ks, vc, vs, lens,
                                                     torch.bfloat16))):
                raise AssertionError(f"{where}: the poisoned region past the lengths "
                                     "changed the output")
        return err

    for H, Hkv, d in [(8, 2, 64), (4, 1, 128), (16, 16, 64), (10, 2, 64)]:
        case(2, H, Hkv, d, 256, [256, 100])
    case(4, 8, 2, 64, 384, [384, 1, 17, 200])
    case(3, 4, 2, 64, 32, [0, 5, 32])
    # the served dense engine: self caches S = max_len, cross caches
    # S = cfg.enc_len (the engine's cross capacity) holding sources of 32
    # to 64 tokens; also S = 64, a cross cache cut to the longest source
    enc_len = get_config("nllb600m").enc_len
    self_lens = torch.randint(1, MAX_LEN + 1, (SLOTS,), generator=g, device=dev)
    cross_lens = torch.randint(32, 65, (SLOTS,), generator=g, device=dev)
    worst = max(case(SLOTS, 16, 16, 64, S, lens.tolist(), torch.bfloat16)
                for S, lens in ((MAX_LEN, self_lens), (enc_len, cross_lens),
                                (64, cross_lens)))
    served_plans = {f"self S={MAX_LEN}": decode_attn_plan(SLOTS, 16, 1, 64, MAX_LEN),
                    f"cross S={enc_len}": decode_attn_plan(SLOTS, 16, 1, 64, enc_len)}

    # one decode step of the dense engine: per layer a self-attention read
    # (S = max_len) and a cross-attention read (S = enc_len, 32 to 64 valid
    # tokens), B = slots, H = Hkv = 16, d = 64, int8 caches, bf16 q, f32 out
    B, H, d = SLOTS, 16, 64
    reads = []
    for _ in range(6):
        for S, lens in ((MAX_LEN, self_lens), (enc_len, cross_lens)):
            kc, ks, vc, vs = _int8_cache(torch, g, dev, B, S, H, d)
            reads.append((S, lens.to(torch.int32), kc, ks, vc, vs))
    q = torch.randn((B, H, d), generator=g, device=dev).to(torch.bfloat16)
    q4 = q[:, :, None, :]

    # the split plan's edges, drawn after the timed inputs (so that those
    # stay the ones earlier runs timed): at an S that is not a multiple of
    # the plan's T, lengths 0, 1, T-1, T, T+1 and S, for G = 1, 5 and 4
    # (d = 64, 64, 128), q in f32 and bf16, with the region past each
    # length poisoned
    plans = dict(served_plans)
    B_e, S_e = 6, 200
    for H_e, Hkv_e, d_e in ((16, 16, 64), (10, 2, 64), (4, 1, 128)):
        plan = decode_attn_plan(B_e, Hkv_e, H_e // Hkv_e, d_e, S_e)
        T = plan.tokens_per_split
        if S_e % T == 0 or plan.splits < 2:
            raise AssertionError(f"decode_attn: the edge case does not split unevenly ({plan})")
        for q_dt in (torch.float32, torch.bfloat16):
            case(B_e, H_e, Hkv_e, d_e, S_e, [0, 1, T - 1, T, T + 1, S_e], q_dt, poison=True)
        plans[f"edges G={H_e // Hkv_e} d={d_e} S={S_e}"] = plan
    # the largest group the one-block-per-row kernel took at d = 128 (46 KB
    # of shared memory a block at 16 tokens a split)
    case(2, 38, 1, 128, 100, [100, 37], torch.bfloat16, poison=True)
    plans["G=38 d=128 S=100"] = decode_attn_plan(2, 1, 38, 128, 100)
    log(f"[kernels] decode_attn: GQA (8,2,64) (4,1,128) (16,16,64) (10,2,64), ragged "
        f"S=384, a zero-length row, the served shapes (self S={MAX_LEN}, cross "
        f"S={enc_len} and 64) and the plan's edges (lengths 0/1/T-1/T/T+1/S at S={S_e}, "
        f"G=1/5/4, q f32/bf16; G=38 at d=128; the region past each length poisoned with code 127 and "
        f"NaN scales, unobservable) agree with decode_attn_plain (< 1e-5), zero-length "
        f"rows exactly 0, every case launched twice and bit-identical; plans: "
        + "; ".join(f"{k} grid {p.grid}, T={p.tokens_per_split}" for k, p in plans.items())
        + f"; max abs err at the served shapes {worst:.3g}")

    def run_kernel():
        for _, lens, kc, ks, vc, vs in reads:
            ops.decode_attention(q, kc, ks, vc, vs, lens, out_dtype=torch.float32)

    def run_plain():
        for _, lens, kc, ks, vc, vs in reads:
            decode_attn_plain(q.reshape(B, H, 1, d), kc, ks, vc, vs, lens, d ** -0.5)

    # library yardstick: SDPA on K/V dequantized to bf16 beforehand (the
    # dequantization is left out of its time)
    dense = []
    for S, lens, kc, ks, vc, vs in reads:
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        dense.append(((kc.float() * ks[..., None]).to(torch.bfloat16).transpose(1, 2),
                      (vc.float() * vs[..., None]).to(torch.bfloat16).transpose(1, 2),
                      mask))

    def run_library():
        for k, v, mask in dense:
            torch.nn.functional.scaled_dot_product_attention(q4, k, v, attn_mask=mask)

    tokens = 6 * int(self_lens.sum() + cross_lens.sum())
    nbytes = (12 * (B * H * d * 2 + B * 4 + B * H * d * 4)
              + tokens * H * (2 * d + 2 * 4))
    t, by = bound_ms(nbytes, 4 * tokens * H * d, F32_FLOPS_PER_MS)
    return {"name": "decode_attn", "route": "cuda", "path": "ops API",
            "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
            "replaces": "src/repro/kernels/decode_attn.py:77",
            "max_abs_err": worst, **times(run_kernel, run_plain, run_library),
            "bound_ms": t, "bound_by": by,
            "work": f"one dense decode step: 12 launches (6 self reads at S={MAX_LEN}, "
                    f"6 cross reads at S={enc_len}), B={B} H=Hkv=16 d=64 int8 caches, "
                    f"{tokens} valid cached tokens read (plain and SDPA read all S); grids "
                    + ", ".join(f"{k} {p.grid} T={p.tokens_per_split}"
                                for k, p in served_plans.items())}


# probabilities on a vocabulary-wide row are mostly far below any useful
# absolute tolerance (the mean is 1/V), so each entry is also held to a
# bound relative to itself
SOFTMAX_RTOL, SOFTMAX_FLOOR = 1e-5, 1e-12


def softmax_err(y, p):
    """(max |y - p|, max |y - p| / (SOFTMAX_RTOL |p| + SOFTMAX_FLOOR)):
    the second is <= 1 when every entry holds the relative bound."""
    d = (y.float() - p.float()).abs()
    return (float(d.max()),
            float((d / (SOFTMAX_RTOL * p.float().abs() + SOFTMAX_FLOOR)).max()))


def check_fasst_softmax(torch, dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels.fasst import fasst_softmax_plain, softmax_plan

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    worst = (0.0, 0.0)
    vocab = (SLOTS, 256204)

    def check(shape):
        nonlocal worst
        x = torch.randn(shape, generator=g, device=dev) * 5
        for valid in (-1, shape[1] // 3, shape[1] + 7, 1):
            y = ops.fasst_softmax(x, scale=0.7, valid_cols=valid)
            where = f"fasst_softmax {shape} valid_cols={valid} ({softmax_plan(*shape)})"
            # the segments' partials are merged in segment order: reruns
            # are bit-identical
            if not torch.equal(y, ops.fasst_softmax(x, scale=0.7, valid_cols=valid)):
                raise AssertionError(f"{where}: two calls differ")
            p = fasst_softmax_plain(x, scale=0.7, valid_cols=valid)
            err, rel = softmax_err(y, p)
            vc = shape[1] if valid < 0 else min(valid, shape[1])
            if not (err <= 1e-6 and rel <= 1.0) or not bool((y[:, vc:] == 0).all()):
                raise AssertionError(f"{where}: max abs err {err:.3g}, relative-bound share "
                                     f"{rel:.3g}, masked columns zero "
                                     f"{bool((y[:, vc:] == 0).all())}")
            if shape == vocab and valid == -1:
                worst = (err, rel)
        yb = ops.fasst_softmax(x, scale=0.7, out_dtype=torch.bfloat16)
        if not torch.equal(yb, ops.fasst_softmax(x, scale=0.7, out_dtype=torch.bfloat16)):
            raise AssertionError(f"fasst_softmax {shape} bf16: two calls differ")
        pb = fasst_softmax_plain(x, scale=0.7, out_dtype=torch.bfloat16).float()
        # the two f32 results may round to adjacent bf16 values: one ulp
        if not bool(((yb.float() - pb).abs() <= pb.abs() * 2.0 ** -7).all()):
            raise AssertionError(f"fasst_softmax {shape} bf16: more than one ulp apart")

    shapes = ((8, 64), (33, 100), (1, 128), (128, 128), vocab)
    for shape in shapes:
        check(shape)
    # the sampler's shape: a temperature softmax over the vocabulary for
    # every slot, f32 logits in, f32 probabilities out
    x = torch.randn(vocab, generator=g, device=dev) * 5
    xs = x * 0.7
    small = torch.randn((128, 128), generator=g, device=dev)
    # a single vocabulary row (the most segments), drawn after the timed
    # inputs (so that those stay the ones earlier runs timed)
    shapes += ((1, 256204),)
    check(shapes[-1])
    plans = "; ".join(f"{s} {p.nseg} segment{'s' * (p.nseg > 1)} x {p.seg} columns"
                      for s, p in ((s, softmax_plan(*s)) for s in shapes))
    log(f"[kernels] fasst_softmax: {', '.join(map(str, shapes))}, full, masked, clamped "
        f"and valid_cols=1, agree with fasst_softmax_plain (<= 1e-6 abs "
        f"and {SOFTMAX_RTOL:g} * |p| + {SOFTMAX_FLOOR:g} per entry in f32, masked "
        f"columns exactly 0, one ulp in bf16), every case called twice and "
        f"bit-identical; plans: {plans}; on the vocabulary rows max abs err "
        f"{worst[0]:.3g}, largest |y - p| / ({SOFTMAX_RTOL:g} |p| + {SOFTMAX_FLOOR:g}) "
        f"{worst[1]:.3g}")
    small_ms = (cuda_ms(lambda: ops.fasst_softmax(small)),
                cuda_ms(lambda: torch.softmax(small, dim=-1)))
    log(f"[kernels] fasst_softmax at (128, 128) f32: kernel {small_ms[0]:.4f} ms, "
        f"torch.softmax {small_ms[1]:.4f} ms")
    nbytes = 2 * x.numel() * 4
    t, by = bound_ms(nbytes, 4 * x.numel(), F32_FLOPS_PER_MS)
    plan = softmax_plan(*vocab)
    return {"name": "fasst_softmax", "route": "triton", "path": "ops API",
            "source": "src/repro_torch/kernels/fasst.py",
            "replaces": "src/repro/kernels/fasst.py:95",
            "max_abs_err": worst[0],
            **times(lambda: ops.fasst_softmax(x, scale=0.7),
                    lambda: fasst_softmax_plain(x, scale=0.7),
                    lambda: torch.softmax(xs, dim=-1), plain_reps=20),
            "bound_ms": t, "bound_by": by,
            "work": f"one call on {vocab} f32 logits, scale 0.7: {plan.nseg} segments "
                    f"of {plan.seg} columns a row, {2 if plan.nseg > 1 else 1} launch(es) "
                    "(torch.softmax timed on logits scaled beforehand)"}


# ---------------------------------------------------------------------------
# phases 3 and 4: the served path
# ---------------------------------------------------------------------------

def _requests(rng, lang_codes, n):
    names = sorted(lang_codes)
    lens = rng.integers(32, 65, n)
    return ([rng.integers(16, 256204, int(L)).astype(np.int32) for L in lens],
            [names[i % len(names)] for i in range(n)])


def serve(torch, card, *, paged: bool, params=None):
    """Serve 8 full-width requests through deploy(): the paged engine
    ([serve]) or deploy()'s default dense engine ([serve-dense])."""
    from repro_torch.data import LANG_CODES
    from repro_torch.kernels import ops
    from repro_torch.models import Ctx
    from repro_torch.serving import SamplingParams, deploy

    tag = "serve" if paged else "serve-dense"
    layout = dict(paged=True, page_size=PAGE) if paged else {}
    t0 = time.perf_counter()
    pipe = deploy("nllb600m", "int4", slots=SLOTS, max_len=MAX_LEN, horizon=HORIZON,
                  init_seed=SEED, params=params,
                  ctx=Ctx(compute_dtype=torch.bfloat16, use_fasst_kernel=True), **layout)
    torch.cuda.synchronize()
    log(f"[{tag}] deployed nllb600m int4 (full width, random weights from seed "
        f"{SEED}), {'paged' if paged else 'dense'} int8 KV, in "
        f"{time.perf_counter() - t0:.2f} s; ctx {pipe.ctx}")
    eng = pipe.engine
    if eng.paged != paged:
        raise AssertionError(f"deploy built a {'paged' if eng.paged else 'dense'} engine")
    rng = np.random.default_rng(SEED)
    sp = SamplingParams(max_new_tokens=GEN)

    # warm-up (first cuBLAS / allocator calls), not measured
    srcs, langs = _requests(rng, LANG_CODES, 2)
    pipe.generate([{"src_tokens": s[None], "tgt_in": np.array([[LANG_CODES[lg]]], np.int32)}
                   for s, lg in zip(srcs, langs)], SamplingParams(max_new_tokens=4))

    srcs, langs = _requests(rng, LANG_CODES, SLOTS)
    prompts = [{"src_tokens": s[None], "tgt_in": np.array([[LANG_CODES[lg]]], np.int32)}
               for s, lg in zip(srcs, langs)]
    eng.reset_metrics()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = pipe.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    if len(outs) != SLOTS or any(o.finish_reason != "length" or len(o.token_ids) != GEN
                                 for o in outs):
        raise AssertionError(f"not every request retired on length: "
                             f"{[(o.finish_reason, len(o.token_ids)) for o in outs]}")
    _check_vocab(pipe, outs)
    if paged:
        eng.allocator.check()
        if eng.allocator.pages_in_use:
            raise AssertionError(f"{eng.allocator.pages_in_use} pages leaked")
    steps = eng.decode_steps
    # per decode step and layer: self q,k,v,o + cross q,o + ffn in,out,
    # the ffn-in launch with the FASST activation in its epilogue (decode
    # rows; profile_decode holds a decode step to exactly L of these and no
    # FASST launch); the encoder's prefill rows (32-64 source tokens) take
    # qmm, then the FASST kernel. The dense engine reads its self-attention
    # cache in torch, as the reference does through XLA
    L = pipe.cfg.num_layers
    per_step = {"qmm": 8 * L, "qmm_naf": L}
    if not launches["fasst_act"]:
        raise AssertionError("fasst_act: no launch on the served prefill rows")
    if paged:
        per_step["paged_attn"] = L
    elif launches["paged_attn"]:
        raise AssertionError("the dense engine launched the paged-attention kernel")
    for name, n in per_step.items():
        if launches[name] < n * steps or launches[name] == 0:
            raise AssertionError(f"{name}: {launches[name]} launches < {n} x {steps} "
                                 "decode steps")
    tokens = sum(len(o.token_ids) for o in outs)
    m = eng.metrics()
    stats = {"requests": len(outs), "tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall, "decode_steps": steps,
             "decode_syncs": eng.decode_syncs,
             "decode_ms_per_step": 1e3 * eng.decode_s / max(steps, 1),
             "prefill_calls": eng.prefill_calls,
             "prefill_ms_per_call": 1e3 * eng.prefill_s / max(eng.prefill_calls, 1),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "overlap_rounds": m.overlap_rounds, "occupancy": m.occupancy,
             "launches": launches, "card": card}
    log(f"[{tag}] " + json.dumps(stats))
    # [metrics]: the engine's own latency percentiles over this run
    # (nearest rank, upper edges of power-of-two histogram buckets)
    log(f"[metrics] {tag}: TTFT p50 {m.ttft_p50_ms} ms, p95 {m.ttft_p95_ms} ms; TPOT p50 "
        f"{m.tpot_p50_ms} ms, p95 {m.tpot_p95_ms} ms over {len(outs)} requests; "
        f"prometheus() {len(eng.prometheus().splitlines())} lines; on {card}")
    log(f"[{tag}] first stream: {outs[0].token_ids[:12]} ...")
    return pipe, launches, prompts, outs, stats


def _check_vocab(pipe, outs):
    if any(not 0 <= t < pipe.cfg.vocab_size for o in outs for t in o.token_ids):
        raise AssertionError("a token outside the vocabulary")


def routes_agree(torch, pipe, prompts, tag="routes"):
    """One decode step of a live engine state through both bundles, on the
    engine's own Ctx otherwise (compute dtype, activation formats and
    calibrated scales). Returns the largest logit difference between the
    bundles."""
    import dataclasses
    from repro_torch.serving import SamplingParams
    eng = pipe.engine
    for p in prompts:
        eng.submit(p, SamplingParams(max_new_tokens=GEN))
    eng.step(horizon=4)
    eng.step(horizon=4)
    # the engine grows on-demand chains just ahead of each horizon: cover
    # the step taken here, or a slot whose next position opens a page
    # would write its fresh token into the trash page, which every such
    # slot shares
    eng._grow_chains(1)
    active = [s.id for s in eng.slots if s.active]
    if not active:
        raise AssertionError("no active slot to compare routes on")
    kern = dataclasses.replace(pipe.ctx, matmul_impl="kernel", paged_attn_impl="kernel",
                               use_fasst_kernel=True)
    plain = dataclasses.replace(pipe.ctx, matmul_impl="torch", paged_attn_impl="gather",
                                use_fasst_kernel=False)
    with torch.no_grad():
        c1 = {k: v.clone() for k, v in eng.cache.items()}
        c2 = {k: v.clone() for k, v in eng.cache.items()}
        _, lk = pipe.model.decode_step(kern, pipe.params, eng.cur, c1)
        _, lt = pipe.model.decode_step(plain, pipe.params, eng.cur, c2)
    lk, lt = lk[active, -1], lt[active, -1]
    if not (torch.isfinite(lk).all() and torch.isfinite(lt).all()):
        raise AssertionError("non-finite logits")
    err = float((lk - lt).abs().max())
    # reference engine test bound for int8 KV: the kernel route quantizes
    # the fresh token before attending, the gather route does not
    if not err < 0.3:
        raise AssertionError(f"[{tag}] kernel and torch routes differ by {err:.3g} >= 0.3")
    # greedy argmax must agree wherever the top-2 margin exceeds twice the
    # routes' largest logit difference (closer calls are ties at this
    # precision, and random weights make some)
    top2 = lt.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * err
    same = lk.argmax(-1) == lt.argmax(-1)
    if not bool(same[decided].all()):
        raise AssertionError(f"[{tag}] argmax differs between routes on a slot with margin "
                             f"> 2 x {err:.3g}: margins {margin.tolist()}, same {same.tolist()}")
    log(f"[{tag}] kernels vs torch bundle on {len(active)} live slots: max |logit "
        f"diff| {err:.4g} (< 0.3); argmax equal on {int(same.sum())}/{len(active)} "
        f"slots, required on the {int(decided.sum())} with top-2 margin > {2 * err:.3g}")
    eng.run_until_drained()
    if eng.paged:
        eng.allocator.check()
    return err


PORT_KERNELS = ("qmm_kernel", "paged_attn_kernel", "decode_attn_kernel", "fasst_act_kernel",
                "fasst_softmax_kernel", "softmax_partials_kernel",
                "softmax_normalize_kernel")


def profile_decode(torch, pipe, prompts, tag="profile", sampled=False, expect=None):
    """Where a decode micro-step's time goes: torch.profiler over one
    4-step horizon of the served engine with 8 live slots, greedy or
    sampled (temperature 0.7, top-p 0.9). ``expect`` gives the exact
    wrapper launches of a decode step (default: [serve]'s, at least 8 qmm
    a layer, one qmm_naf a layer, no FASST launch). Returns the host ms,
    device-busy ms, idle share and kernel launches of a step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.serving import SamplingParams
    eng = pipe.engine
    K = 4
    # the prefill's token, one step, the K profiled ones and one more: the
    # 8 slots stay live through the profiled horizon and retire just after
    # it (GEN tokens until [tp-ssm] and [tp-hybrid] needed the script's
    # time: the drain of the rest was never measured)
    for i, p in enumerate(prompts):
        knobs = dict(temperature=0.7, top_p=0.9, seed=100 + i) if sampled else {}
        eng.submit(p, SamplingParams(max_new_tokens=K + 3, **knobs))
    eng.step(horizon=1)                       # admit all 8, one step
    torch.cuda.synchronize()
    steps0 = eng.decode_steps
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(horizon=K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches, steps = dict(ops.LAUNCHES), eng.decode_steps - steps0
    eng.run_until_drained()
    # a decode step: the FFN activation in the epilogue of each layer's
    # FFN-in qmm, no FASST launch of its own
    L = pipe.cfg.num_layers
    exact = expect if expect is not None else {"qmm_naf": L, "fasst_act": 0}
    least = {} if expect is not None else {"qmm": 8 * L}
    if not (steps and all(launches[k] == n * steps for k, n in exact.items())
            and all(launches[k] >= n * steps for k, n in least.items())):
        raise AssertionError(f"[{tag}] {steps} decode steps launched {launches}; a step "
                             f"launches {exact}" + (f", at least {least}" if least else ""))
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and getattr(e, "self_device_time_total", 0) > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        log(f"[{tag}] the profiler recorded no device time: not measured")
        return {"host_ms_per_step": wall_ms / K, "device_busy_ms_per_step": "not measured",
                "idle_share": "not measured", "kernel_launches_per_step": "not measured"}
    log(f"[{tag}] {K} decode micro-steps, 8 live slots: host wall {wall_ms / K:.3f} ms "
        f"per step, device busy {busy_ms / K:.3f} ms per step "
        f"(idle share {1 - busy_ms / wall_ms:.3f}), "
        f"{sum(e.count for e in kernels) / K:.0f} kernel launches per step; wrapper "
        f"launches per step qmm {launches['qmm'] / steps:g}, qmm_naf "
        f"{launches['qmm_naf'] / steps:g}, fasst_act {launches['fasst_act'] / steps:g}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3 / K:8.4f} ms/step "
            f"x{e.count / K:5.1f}  {e.key[:100]}")
    # the port's own kernels, wherever they rank
    ours = {}
    for e in kernels:
        name = next((n for n in PORT_KERNELS if n in e.key), None)
        if name:
            ms, n = ours.get(name, (0.0, 0))
            ours[name] = (ms + e.self_device_time_total / 1e3 / K, n + e.count / K)
    log(f"[{tag}] the port's kernels: " + ", ".join(
        f"{name} x{n:g} {ms:.4f} ms/step" for name, (ms, n) in sorted(ours.items())))
    return {"host_ms_per_step": wall_ms / K, "device_busy_ms_per_step": busy_ms / K,
            "idle_share": 1 - busy_ms / wall_ms,
            "kernel_launches_per_step": sum(e.count for e in kernels) / K}


def _fresh_engine(pipe, paged: bool, **kw):
    """An idle engine of the given layout on ``pipe``'s model and weights.
    A tensor-parallel pipe's model, weights and ctx are the rank's local
    model, its shard and the ctx carrying the group: the fresh engine
    serves them as they are (every rank builds it). ``kw`` sets engine
    options (pool, overlap, preempt_limit, trace) and may replace the
    served shape (slots, max_len, page_size, horizon)."""
    from repro_torch.serving import ServeEngine
    shape = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, horizon=HORIZON)
    shape.update(kw)
    return ServeEngine(pipe.model, pipe.params, kv_dtype=pipe.engine.kv_dtype,
                       ctx=pipe.ctx, paged=paged, max_src_len=pipe.engine.enc_cap,
                       device=pipe.engine.device, **shape)


def _filter_slack(torch, lg, sp, t):
    """How far token ``t`` lies inside (> 0) or outside (< 0) the
    request's filters on one engine's logits ``lg`` (V,): its scaled
    logit above the k-th largest when top-k is on, else the top-p mass
    left before it (top_p minus the probability mass ranked above it)."""
    z = lg / sp.temperature
    if sp.top_k > 0:
        kth = z.topk(min(sp.top_k, z.numel())).values[-1]
        if sp.top_p >= 1.0:
            return "top-k", float(z[t] - kth)
        z = torch.where(z < kth, -1e30, z)
    p = torch.softmax(z, dim=-1)
    return "top-p", sp.top_p - float(p[p > p[t]].sum())


def _sampled_parting(torch, prng, lp, fp, fd, sp, j, a, b, err):
    """Why a sampled slot parts at token ``j`` (paged drew ``a``, dense
    ``b``): replays both draws from the engines' filtered logits ``fp``,
    ``fd`` and the request's key, and checks that the parting is a near
    tie of the logit differences ``err``. Returns a description of the
    tie."""
    g = prng.gumbel(prng.fold_in(prng.prng_key(sp.seed, lp.device), j), lp.shape)
    if int(torch.argmax(fp + g)) != a or int(torch.argmax(fd + g)) != b:
        raise AssertionError(f"the replayed draws ({int(torch.argmax(fp + g))}, "
                             f"{int(torch.argmax(fd + g))}) are not the engines' ({a}, {b})")
    kept = {(e, t): bool(f[t] > -1e29) for e, f in (("p", fp), ("d", fd)) for t in (a, b)}
    moved = [t for t in (a, b) if kept["p", t] != kept["d", t]]
    if not moved:
        # both tokens pass both filters: the scores differ by the logits
        margin = float((fp + g)[a] - (fp + g)[b])
        bound = 2 * err / sp.temperature
        what = f"Gumbel-max margin {margin:.4g} <= {bound:.4g}"
    else:
        # one token passes one engine's filter only: it sits on the
        # filter's edge; the logits move a scaled logit by err / T and
        # the probability mass by a factor of at most exp(2 err / T)
        kind, slack = _filter_slack(torch, lp, sp, moved[0])
        margin = abs(slack)
        bound = (2 * err / sp.temperature if kind == "top-k"
                 else float(np.expm1(2 * err / sp.temperature)))
        what = f"token {moved[0]} on the {kind} edge, slack {margin:.4g} <= {bound:.4g}"
    if not margin <= bound:
        raise AssertionError(f"not a near tie: {what.replace('<=', '>')}")
    return what


def _partings(tag, a_streams, b_streams, first_token_ties=False):
    """Request index -> the first token where two stream sets part."""
    part = {}
    for i, (a, b) in enumerate(zip(a_streams, b_streams)):
        j = next((t for t in range(min(len(a), len(b))) if a[t] != b[t]), None)
        if j is None and len(a) != len(b):
            raise AssertionError(f"[{tag}] request {i}: streams of {len(a)} and "
                                 f"{len(b)} tokens share every token")
        if j == 0 and not first_token_ties:
            raise AssertionError(f"[{tag}] request {i}: the prefill tokens differ")
        if j is not None:
            part[i] = j
    return part


def _side_admit(torch, tag, side, prompts, sps, steps):
    """Admit a replay side's prompts (each engine its own, in order, the
    same prefill calls as the served run) and grow paged chains over the
    forced steps; returns the logits each first token is sampled from,
    (prompts, V) by prompt index, and each prompt's router calls in its
    prefill (an MoE model's encoder and decoder layers, in order: its
    row's router probabilities (T, E) and experts (T, k), pad tokens
    included; a prefill call's groups are its rows)."""
    from repro_torch.models import moe as moe_mod
    real_route = moe_mod.route
    rows, routed = {}, {}
    for eng, idx in side:
        got, calls, by_id = {}, [], {}

        def rec_route(router, xt, top_k, calls=calls):
            out = real_route(router, xt, top_k)
            calls.append(out)
            return out

        def record(logits, requests, slots, real=eng._first_tokens, got=got, calls=calls,
                   by_id=by_id):
            got.update((r.id, lg.float()) for r, lg in zip(requests, logits))
            by_id.update((r.id, [(p[row], e[row]) for p, _, e in calls])
                         for row, r in enumerate(requests))
            calls.clear()
            return real(logits, requests, slots)

        eng._first_tokens = record
        moe_mod.route = rec_route
        try:
            for i in idx:
                eng.submit(prompts[i], sps[i])
            eng._admit_pending()
        finally:
            moe_mod.route = real_route
        del eng._first_tokens
        if [s.request.id for s in eng.slots[:len(idx)]] != list(range(len(idx))):
            raise AssertionError(f"[{tag}] admission placed requests out of order")
        if eng.paged:           # on-demand chains: cover the forced steps
            eng._grow_chains(steps)
        rows.update((i, got[k]) for k, i in enumerate(idx))
        routed.update((i, by_id[k]) for k, i in enumerate(idx))
    return torch.stack([rows[i] for i in range(len(prompts))]), [routed[i] for i in
                                                                 range(len(prompts))]


# where two sides first route a token to different experts, the largest
# difference of its router probabilities: before that router call both
# sides took the same routes, so only the order of their f32 sums moves
# the probabilities (on an H100, this script's tp2 and dense-vs-paged MoE
# phases: at most 0.0023); a wrong expert slice or gather order moves
# them far more
ROUTER_TOL = 0.005


def _router_tie(tag, where, gap, diff):
    """Hold a first rerouting to ROUTER_TOL; ``gap`` (the k-th minus the
    next router probability) is logged, never held: where two top-k sets
    differ it is at most twice ``diff`` whatever the cause."""
    if not diff <= ROUTER_TOL:
        raise AssertionError(
            f"[{tag}] {where}: the sides route to different experts with router "
            f"probabilities {diff:.4g} apart, past the {ROUTER_TOL} that rounding order "
            "gives: not a near tie")
    log(f"[{tag}] {where}: the sides route to different experts at a router near tie, "
        f"probabilities {diff:.4g} <= {ROUTER_TOL} apart, gap {gap:.4g}")


def _prefill_reroutes(tag, routes_a, routes_b):
    """Prompt index -> (router call, token) where two sides' prefills first
    send a token of the prompt's row to different experts (over the tokens
    both rows have). Up to that call the rows took the same routes, so
    there the rerouted tokens' router probabilities must agree to
    ROUTER_TOL (_router_tie), else this raises; the prompt's later calls
    are not compared (a rerouted token moves what its row attends to)."""
    out = {}
    for i, (ra, rb) in enumerate(zip(routes_a, routes_b)):
        if len(ra) != len(rb):
            raise AssertionError(f"[{tag}] request {i}: {len(ra)} and {len(rb)} router "
                                 "calls in the two prefills")
        for c, ((pa, ea), (pb, eb)) in enumerate(zip(ra, rb)):
            T = min(len(ea), len(eb))   # a dense prefill's bucket may be another length
            pa, ea, pb, eb = pa[:T], ea[:T], pb[:T], eb[:T]
            differ = (ea.sort(-1).values != eb.sort(-1).values).any(-1)
            if not bool(differ.any()):
                continue
            k = ea.shape[-1]
            top = pa.sort(-1, descending=True).values
            gap = top[:, k - 1] - top[:, k]
            # the rerouted token whose probabilities part most
            diff = (pa - pb).abs().amax(-1).masked_fill(~differ, float("-inf"))
            t = int(diff.argmax())
            out[i] = (c, t)
            _router_tie(tag, f"request {i}, prefill router call {c}, token {t}",
                        float(gap[t]), float(diff[t]))
            break
    return out


def _side_step(torch, side, forced, j, n):
    """One teacher-forced decode step of every engine of a replay side
    (token ``j - 1`` of the forced streams); returns (logits (n, V) by
    prompt index, each engine's router calls)."""
    rows, routes = {}, []
    from repro_torch.models import moe as moe_mod
    real_route = moe_mod.route
    for eng, idx in side:
        calls = []

        def rec_route(router, xt, top_k, calls=calls):
            out = real_route(router, xt, top_k)
            calls.append(out)
            return out

        toks = torch.zeros((eng.n_slots, 1), dtype=torch.int32, device=eng.device)
        toks[:len(idx)] = forced[idx, j - 1:j].to(eng.device)
        moe_mod.route = rec_route
        try:
            eng.cache, lg = eng.model.decode_step(eng.ctx, eng.params, toks, eng.cache)
        finally:
            moe_mod.route = real_route
        rows.update((i, lg[k, -1].float()) for k, i in enumerate(idx))
        routes.append(calls)
    return torch.stack([rows[i] for i in range(n)]), routes


def tp_follow_replay(torch, sides, prompts, sps, forced_streams, steps):
    """What a tensor-parallel rank other than 0 runs while rank 0 checks
    its partings: the same admissions and forced steps on its own shard
    of the tensor-parallel replay sides (near_tie_partings' order: every
    side admitted, then each step side by side), so that every
    collective meets its peers."""
    for side in sides:
        _side_admit(torch, "tp-follow", side, prompts, sps, steps)
    forced = torch.tensor([t[:steps] for t in forced_streams], dtype=torch.int32)
    for j in range(1, steps + 1):
        for side in sides:
            _side_step(torch, side, forced, j, len(prompts))


def near_tie_partings(torch, tag, pipe, prompts, sps, paged_streams, dense_streams,
                      engine_kw=None, first_token_ties=False, sides=None, logit_tol=None,
                      steps=0):
    """Where a dense and a paged stream part, show that the step was a
    near tie. Both layouts replay the common prefix teacher-forced in
    fresh engines of the same slots. A parting at the first token fails,
    unless ``first_token_ties``: then it is read from the logits each
    fresh engine's admission samples it from (the same prefill calls as
    the served run: dense one request a call, paged in the same groups)
    and held to the same bound. At a greedy slot's parting step the
    top-2 margin of the paged engine's logits must be at most twice the
    engines' largest logit difference at that step. A sampled slot's
    draws are replayed from its key: either both tokens pass both
    engines' filters and their Gumbel-max margin is at most twice the
    difference over the temperature, or one sits on the top-k / top-p
    edge within what that difference can move. ``engine_kw`` replaces the
    fresh engines' served shape (default: [serve]'s). ``sides`` replaces
    the two fresh engines by two replay sides, each a list of (engine,
    prompt indices), the first standing where the paged engine stands:
    a tensor-parallel engine against one device, a router's replicas
    against a lone engine.

    An MoE model's decode steps are also compared route by route: where
    the engines first send a slot's token to different experts at some
    layer, that routing must itself be a near tie (the slot's router
    probabilities at most ROUTER_TOL apart, _router_tie), and so must the
    first routing in which the two prefills of a prompt differ, token by
    token (a tensor-parallel rank's prefill sums its products in another
    order, so its router can tip). From then on the slot's
    logits may differ by more than the bound; a later parting of that
    slot is put down to the router tie, and the other slots keep the
    bound. With ``logit_tol`` (largest, mean) every replayed step, parting
    or not, holds the sides' largest logit difference and their mean
    difference to it (teacher-forced on the same tokens, the sides differ
    by rounding only), the largest in place of the routes' 0.3 at the
    parting steps, and the replay runs at least ``steps`` steps. Returns
    the parting steps."""
    from repro_torch import random as prng
    from repro_torch.serving.sampler import filter_logits

    part = _partings(tag, paged_streams, dense_streams, first_token_ties)
    steps = max(list(part.values()) + [3, steps])
    n = len(prompts)
    worst, worst_mean = (0.0, 0), 0.0
    if sides is None:
        sides = [[(_fresh_engine(pipe, paged, **(engine_kw or {})), list(range(n)))]
                 for paged in (True, False)]
    with torch.no_grad():
        admitted = [_side_admit(torch, tag, side, prompts, sps, steps) for side in sides]
        prefill = [lg for lg, _ in admitted]
        dev = prefill[0].device
        forced = torch.tensor([t[:steps] for t in paged_streams], dtype=torch.int32,
                              device=dev)
        knobs = [torch.tensor([getattr(sp, k) for sp in sps], dtype=dt, device=dev)
                 for k, dt in (("temperature", torch.float32), ("top_k", torch.int64),
                               ("top_p", torch.float32))]
        # slot -> (layer, step) of its router tie; the prefill's (router
        # call, step 0)
        rerouted = {i: (c, 0) for i, (c, _) in
                    _prefill_reroutes(tag, *(r for _, r in admitted)).items()}
        for j in range(steps + 1):
            lgs, routes = (prefill, []) if j == 0 else ([], [])
            for side in sides if j else ():
                lg, calls = _side_step(torch, side, forced, j, n)
                lgs.append(lg)
                routes.append(calls[0] if len(side) == 1 else [])
            for layer, ((pp, _, ep), (pd, _, ed)) in enumerate(zip(*routes) if routes else ()):
                for i in range(n):
                    if i in rerouted or set(ep[i, 0].tolist()) == set(ed[i, 0].tolist()):
                        continue
                    k = ep.shape[-1]
                    top = pp[i, 0].sort(descending=True).values
                    rerouted[i] = (layer, j)
                    _router_tie(tag, f"request {i}, step {j}, layer {layer}",
                                float(top[k - 1] - top[k]),
                                float((pp[i, 0] - pd[i, 0]).abs().max()))
            lp, ld = lgs
            kept = [i for i in range(n) if i not in rerouted]
            err = float((lp[kept] - ld[kept]).abs().max()) if kept else 0.0
            if logit_tol is not None:
                mean = float((lp[kept] - ld[kept]).abs().mean()) if kept else 0.0
                worst, worst_mean = max(worst, (err, j)), max(worst_mean, mean)
                if not (err <= logit_tol[0] and mean <= logit_tol[1]):
                    raise AssertionError(
                        f"[{tag}] step {j}: teacher-forced on the same tokens, the sides' "
                        f"logits differ by {err:.4g} at most and {mean:.4g} on average, past "
                        f"{logit_tol}: more than rounding")
            parting = [i for i, pj in part.items() if pj == j]
            if any(not sps[i].greedy for i in parting):
                # filter the whole batch, as the engines' sampler does
                fp, fd = (filter_logits(lg, *knobs) for lg in (lp, ld))
            for i in parting:
                sp, a, b = sps[i], paged_streams[i][j], dense_streams[i][j]
                where = f"[{tag}] request {i} parts at token {j} ({a} vs {b})"
                if i in rerouted:
                    log(f"{where}: after its router near tie at layer {rerouted[i][0]}, "
                        f"step {rerouted[i][1]}")
                    continue
                # the routes' int8-KV bound of [routes] holds here too,
                # unless the phase holds every step to its own
                limit = 0.3 if logit_tol is None else logit_tol[0]
                if not err < limit:
                    raise AssertionError(f"{where}: the engines' logits differ by "
                                         f"{err:.3g} >= {limit}")
                if sp.greedy:
                    top2 = lp[i].topk(2).values
                    margin = float(top2[0] - top2[1])
                    if not margin <= 2 * err:
                        raise AssertionError(
                            f"{where} with top-2 margin {margin:.4g} > {2 * err:.4g} "
                            "(2 x the engines' largest logit difference): not a near tie")
                    what = f"top-2 margin {margin:.4g} <= {2 * err:.4g}"
                else:
                    try:
                        what = _sampled_parting(torch, prng, lp[i], fp[i], fd[i], sp, j,
                                                a, b, err)
                    except AssertionError as e:
                        raise AssertionError(f"{where}: {e}") from None
                log(f"{where}: near tie, {what}")
    if logit_tol is not None:
        log(f"[{tag}] teacher-forced on the same tokens, the sides' logits differ by at "
            f"most {worst[0]:.4g} (step {worst[1]}; a step's mean difference at most "
            f"{worst_mean:.4g}) over steps 0-{steps} of {n} requests, within {logit_tol} "
            "(largest, mean)")
    return part


def dense_vs_paged(torch, pipe, prompts, paged_outs, dense_outs):
    from repro_torch.serving import SamplingParams
    sps = [SamplingParams(max_new_tokens=GEN)] * len(prompts)
    paged_streams = [o.token_ids for o in paged_outs]
    dense_streams = [o.token_ids for o in dense_outs]
    part = near_tie_partings(torch, "dense-vs-paged", pipe, prompts, sps,
                             paged_streams, dense_streams)
    same = sum(a == b for a, b in zip(paged_streams, dense_streams))
    log(f"[dense-vs-paged] greedy streams on the same weights: {same}/{len(prompts)} "
        f"token-identical; {len(part)} part, each at a near tie")


def sampled(torch, pipe_p, pipe_d, prompts):
    from repro_torch.serving import SamplingParams
    sps = [SamplingParams(temperature=0.7, top_p=0.9, seed=100 + i, max_new_tokens=GEN)
           for i in range(len(prompts))]

    def run(pipe):
        eng = pipe.engine
        eng.reset_metrics()
        ids = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
        by_id = {o.request_id: o for o in eng.run_until_drained()}
        outs = [by_id[i] for i in ids]
        if any(o.finish_reason != "length" or len(o.token_ids) != GEN for o in outs):
            raise AssertionError("[sampled] not every request retired on length")
        _check_vocab(pipe, outs)
        return [o.token_ids for o in outs], 1e3 * eng.decode_s / eng.decode_steps

    streams, ms = {}, {}
    for name, pipe in (("paged", pipe_p), ("dense", pipe_d)):
        (first, ms[name]), (again, _) = run(pipe), run(pipe)
        if first != again:
            raise AssertionError(f"[sampled] two runs of the {name} engine differ")
        streams[name] = first
    part = near_tie_partings(torch, "sampled", pipe_p, prompts, sps, streams["paged"],
                             streams["dense"])
    same = sum(a == b for a, b in zip(streams["paged"], streams["dense"]))
    distinct = len({tuple(t) for t in streams["paged"]})
    log(f"[sampled] temperature 0.7, top-p 0.9, seeds 100..{99 + len(prompts)}: both "
        f"engines repeat their streams exactly; dense vs paged {same}/{len(prompts)} "
        f"token-identical, {len(part)} part at a near tie; {distinct} distinct streams; "
        f"decode ms per micro-step paged {ms['paged']:.3f}, dense {ms['dense']:.3f}; "
        f"first stream {streams['paged'][0][:12]} ...")


# ---------------------------------------------------------------------------
# on-demand paging, overlapped rounds, streaming, metrics and tracing
# ---------------------------------------------------------------------------

PREEMPT_PAGES = 10      # 8 requests of 1 + 32 positions need 24 pages whole
# 2 horizons of 16 a request in [overlap] (4 until [tp-ssm] and
# [tp-hybrid] needed the script's time, 3 until [tp-quant] and [tp-spec])
OVERLAP_GEN = 32
# the profiled run of each [overlap] engine: 1 horizon a request (64 until
# [tp-ssm] and [tp-hybrid], 32 until [tp-quant] and [tp-spec] needed the
# script's time)
OVERLAP_PROFILED_GEN = 16


def _first_parting(a, b):
    return next((t for t in range(min(len(a), len(b))) if a[t] != b[t]), None)


def _resumes(tracer):
    """Request id -> stash lengths of its resumes, from the trace."""
    out = {}
    for e in tracer.events:
        if e.name == "resumed":
            out.setdefault(e.tid - 1, []).append(e.args["replayed"])
    return out


def replay_partings(torch, tag, pipe, prompts, ref_streams, got_streams, resumes):
    """Where a preempted run's stream parts from the uncontended [serve]
    stream, show that the parting is the replay's rounding at a near tie.
    A stream may part only at a token produced after a resume (stash
    length m <= parting token j): the resume rebuilt the cache by a
    prefill of the prompt plus m - 1 tokens, where [serve] decoded them
    one at a time. Two fresh paged engines of the same slots replay the
    common prefix teacher-forced: one decoding every token, one resuming
    each parting request from its last stash before j (through the
    engine's own resume path). At the parting, the top-2 margin of the
    decoded logits must be at most twice the two engines' largest logit
    difference there. Returns {request: (j, m)}."""
    from repro_torch.serving import SamplingParams
    part = {}
    for i, (a, b) in enumerate(zip(ref_streams, got_streams)):
        j = _first_parting(a, b)
        if j is None:
            if len(b) > len(a):
                raise AssertionError(f"[{tag}] request {i}: {len(b)} tokens > {len(a)}")
            continue                    # equal, or a prefix (preempted_limit)
        m = max((r for r in resumes.get(i, []) if r <= j), default=None)
        if j == 0 or m is None:
            raise AssertionError(f"[{tag}] request {i} parts at token {j} ({a[j]} vs "
                                 f"{b[j]}) with no replay before it (resumes "
                                 f"{resumes.get(i, [])})")
        part[i] = (j, m)
    if not part:
        return part
    sp = SamplingParams(max_new_tokens=GEN)
    engines = [_fresh_engine(pipe, True) for _ in range(2)]
    for k, eng in enumerate(engines):
        for p in prompts:
            eng.submit(p, sp)
        if k:                           # the resumed engine
            for i, (j, m) in part.items():
                eng._preempted[i] = list(ref_streams[i][:m])
        eng._admit_pending()
    # forced input of each request at step u (1-based): the decoding
    # engine feeds token u - 1; a resumed request feeds m - 1 + u - 1
    off = [[0] * len(prompts), [0] * len(prompts)]
    for i, (j, m) in part.items():
        off[1][i] = m - 1
    steps = [max(j for j, _ in part.values()),
             max(j - m + 1 for j, m in part.values())]
    dev = engines[0].device
    want = {}
    with torch.no_grad():
        for k, eng in enumerate(engines):
            eng._grow_chains(steps[k])
            slot_of = {s.request.id: s.id for s in eng.slots if s.active}
            for u in range(1, steps[k] + 1):
                col = torch.zeros((SLOTS, 1), dtype=torch.int32)
                for rid, sid in slot_of.items():
                    col[sid, 0] = ref_streams[rid][min(off[k][rid] + u - 1, GEN - 1)]
                eng.cache, lg = eng.model.decode_step(eng.ctx, eng.params, col.to(dev),
                                                      eng.cache)
                for i, (j, m) in part.items():
                    if u == (j if k == 0 else j - m + 1):
                        want[k, i] = lg[slot_of[i], -1].float()
    for i, (j, m) in part.items():
        la, lb = want[0, i], want[1, i]
        err = float((la - lb).abs().max())
        top2 = la.topk(2).values
        margin = float(top2[0] - top2[1])
        where = (f"[{tag}] request {i} parts at token {j} ({ref_streams[i][j]} vs "
                 f"{got_streams[i][j]}) after a resume from {m} stashed tokens")
        if not (err < 0.3 and margin <= 2 * err):
            raise AssertionError(f"{where}: top-2 margin {margin:.4g}, replay vs decode "
                                 f"logit difference {err:.4g}: not a near tie")
        log(f"{where}: near tie, top-2 margin {margin:.4g} <= 2 x {err:.4g} (replay vs "
            "decode logit difference)")
    return part


def serve_preempt(torch, card, pipe, prompts, ref_outs):
    """[serve-preempt]: [serve]'s requests on a 10-page pool (whole
    budgets would need 24): on-demand paging, preemption and prefill
    replay at full width, traced. preempt_limit 16 with overlapped and
    with serial rounds (serial rounds stash and replay whole horizons),
    then preempt_limit 0."""
    from repro_torch.serving import SamplingParams, TraceConfig
    sp = SamplingParams(max_new_tokens=GEN)
    ref = [o.token_ids for o in ref_outs]
    for limit, overlap in ((16, True), (16, False), (0, True)):
        eng = _fresh_engine(pipe, True, num_pages=PREEMPT_PAGES, preempt_limit=limit,
                            overlap=overlap, trace=TraceConfig())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [eng.submit(p, sp) for p in prompts]
        by_id = {o.request_id: o for o in eng.run_until_drained()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs = [by_id[i] for i in ids]
        m = eng.metrics()
        eng.allocator.check()
        problems = eng.trace.check()
        where = f"[serve-preempt] preempt_limit {limit}, overlap {overlap}"
        if eng.allocator.pages_in_use or problems:
            raise AssertionError(f"{where}: {eng.allocator.pages_in_use} pages leaked; "
                                 f"trace {problems[:3]}")
        reasons = [o.finish_reason for o in outs]
        if limit and (set(reasons) != {"length"} or not m.preemptions
                      or not m.resumed_requests):
            raise AssertionError(f"{where}: reasons {reasons}, {m.preemptions} "
                                 f"preemptions, {m.resumed_requests} resumes")
        if not limit and "preempted_limit" not in reasons:
            raise AssertionError(f"{where}: no request retired as preempted_limit")
        _check_vocab(pipe, outs)
        resumes = _resumes(eng.trace)
        part = replay_partings(torch, "serve-preempt", pipe, prompts, ref,
                               [o.token_ids for o in outs], resumes)
        tokens = sum(len(o.token_ids) for o in outs)
        log(f"{where}: " + json.dumps({
            "reasons": reasons, "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall, "preemptions": m.preemptions,
            "resumed_requests": m.resumed_requests,
            "replayed": {str(k): v for k, v in resumes.items()},
            "same_as_serve": sum(o.token_ids == r[:len(o.token_ids)]
                                 for o, r in zip(outs, ref)),
            "near_tie_partings": len(part), "page_utilization": m.page_utilization,
            "pages_in_use_after": eng.allocator.pages_in_use,
            "decode_steps": m.decode_steps, "decode_syncs": m.decode_syncs,
            "overlap_rounds": m.overlap_rounds, "card": card}))


_HOST_WAITS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
               "cudaMemcpy")


def _busy_ms(torch, prof) -> float:
    """Device busy ms: the kernels' and copies' own time, without the
    device spans of record_function regions (user annotations), as
    torch.profiler's own table sums it."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3


_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")


def profiled_round(torch, fn, label):
    """Run fn() alone under torch.profiler (CPU and CUDA activities),
    inside record_function(label), then torch.cuda.synchronize(). Returns
    (profile, host ms of fn, waits, kernel launches, where). The waits are
    the runtime calls in _HOST_WAITS over the whole profile, less those of
    the same profile around the synchronize alone (the script's own and
    the profiler's); launches are counted over the whole profile too.
    `where` places each wait (the synchronize's left out) against the
    label's two spans, the host's and the device's (the user annotation):
    which of them comes first in the profile's events (the one this
    script once counted inside), the waits inside each, and the gaps to
    their ends in us."""
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as empty:
        torch.cuda.synchronize()
    own = Counter(e.name for e in empty.events() if e.name in _HOST_WAITS)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(label):
            fn()
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    evs = prof.events()
    found = [e.time_range for e in evs
             if e.name in _HOST_WAITS and e.name != "cudaDeviceSynchronize"]
    waits = sorted((Counter(e.name for e in evs if e.name in _HOST_WAITS) - own).elements())
    labelled = [e for e in evs if e.name == label]
    spans = {e.device_type: e.time_range for e in labelled}
    host, dev = spans[DeviceType.CPU], spans.get(DeviceType.CUDA)
    where = {"first_span": str(labelled[0].device_type).split(".")[-1],
             "in_host_span": sum(host.start <= w.start and w.end <= host.end for w in found),
             "host_span_end_after_wait_us": [host.end - w.end for w in found]}
    if dev is not None:
        where.update(
            in_device_span=sum(dev.start <= w.start and w.end <= dev.end for w in found),
            wait_start_after_device_span_us=[w.start - dev.end for w in found],
            wait_end_after_device_span_us=[w.end - dev.end for w in found])
    return prof, ms, waits, sum(e.name in _LAUNCH_CALLS for e in evs), where


def overlap_phase(torch, card, pipe, pipe_d, prompts):
    """[overlap]: the same requests (OVERLAP_GEN new tokens each) on paged and
    dense engines, with overlapped and with serial rounds: token-identical
    streams; host wall per step, tokens/s, overlap_rounds, and the idle
    share from a profiled further run (OVERLAP_PROFILED_GEN new tokens a
    request). Then one steady overlapped round, with no
    admission, under torch.profiler: exactly one host wait on the
    device (the walk's event)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import SamplingParams
    sp = SamplingParams(max_new_tokens=OVERLAP_GEN)

    def run(eng, sp=sp):
        eng.reset_metrics()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [eng.submit(p, sp) for p in prompts]
        by_id = {o.request_id: o for o in eng.run_until_drained()}
        torch.cuda.synchronize()
        return [by_id[i].token_ids for i in ids], time.perf_counter() - t0

    for layout, base in (("paged", pipe), ("dense", pipe_d)):
        engines = {ov: _fresh_engine(base, layout == "paged", overlap=ov)
                   for ov in (True, False)}
        streams, walls = {}, {True: [], False: []}
        for ov in (True, False, False, True, True, False):    # in turns
            got, wall = run(engines[ov])
            if streams.setdefault(ov, got) != got:
                raise AssertionError(f"[overlap] {layout}: two runs differ")
            walls[ov].append(wall)
        for ov, eng in engines.items():
            m = eng.metrics()
            # device kernels only: CPU op events would cost minutes to process
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, pwall = run(eng, SamplingParams(max_new_tokens=OVERLAP_PROFILED_GEN))
            busy = _busy_ms(torch, prof)
            tokens = sum(len(t) for t in streams[ov])
            log(f"[overlap] {layout}, overlap {ov}: " + json.dumps({
                "host_wall_ms_per_step": [1e3 * w / m.decode_steps for w in walls[ov]],
                "tokens_per_s": [tokens / w for w in walls[ov]],
                "decode_steps": m.decode_steps, "decode_syncs": m.decode_syncs,
                "overlap_rounds": m.overlap_rounds,
                "idle_share": (1 - busy / (1e3 * pwall)) if busy else "not measured",
                "profiled_wall_s": pwall, "device_busy_ms": busy, "card": card}))
        if streams[True] != streams[False]:
            raise AssertionError(f"[overlap] {layout}: overlapped and serial streams differ")
        log(f"[overlap] {layout}: overlapped and serial rounds token-identical "
            f"({len(prompts)} streams; timed runs in turns True, False, False, True, "
            "True, False)")

    eng = _fresh_engine(pipe, True)
    for p in prompts:
        # 4 horizons: the first, the first overlapped round, the profiled
        # steady round (no slot retires in it) and the drain (MAX_LEN - 1
        # until [tp-quant] and [tp-spec] needed the script's time)
        eng.submit(p, SamplingParams(max_new_tokens=4 * HORIZON))
    rounds = eng.serve_rounds()
    next(rounds)                         # admission + the first horizon
    next(rounds)                         # the first overlapped round
    torch.cuda.synchronize()
    before = (eng.overlap_rounds, eng.prefill_calls, eng.decode_syncs)
    _, ms, waits, launches, where = profiled_round(torch, lambda: next(rounds),
                                                   "steady_round")
    after = (eng.overlap_rounds, eng.prefill_calls, eng.decode_syncs)
    rounds.close()
    eng.run_until_drained()
    eng.allocator.check()
    if after != (before[0] + 1, before[1], before[2] + 1):
        raise AssertionError(f"[overlap] the profiled round was not one steady overlapped "
                             f"round: (overlap_rounds, prefill_calls, decode_syncs) "
                             f"{before} -> {after}")
    log(f"[overlap] one steady overlapped round (8 live slots, no admission) under "
        f"torch.profiler: host waits on the device {waits} ({json.dumps(where)}), "
        f"{launches} kernel launches, round host wall {ms:.3f} ms (profiled)")
    if len(waits) != 1:
        raise AssertionError(f"[overlap] a steady round waited on the device "
                             f"{len(waits)} times, not once: {waits}")


def stream_phase(torch, pipe, prompts, ref_outs):
    """[stream]: one request streamed by generate_stream while the other
    seven are served; then an abort from the caller mid-stream."""
    from repro_torch.serving import SamplingParams
    sp = SamplingParams(max_new_tokens=GEN)
    eng = pipe.engine
    others = [eng.submit(p, sp) for p in prompts[1:]]
    gen = pipe.generate_stream(prompts[0], sp)
    toks = []
    while True:
        try:
            toks.append(next(gen))
        except StopIteration as fin:
            out = fin.value
            break
    rest = eng.run_until_drained()
    if not (out is not None and toks == out.token_ids and len(toks) == GEN
            and out.finish_reason == "length"):
        raise AssertionError(f"[stream] streamed {len(toks)} tokens, output "
                             f"{None if out is None else out.token_ids}")
    if sorted(o.request_id for o in rest) != others:
        raise AssertionError("[stream] the other requests' outputs went missing")
    seen = []
    rid = eng.submit(prompts[1], sp, on_token=seen.append)
    rounds = eng.serve_rounds()
    while len(seen) < 5:
        next(rounds)
    got = eng.abort(rid)
    rounds.close()
    eng.allocator.check()
    ref = ref_outs[1].token_ids
    if not (got.finish_reason == "abort" and got.token_ids == seen
            and got.token_ids == ref[:len(seen)] and len(seen) < GEN
            and eng.allocator.pages_in_use == 0 and eng.abort(rid) is None):
        raise AssertionError(f"[stream] abort returned {got.finish_reason} "
                             f"{got.token_ids} after {seen}; "
                             f"{eng.allocator.pages_in_use} pages in use")
    log(f"[stream] generate_stream yielded {len(toks)} tokens equal to its output "
        f"(equal to [serve]'s stream: {toks == ref_outs[0].token_ids}) while 7 more were "
        f"served; abort after {len(seen)} streamed tokens returned that prefix of [serve]'s "
        f"stream and freed its pages (0 in use)")


def trace_phase(torch, pipe, prompts, ref_outs):
    """[metrics]: a traced run (trace=TraceConfig()) is token-identical
    to [serve], syncs as often, and its trace passes Tracer.check(); the
    trace JSON goes to build/ (not committed)."""
    from repro_torch.serving import SamplingParams, TraceConfig
    eng = _fresh_engine(pipe, True, trace=TraceConfig())
    ids = [eng.submit(p, SamplingParams(max_new_tokens=GEN)) for p in prompts]
    by_id = {o.request_id: o for o in eng.run_until_drained()}
    problems = eng.trace.check()
    same = [by_id[i].token_ids == o.token_ids for i, o in zip(ids, ref_outs)]
    if not all(same) or problems:
        raise AssertionError(f"[metrics] traced streams equal [serve]'s: {same}; trace "
                             f"problems {problems[:3]}")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    eng.trace.dump_json(str(out_dir / "serve_trace.json"))
    m = eng.metrics()
    log(f"[metrics] traced paged run token-identical to [serve] ({len(ids)} streams), "
        f"{m.decode_syncs} syncs, {len(eng.trace)} events, {eng.trace.dropped} dropped, "
        f"Tracer.check() clean; phases admit {m.phase_admit_ms} ms, dispatch "
        f"{m.phase_dispatch_ms} ms, sync {m.phase_sync_ms} ms, walk {m.phase_walk_ms} ms; "
        f"trace in build/serve_trace.json")


# ---------------------------------------------------------------------------
# speculative decoding, fault injection and the launcher
# ---------------------------------------------------------------------------

SPEC_K = 4              # draft lookahead of [spec]
DEADLINE_MS = 600_000.0  # 10 min: only the injected skew can expire it
SKEW_MS = 3_600_000.0
FAULT_NAN_SLOT = 3       # the poisoned request (slot = request id here)
FAULT_DEADLINED = (5, 6)


def draft_ffn_in(torch, pipe, tag):
    """Hold the draft arm's served decoder FFN-in weights, fused with the
    model's NAF as a decode step runs them (ops.qmm(x, w_in, naf=)), against
    the plain versions on the same random bf16 rows (naf_vs_plain), every
    layer. Returns (format, max abs err)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.qmm import qmm_plain
    from repro_torch.models.layers import PLAIN_ACTS
    cfg, dev, bf = pipe.cfg, pipe.engine.device, torch.bfloat16
    w_in = pipe.engine.draft.params["decoder"]["layers"]["mlp"]["w_in"]
    mode = PLAIN_ACTS[cfg.mlp_act]
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    err = 0.0
    for i in range(cfg.num_layers):
        w = w_in.select(i)
        x = torch.randn((SLOTS, cfg.d_model), generator=g, device=dev).to(bf)
        q = qmm_plain(x, w.data, w.block_scales(), w.fmt, out_dtype=bf)
        err = max(err, naf_vs_plain(torch, ops.qmm(x, w, naf=mode), ops.qmm(x, w), q, mode,
                                    bf, f"[{tag}] the draft's FFN-in {w.fmt} {mode} of "
                                    f"layer {i}"))
    return w_in.fmt, err


def spec_phase(torch, card, prompts, runs):
    """[spec]: speculative decoding on [serve]'s 8 prompts and weights
    (the raw tree of seed SEED, built once and quantized for the target
    and for each draft; the target equals [serve]'s weights). Paged
    with an nf4 draft: streams equal [serve]'s; dense with an int4 draft
    (the target itself): streams equal [serve-dense]'s and every drafted
    token is accepted. A parting must be a near tie (near_tie_partings).
    The draft's served FFN-in weights, fused with the NAF, are held
    against the plain versions (draft_ffn_in). Then one round with 8 live
    slots: qmm launches 96 x K (48 a micro-step in each arm), paged_attn
    12 x K on the paged engine, exactly one host wait on the device, timed
    by torch.profiler. Returns each run's launches, by run."""
    from repro_torch.kernels import ops
    from repro_torch.models import Ctx
    from repro_torch.serving import SamplingParams, deploy
    sp = SamplingParams(max_new_tokens=GEN)
    base = runs[True][0]
    raw = base.model.init(torch.Generator(device=base.engine.device).manual_seed(SEED))
    out = {}
    for paged, draft in ((True, "nf4"), (False, "int4")):
        tag = "spec" if paged else "spec-dense"
        base, ref_outs, ref_stats = runs[paged]
        layout = dict(paged=True, page_size=PAGE) if paged else {}
        pipe = deploy("nllb600m", "int4", slots=SLOTS, max_len=MAX_LEN, horizon=HORIZON,
                      params=raw, draft_spec=draft, draft_lookahead=SPEC_K,
                      ctx=Ctx(compute_dtype=torch.bfloat16, use_fasst_kernel=True),
                      **layout)
        w_in = [p["decoder"]["layers"]["mlp"]["w_in"].data for p in (pipe.params, base.params)]
        if not torch.equal(*w_in):
            raise AssertionError(f"[{tag}] the target's weights are not [serve]'s")
        draft_fmt, draft_err = draft_ffn_in(torch, pipe, tag)
        if draft_fmt != draft:
            raise AssertionError(f"[{tag}] the draft's FFN-in is {draft_fmt}, not {draft}")
        eng = pipe.engine
        eng.reset_metrics()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        outs = pipe.generate(prompts, sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        m = eng.metrics()
        if any(o.finish_reason != "length" or len(o.token_ids) != GEN for o in outs):
            raise AssertionError(f"[{tag}] not every request retired on length")
        _check_vocab(pipe, outs)
        if paged:
            eng.allocator.check()
            if eng.allocator.pages_in_use:
                raise AssertionError(f"[{tag}] {eng.allocator.pages_in_use} pages leaked")
        if not m.verify_calls or (draft == "int4" and m.acceptance_rate != 1.0):
            raise AssertionError(f"[{tag}] {m.verify_calls} verify rounds, acceptance "
                                 f"{m.acceptance_rate} (an int4 draft of the int4 target "
                                 "must accept every token)")
        got = [o.token_ids for o in outs]
        ref = [o.token_ids for o in ref_outs]
        part = near_tie_partings(torch, tag, base, prompts, [sp] * len(prompts), got, ref)
        # one speculative round with every slot live (none retires in it)
        for p in prompts:
            eng.submit(p, sp)
        eng.step()                          # admission and a first round
        torch.cuda.synchronize()
        steps0 = eng.decode_steps
        ops.reset_launches()
        prof, round_ms, waits, _, where = profiled_round(torch, eng.step, "spec_round")
        K, per_round = eng.decode_steps - steps0, dict(ops.LAUNCHES)
        eng.run_until_drained()
        L = pipe.cfg.num_layers
        want = {"qmm": 16 * L * K, "qmm_naf": 2 * L * K, "fasst_act": 0,
                "paged_attn": 2 * L * K if paged else 0}
        if K != SPEC_K or any(per_round[k] != n for k, n in want.items()):
            raise AssertionError(f"[{tag}] a round of K={K} (lookahead {SPEC_K}) launched "
                                 f"{per_round}; expected {want}")
        if len(waits) != 1:
            raise AssertionError(f"[{tag}] a speculative round waited on the device "
                                 f"{len(waits)} times, not once: {waits}")
        busy = _busy_ms(torch, prof)
        tokens = sum(len(t) for t in got)
        log(f"[{tag}] " + json.dumps({
            "draft": pipe.draft_spec_str, "lookahead": SPEC_K, "tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "target_only_tokens_per_s": ref_stats["tokens_per_s"],
            "acceptance_rate": m.acceptance_rate,
            "mean_accepted_per_verify": m.mean_accepted_per_verify,
            "verify_calls": m.verify_calls, "decode_syncs": m.decode_syncs,
            "same_as_target_only": sum(a == b for a, b in zip(got, ref)),
            "near_tie_partings": len(part), "kv_cache_bytes": m.kv_cache_bytes,
            "round_launches": {k: per_round[k] for k in want},
            "round_host_waits": waits, "round_host_waits_placed": where,
            "round_host_ms": round_ms,
            "round_device_ms": busy if busy > 0 else "not measured",
            "draft_ffn_in_max_abs_err": draft_err, "launches": launches, "card": card}))
        out[tag.replace("-", "_")] = launches
        del pipe, eng
        torch.cuda.empty_cache()
    return out


def faults_phase(torch, card, pipe, prompts, ref_outs):
    """[faults]: [serve]'s paged configuration under one FaultPlan: a
    steal of every free page at round 1 for 4 rounds (on-demand growth
    then preempts), NaN logits on slot 3 at micro-step 5 of the first
    horizon, and a clock skew at round 1 that expires the deadlines of
    requests 5 and 6, traced. Nothing raises out of stream(); survivors
    equal [serve]'s streams (a resumed one may part only at a near tie of
    its replay), casualties keep a prefix; the allocator is clean after
    release_all; a ninth submit meets max_pending=8. Returns the launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineSaturated, FaultPlan, SamplingParams, TraceConfig
    sp = SamplingParams(max_new_tokens=GEN)
    dl = SamplingParams(max_new_tokens=GEN, deadline_ms=DEADLINE_MS)
    plan = FaultPlan(exhaust_at=[(1, SLOTS * pipe.engine.max_pages, 4)],
                     nan_at=[(0, FAULT_NAN_SLOT, 5)], skew_at=[(1, SKEW_MS)])
    eng = _fresh_engine(pipe, True, faults=plan, max_pending=len(prompts),
                        preempt_limit=16, trace=TraceConfig())
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, dl if i in FAULT_DEADLINED else sp) for i, p in enumerate(prompts)]
    try:
        eng.submit(prompts[0], sp)
    except EngineSaturated as e:
        if (e.pending, e.limit) != (len(prompts), len(prompts)):
            raise AssertionError(f"[faults] EngineSaturated({e.pending}, {e.limit})") from e
    else:
        raise AssertionError("[faults] a submit past max_pending was queued")
    by_id = {o.request_id: o for o in eng.stream()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    outs = [by_id[i] for i in ids]
    m = eng.metrics()
    reasons = [o.finish_reason for o in outs]
    want = ["error" if i == FAULT_NAN_SLOT else "deadline" if i in FAULT_DEADLINED
            else "length" for i in range(len(prompts))]
    fired = {e[0] for e in plan.events}
    if reasons != want or not {"exhaust", "nan", "skew"} <= fired:
        raise AssertionError(f"[faults] reasons {reasons}, expected {want}; events "
                             f"{plan.events}")
    if (m.slot_errors, m.deadline_expirations, m.admission_rejections) != (1, 2, 1) \
            or not (m.preemptions and m.resumed_requests):
        raise AssertionError(f"[faults] counters {m}")
    _check_vocab(pipe, outs)
    ref = [o.token_ids for o in ref_outs]
    resumes = _resumes(eng.trace)
    part = replay_partings(torch, "faults", pipe, prompts, ref,
                           [o.token_ids for o in outs], resumes)
    names = [e.name for e in eng.trace.events]
    problems = eng.trace.check()
    missing = [n for n in ("fault:exhaust", "fault:nan", "fault:skew", "deadline", "error")
               if n not in names]
    held = plan.held_pages
    plan.release_all(eng)
    eng.allocator.check()
    if eng.allocator.pages_in_use or problems or missing:
        raise AssertionError(f"[faults] {eng.allocator.pages_in_use} pages in use after "
                             f"release_all; trace problems {problems[:3]}; no {missing}")
    log("[faults] " + json.dumps({
        "reasons": reasons, "tokens": [len(o.token_ids) for o in outs],
        "events": [list(e) for e in plan.events], "held_at_drain": held,
        "preemptions": m.preemptions, "resumed_requests": m.resumed_requests,
        "slot_errors": m.slot_errors, "deadline_expirations": m.deadline_expirations,
        "admission_rejections": m.admission_rejections,
        "survivors_same_as_serve": sum(o.token_ids == r for o, r, w in zip(outs, ref, want)
                                       if w == "length"),
        "casualty_prefixes": sum(o.token_ids == r[:len(o.token_ids)]
                                 for o, r, w in zip(outs, ref, want) if w != "length"),
        "near_tie_partings": len(part), "pages_in_use_after": eng.allocator.pages_in_use,
        "wall_s": wall, "launches": launches, "card": card}))
    return launches


def launch_phase(card):
    """[launch]: the serving launcher as a user runs it, in its own process
    on the card: a paged int4 engine with an nf4 draft arm and a queue
    bound of 4. It exits 0 and prints 8 finished ``[req N]`` lines, the
    ``served`` line and the ``faults:`` line."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "nllb600m",
           "--policy", "int4", "--paged", "--draft-spec", "nf4", "--requests", "8",
           "--gen", "16", "--max-len", "128", "--horizon", "16", "--max-pending", "4"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    lines = res.stdout.splitlines()
    done = [x for x in lines if re.match(r"^\[req \d+\] slot \d+ ", x)]
    served = [x for x in lines if x.startswith("served ")]
    faults = [x for x in lines if x.startswith("faults: ")]
    if res.returncode or len(done) != 8 or len(served) != 1 or len(faults) != 1:
        raise AssertionError(f"[launch] exit {res.returncode}, {len(done)} finished "
                             f"requests; stdout tail {lines[-12:]}; stderr tail "
                             f"{res.stderr.splitlines()[-12:]}")
    for x in lines:
        if x.startswith(("model bytes", "speculative", "saturated", "served", "latency",
                         "faults")) or x in done[:2]:
            log(f"[launch] {x}")
    log(f"[launch] {' '.join(cmd[1:])}: exit 0 in {wall:.1f} s, {len(done)} requests "
        f"served; on {card}")


QUANT_CALIB = (2, 8, 64)   # [quant]'s calibration: batches, rows, tokens a row


def quant_calib(cfg):
    """[quant]'s calibration batches (QUANT_CALIB, SyntheticTranslation of
    seed SEED): [tp-quant]'s ranks calibrate on the same."""
    from repro_torch.data import SyntheticTranslation
    nb, rows, toks = QUANT_CALIB
    ds = SyntheticTranslation(cfg.vocab_size, toks, seed=SEED)
    return [{k: v for k, v in ds.sample(rows).items() if not isinstance(v, str)}
            for _ in range(nb)]


def qlora_tree(torch, raw, dev):
    """The int4 tree of ``raw`` with rank-16 QLoRA adapters, B non-zero,
    drawn from seed SEED + 1 on ``dev``: [quant-qlora]'s and
    [tp-quant-qlora]'s."""
    from repro_torch.core import (attach_lora, extract_adapters, inject_adapters,
                                  quantize_tree, resolve_spec)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = attach_lora(quantize_tree(raw, resolve_spec("int4").policy()), g, rank=16)

    def fill(node):
        if isinstance(node, dict) and set(node) == {"a", "b"}:
            return {"a": node["a"], "b": 0.02 * torch.randn(
                node["b"].shape, generator=g, device=dev)}
        return {k: fill(v) for k, v in node.items()} if isinstance(node, dict) else node
    return inject_adapters(q, fill(extract_adapters(q)))


def _quant_ffn_in(torch, pipe, tag):
    """The adapted decoder FFN-in of every layer as a decode step serves it
    (the adapted weight declines the epilogue NAF: qmm, the adapter term,
    then the FASST kernel) against the plain relu(x @ W + lora) on the same
    random bf16 rows (naf_vs_plain). Returns the max abs err."""
    from repro_torch.core.qlinear import _lora_term
    from repro_torch.kernels import ops
    from repro_torch.kernels.qmm import qmm_plain
    from repro_torch.models.layers import PLAIN_ACTS, fuses_naf
    cfg, dev, bf = pipe.cfg, pipe.engine.device, torch.bfloat16
    ctx, mode = pipe.ctx, PLAIN_ACTS[cfg.mlp_act]
    w_in = pipe.params["decoder"]["layers"]["mlp"]["w_in"]
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    err = 0.0
    for i in range(cfg.num_layers):
        w = w_in.select(i)
        x = torch.randn((SLOTS, 1, cfg.d_model), generator=g, device=dev).to(bf)
        if fuses_naf(ctx, w, x):
            raise AssertionError(f"[{tag}] the adapted FFN-in of layer {i} would fuse its NAF")
        n0 = ops.LAUNCHES["qmm_naf"]
        served = ctx.naf(ctx.dot(x, w, site="dec.ffn.in"), mode)
        if ops.LAUNCHES["qmm_naf"] != n0:
            raise AssertionError(f"[{tag}] the adapted FFN-in launched qmm_naf")
        lora = _lora_term(x, w, bf)
        y = ops.qmm(x, w.with_lora(None, None), compute_dtype=bf) + lora
        q = qmm_plain(x.reshape(SLOTS, -1), w.data, w.block_scales(), w.fmt,
                      out_dtype=bf).reshape(y.shape) + lora
        err = max(err, naf_vs_plain(torch, served, y, q, mode, bf,
                                    f"[{tag}] the adapted FFN-in of layer {i}"))
    return err


def quant_phase(torch, card, prompts, base, single):
    """[quant]: the quantization routes on [serve]'s prompts and raw
    weights (seed SEED, full width, all layers), "kernels" bundle, one
    deploy per arm:

    - w8a8, paged, calibrated on SyntheticTranslation batches (seed
      SEED): int8 weights and activations take torch._int_mm; the log
      names the calibrated sites;
    - fp8e2e, paged and dense, dynamic (it warns): fp8 weights,
      activations and KV; the pools stay float8_e4m3fn and dense and
      paged streams part only at near ties (near_tie_partings);
    - w4a8kv8, paged, calibrated: qmm takes fake-quantized inputs; the
      kernels bundle agrees with the torch bundle on a decode step
      (routes_agree), and the int8 activations move the logits;
    - int4 with rank-16 QLoRA adapters (B non-zero, seeded): the bundles
      agree on a decode step, the adapted FFN-in never launches qmm_naf,
      and the served FFN-in equals the plain relu(x @ W + lora).

    Each arm logs tokens/s and decode ms a step, a profiled 4-step
    horizon (host ms, device-busy ms, idle share, launches a step), the
    launches of each port kernel over its measured run and
    kv_cache_bytes. The paged arms' greedy streams go into
    ``single["quant"]`` (by arm: w8a8, fp8e2e, w4a8kv8, qlora), which
    [tp-quant] holds its ranks to. Returns the summed launches of the
    measured runs."""
    import dataclasses
    import warnings
    from repro_torch.core import resolve_spec
    from repro_torch.kernels import ops
    from repro_torch.models import Ctx
    from repro_torch.serving import SamplingParams, deploy

    cfg, dev = base.cfg, base.engine.device
    L = cfg.num_layers
    raw = base.model.init(torch.Generator(device=dev).manual_seed(SEED))
    nb, rows, toks = QUANT_CALIB
    calib = quant_calib(cfg)
    sp = SamplingParams(max_new_tokens=GEN)
    total = {k: 0 for k in ops.LAUNCHES}
    streams = {}

    def run(tag, spec, paged, params=raw, calibrate=False, expect=None):
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pipe = deploy("nllb600m", spec, slots=SLOTS, max_len=MAX_LEN, horizon=HORIZON,
                          params=params, calib_batches=calib if calibrate else None,
                          ctx=Ctx(compute_dtype=torch.bfloat16, use_fasst_kernel=True),
                          **(dict(paged=True, page_size=PAGE) if paged else {}))
        torch.cuda.synchronize()
        warned = [str(w.message) for w in caught if "dynamic per-token" in str(w.message)]
        s = resolve_spec(spec)
        if (s.quantizes_act or s.quantizes_attn) and bool(warned) == calibrate:
            raise AssertionError(f"[{tag}] calibrated={calibrate} but warnings {warned}")
        eng, ctx = pipe.engine, pipe.ctx
        if (ctx.act_fmt, ctx.attn_act_fmt) != (s.act, s.attn):
            raise AssertionError(f"[{tag}] ctx formats {ctx.act_fmt}/{ctx.attn_act_fmt}, "
                                 f"spec {s}")
        scales = dict(ctx.act_scales or ())
        log(f"[{tag}] deployed nllb600m {pipe.spec_str} ({'paged' if paged else 'dense'}, "
            f"kv {eng.kv_dtype}) in {time.perf_counter() - t0:.2f} s"
            + (f", calibrated on {nb} x {rows} x {toks} SyntheticTranslation tokens: "
               f"{len(scales)} sites {sorted(scales)}" if calibrate else
               (", uncalibrated: warned it quantizes dynamically" if warned else "")))
        if calibrate and not ({"enc.attn.qkv", "dec.ffn.in"} <= set(scales)
                              and all(v > 0 for v in scales.values())):
            raise AssertionError(f"[{tag}] calibrated scales {scales}")
        pipe.generate(prompts[:2], SamplingParams(max_new_tokens=4))       # warm-up
        eng.reset_metrics()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        outs = pipe.generate(prompts, sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        steps, decode_ms = eng.decode_steps, 1e3 * eng.decode_s
        for k in total:
            total[k] += launches[k]
        if any(o.finish_reason != "length" or len(o.token_ids) != GEN for o in outs):
            raise AssertionError(f"[{tag}] not every request retired on length")
        _check_vocab(pipe, outs)
        if paged:
            eng.allocator.check()
            if eng.allocator.pages_in_use:
                raise AssertionError(f"[{tag}] {eng.allocator.pages_in_use} pages leaked")
        # over the whole run, a kernel of the decode step launched and one
        # outside it did not; prefill rows (32-64 tokens) add FASST launches
        # on every arm (they never carry the NAF in qmm's epilogue)
        for name, n in expect.items():
            if (n > 0 and not launches[name]) or (n == 0 and name != "fasst_act"
                                                  and launches[name]):
                raise AssertionError(f"[{tag}] {name}: {launches[name]} launches, a decode "
                                     f"step launches {n}")
        prof = profile_decode(torch, pipe, prompts, f"{tag}-profile", expect=expect)
        m = eng.metrics()
        tokens = sum(len(o.token_ids) for o in outs)
        log(f"[{tag}] " + json.dumps({
            "spec": pipe.spec_str, "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "decode_ms_per_step": decode_ms / max(steps, 1),
            "decode_steps": steps, **prof, "launches": launches,
            "kv_cache_bytes": m.kv_cache_bytes, "calibrated_sites": len(scales),
            "card": card}))
        streams[tag] = [o.token_ids for o in outs]
        return pipe

    # w8a8: no weight reaches qmm (int8 weights take the integer route)
    tag = "quant-w8a8"
    pipe = run(tag, "w8a8", True, calibrate=True,
               expect={"qmm": 0, "qmm_naf": 0, "paged_attn": L, "fasst_act": L})
    w = pipe.params["decoder"]["layers"]["attn"]["wq"].select(0)
    if not (w.fmt == "int8" and w.block_scales().shape[-2] == 1):
        raise AssertionError(f"[{tag}] wq is {w.fmt} with {w.block_scales().shape[-2]} "
                             "K-blocks, not the per-channel int8 of the integer route")
    del pipe
    torch.cuda.empty_cache()

    # fp8e2e: paged and dense, float8 pools, streams part only at near ties
    fp8 = {}
    for paged in (True, False):
        tag = "quant-fp8e2e" + ("" if paged else "-dense")
        fp8[paged] = run(tag, "fp8e2e", paged, expect={
            "qmm": 0, "qmm_naf": 0, "paged_attn": L if paged else 0, "fasst_act": L})
        cache = fp8[paged].engine.cache
        dts = {k: str(cache[k].dtype) for k in ("k", "v", "cross_k", "cross_v")}
        if set(dts.values()) != {"torch.float8_e4m3fn"} or "k_codes" in cache:
            raise AssertionError(f"[{tag}] cache dtypes {dts}")
        log(f"[{tag}] cache {dts}, kv_cache_bytes {fp8[paged].engine.kv_cache_bytes}")
    part = near_tie_partings(torch, "quant-fp8e2e", fp8[True], prompts,
                             [sp] * len(prompts), streams["quant-fp8e2e"],
                             streams["quant-fp8e2e-dense"])
    log(f"[quant-fp8e2e] dense vs paged: {len(prompts) - len(part)}/{len(prompts)} streams "
        f"equal, {len(part)} part at near ties")
    del fp8
    torch.cuda.empty_cache()

    # w4a8kv8: fake-quantized activations into qmm (the NAF in its epilogue)
    tag = "quant-w4a8kv8"
    pipe = run(tag, "w4a8kv8", True, calibrate=True,
               expect={"qmm": 8 * L, "qmm_naf": L, "paged_attn": L, "fasst_act": 0})
    err = routes_agree(torch, pipe, prompts, tag)
    eng = pipe.engine
    for p in prompts:
        eng.submit(p, sp)
    eng.step(horizon=1)
    with torch.no_grad():
        c1 = {k: v.clone() for k, v in eng.cache.items()}
        c2 = {k: v.clone() for k, v in eng.cache.items()}
        _, la = pipe.model.decode_step(pipe.ctx, pipe.params, eng.cur, c1)
        _, lb = pipe.model.decode_step(dataclasses.replace(pipe.ctx, act_fmt="bf16"),
                                       pipe.params, eng.cur, c2)
    eng.run_until_drained()
    moved = float((la - lb).abs().max())
    if not moved > 0:
        raise AssertionError(f"[{tag}] int8 activations left the logits unchanged")
    log(f"[{tag}] a decode step with int8 activations moves the logits by up to "
        f"{moved:.4g} against bf16 activations; kernels vs torch bundle {err:.4g}")
    del pipe, eng
    torch.cuda.empty_cache()

    # int4 + rank-16 QLoRA adapters, B non-zero
    tag = "quant-qlora"
    q = qlora_tree(torch, raw, dev)
    pipe = run(tag, "int4", True, params=q,
               expect={"qmm": 8 * L, "qmm_naf": 0, "paged_attn": L, "fasst_act": L})
    err = routes_agree(torch, pipe, prompts, tag)
    ffn_err = _quant_ffn_in(torch, pipe, tag)
    log(f"[{tag}] adapted FFN-in: no qmm_naf launch, served relu(x @ W + lora) within "
        f"{ffn_err:.4g} of the plain versions; kernels vs torch bundle {err:.4g}")
    del pipe, q, raw
    torch.cuda.empty_cache()
    single["quant"] = {arm: streams[f"quant-{arm}"]
                       for arm in ("w8a8", "fp8e2e", "w4a8kv8", "qlora")}
    return total


# [train] and [eval]: the enc-dec training path and the quality grid
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 64, 1e-3    # launch.train's batch and sequence
TRAIN_STEPS, TRAIN_STEPS_8BIT, QLORA_STEPS, QLORA_RANK = 20, 5, 3, 16
EVAL_LANGS = ["hin", "eng"]
EVAL_PAIRS = [("hin", "eng"), ("eng", "hin")]
# the reference's tests/test_eval_suite.py fit and serving shape
EVAL_FIT = dict(steps=1500, batch=32, lr=3e-3, seed=0)
EVAL_FORMATS = ["bf16", "int8", "int4", "fp4", "nf4", "w8a8", "fp8e2e"]
EVAL_SERVE = dict(slots=4, max_len=16, page_size=4, horizon=4)
EVAL_SENT, EVAL_CALIB = 6, (3, 8)          # sentences a pair; calibration batches x rows
# full width: 31 new tokens a sentence (63 until [tp-quant] and [tp-spec]
# needed the script's time)
EVAL_FULL_SENT, EVAL_FULL_MAX_LEN = 8, 32


def _params_leaves(torch, tree):
    from repro_torch.tree import leaves_with_path
    return {k: v for k, v in leaves_with_path(tree) if isinstance(v, torch.Tensor)}


def train_parity(torch, dev, arch="nllb600m", batch_of=None, remat=False, tag="[train]"):
    """One f32 train step of ``arch``'s reduced config (AdamW, constant lr
    TRAIN_LR; ``remat`` recomputes each layer in the backward pass) on the
    card and on the CPU from the same parameters (``random.prng_key(SEED)``,
    the reference's init) and batch: ``batch_of(cfg)``, by default 8
    SyntheticTranslation rows. TF32 is off. Bounds: loss within 1e-5
    relative; every gradient leaf within 1e-4 of its largest element; the
    updated parameters within 1e-6 at 99.9% of elements and everywhere
    within 2 lr (Adam's first step is g / (|g| + eps) per element, so a
    gradient that is zero within rounding may take either sign)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data import SyntheticTranslation
    from repro_torch.models import Ctx, build_model
    from repro_torch.random import prng_key
    from repro_torch.train import compute_loss, make_train_step
    from repro_torch.tree import leaves_with_path, map_like

    cfg = reduce_config(get_config(arch))
    ctx = Ctx(compute_dtype=torch.float32)
    if batch_of is None:
        batch = {k: v for k, v in SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=SEED)
                 .sample(8).items() if not isinstance(v, str)}
    else:
        batch = batch_of(cfg)
    init_cpu = build_model(cfg, "cpu").init(prng_key(SEED))
    runs = {}
    for d in ("cpu", dev):
        model = build_model(cfg, d)
        params = map_like(lambda t: t.to(d), init_cpu)
        live = map_like(lambda t: t.detach().clone().requires_grad_(), params)
        leaves = [v for _, v in leaves_with_path(live)]
        loss, _ = compute_loss(ctx, model, live, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        init, step = make_train_step(model, lr_fn=lambda s: TRAIN_LR, ctx=ctx, remat=remat)
        state, _ = step(init(params), batch)
        runs[str(d)] = (float(loss.detach()),
                        [(torch.zeros_like(v) if g is None else g).cpu()
                         for v, g in zip(leaves, grads)],
                        [v.cpu() for _, v in leaves_with_path(state["params"])])
    (lc, gc, pc), (lg, gg, pg) = runs["cpu"], runs[str(dev)]
    g_err = max(float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))
                for a, b in zip(gc, gg))
    diffs = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(pc, pg)])
    close = float((diffs <= 1e-6).float().mean())
    if not (abs(lg - lc) <= 1e-5 * abs(lc) and g_err <= 1e-4 and close >= 0.999
            and float(diffs.max()) <= 2 * TRAIN_LR):
        raise AssertionError(f"{tag} {arch} card vs CPU: loss {lg!r} vs {lc!r}, gradient "
                             f"err {g_err:.3g} of each leaf's max, params within 1e-6 at "
                             f"{close:.5f}, max {float(diffs.max()):.3g}")
    log(f"{tag} parity, {cfg.name} one f32 step{' with remat' if remat else ''} (TF32 off): "
        f"loss card {lg!r} vs CPU {lc!r}; {len(gc)} gradient leaves, largest difference "
        f"{g_err:.3g} of the leaf's max (bound 1e-4); updated params within 1e-6 at "
        f"{100 * close:.3f}% of {diffs.numel()} elements (bound 99.9%), max "
        f"{float(diffs.max()):.3g} (bound 2 lr = {2 * TRAIN_LR:g})")


def _train_run(torch, step, state, batches, n, tag, card, n_params, extra=(),
               tokens=TRAIN_BATCH * TRAIN_SEQ, phase="train"):
    """``n`` steps of ``step``, each timed on the host clock to its one host
    read (the loss), ``tokens`` a step; returns (state, losses, stats)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(n):
        b = next(batches)
        t0 = time.perf_counter()
        state, met = step(state, *extra, b)
        losses.append(float(met["loss"]))
        times.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{phase}] {tag}: non-finite loss in {losses}")
    step_s = float(np.median(times[1:]))        # the first step warms cuBLAS up
    stats = {"steps": n, "step_ms": 1e3 * step_s, "first_step_ms": 1e3 * times[0],
             "tokens_per_s": tokens / step_s,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "model_tflops_per_s": 6 * n_params * tokens / step_s / 1e12,
             "share_of_bf16_peak": 6 * n_params * tokens / step_s / (BF16_FLOPS_PER_MS * 1e3),
             "loss_first": losses[0], "loss_last": losses[-1],
             "aux_loss_last": float(met.get("aux_loss", 0.0)), "card": card}
    log(f"[{phase}] {tag}: " + json.dumps(stats))
    return state, losses, stats


def profiled_train_step(torch, fn, tag, card):
    """One train step (``fn``) under torch.profiler: host ms to its end
    (the step's loss read is its one sync), device busy ms, idle share,
    kernel launches and the kernels that take most of the device time."""
    prof, ms, _, launches, _ = profiled_round(torch, fn, tag)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and getattr(e, "self_device_time_total", 0) > 0]
    if not kernels:
        log(f"{tag} the profiler recorded no device time: not measured")
        return
    busy = _busy_ms(torch, prof)
    log(f"{tag} one profiled step: host {ms:.3f} ms, device busy {busy:.3f} ms (idle share "
        f"{1 - busy / ms:.3f}), {launches} kernel launches; on {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"{tag}   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:5d}  {e.key[:100]}")


def train_phase(torch, card, dev):
    """[train]: the enc-dec training path on the card. The reduced
    config's step against the CPU's (train_parity); then full-width
    nllb600m (random weights from seed SEED, f32 parameters, bf16
    compute, SyntheticTranslation batches of TRAIN_BATCH x TRAIN_SEQ,
    warmup-cosine lr TRAIN_LR): TRAIN_STEPS steps of f32 AdamW (the mean
    loss of the last 5 below the first), TRAIN_STEPS_8BIT with 8-bit
    moments, a CheckpointManager save of that state and a restore into a
    fresh template (byte-equal), and QLORA_STEPS QLoRA steps on an nf4
    base with rank-QLORA_RANK adapters (the base's bytes unchanged, the
    adapters moved). Step ms, tokens/s, peak memory and model FLOPs
    (6 x params x tokens) per second as a share of the bf16 peak are
    printed. Returns (the launches of the phase, the f32 run's
    parameters)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, param_count
    from repro_torch.core import attach_lora, quantize_tree, resolve_spec
    from repro_torch.core.qtensor import QTensor
    from repro_torch.kernels import ops
    from repro_torch.launch.train import batches_for
    from repro_torch.models import Ctx, build_model
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import make_qlora_step, make_train_step
    from repro_torch.tree import map_like

    ops.reset_launches()
    train_parity(torch, dev)
    cfg = get_config("nllb600m")
    model = build_model(cfg, dev)
    ctx = Ctx(compute_dtype=torch.bfloat16)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(v.numel() for v in _params_leaves(torch, params).values())
    log(f"[train] nllb600m full width: {n_params} parameters ({param_count(cfg)} by the "
        f"analytic count, which leaves out the norm scales), f32, bf16 compute; batches "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}")
    batches = batches_for(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=dev)

    def lr(total):
        return lambda s: warmup_cosine(s, peak_lr=TRAIN_LR, warmup=5, total=total)

    init, step = make_train_step(model, lr_fn=lr(TRAIN_STEPS), ctx=ctx)
    state, losses, _ = _train_run(torch, step, init(params), batches, TRAIN_STEPS,
                                  "f32 AdamW", card, n_params)
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"[train] f32 loss did not fall: {losses}")
    b = next(batches)
    profiled_train_step(torch, lambda: float(step(state, b)[1]["loss"]), "[train] f32 AdamW",
                        card)
    params = state["params"]
    del state

    init, step = make_train_step(model, lr_fn=lr(TRAIN_STEPS_8BIT), ctx=ctx, state_bits=8)
    state, _, _ = _train_run(torch, step, init(params), batches, TRAIN_STEPS_8BIT,
                             "8-bit AdamW", card, n_params)
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt), keep=1)
    t0 = time.perf_counter()
    mgr.save(state, TRAIN_STEPS + TRAIN_STEPS_8BIT, blocking=True)
    t_save = time.perf_counter() - t0
    template = map_like(lambda t: None if t is None else torch.zeros_like(t), state)
    t0 = time.perf_counter()
    restored, at, _ = mgr.restore_latest(template)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    want, got = _params_leaves(torch, state), _params_leaves(torch, restored)
    if sorted(want) != sorted(got) or not all(
            want[k].dtype == got[k].dtype and torch.equal(want[k], got[k]) for k in want):
        raise AssertionError("[train] the restored checkpoint is not the saved state")
    nbytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    shutil.rmtree(ckpt)
    log(f"[train] checkpoint of the 8-bit state at step {at}: {len(want)} leaves, "
        f"{nbytes / 1e9:.2f} GB, save {t_save:.1f} s, restore into a fresh template "
        f"{t_load:.1f} s, byte-equal")
    del state, restored, template

    qparams = attach_lora(quantize_tree(params, resolve_spec("nf4").policy()),
                          torch.Generator(device=dev).manual_seed(SEED), rank=QLORA_RANK)
    base = {k: [getattr(v, f).clone() for f in QTensor._CHILDREN
                if f not in ("lora_a", "lora_b") and getattr(v, f) is not None]
            for k, v in _qtensors(qparams)}
    init, step = make_qlora_step(model, lr_fn=lr(QLORA_STEPS), ctx=ctx)
    state0 = init(qparams)
    state, _, _ = _train_run(torch, step, state0, batches, QLORA_STEPS,
                             f"QLoRA nf4 base, rank {QLORA_RANK}", card, n_params,
                             extra=(qparams,))
    for k, v in _qtensors(qparams):
        now = [getattr(v, f) for f in QTensor._CHILDREN
               if f not in ("lora_a", "lora_b") and getattr(v, f) is not None]
        if not all(torch.equal(a, b) for a, b in zip(base[k], now)):
            raise AssertionError(f"[train] QLoRA changed the quantized base at {k}")
    moved = max(float((a - b).abs().max()) for a, b in
                zip(_params_leaves(torch, state["adapters"]).values(),
                    _params_leaves(torch, state0["adapters"]).values()))
    if not moved > 0:
        raise AssertionError("[train] the QLoRA adapters did not move")
    log(f"[train] QLoRA: {len(base)} quantized weights byte-identical after "
        f"{QLORA_STEPS} steps; adapters moved by up to {moved:.3g}")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"[train] kernel launches over the phase: {launches} (training runs the plain "
        "torch routes: the kernels have no backward)")
    return launches, params


# [train-lm]: the reduced configs held card against CPU, then the full-width
# runs: (arch, layers kept (None: all), state bits, remat, microbatches,
# batch, seq, steps). The 8-bit run is the last: the reference's 8-bit
# AdamW diverges on the MoE (ROADMAP queue 3), so its loss is only held
# finite, as [train]'s 8-bit run's is.
TRAIN_LM_PARITY = ("qwen2.5-14b", "gemma3-1b", "llava-next-mistral-7b", "olmoe-1b-7b",
                   "mamba2-780m", "recurrentgemma-9b")
# gemma3-1b's and mamba2-780m's f32 runs take 6 steps (20 until [tp-ssm]
# and [tp-hybrid], 10 until [tp-quant] and [tp-spec] needed the script's
# time); olmoe's keeps TRAIN_STEPS
TRAIN_LM_STEPS = 6
TRAIN_LM_RUNS = (("gemma3-1b", None, 32, True, 2, 4, 640, TRAIN_LM_STEPS),
                 ("mamba2-780m", None, 32, True, 1, 8, 256, TRAIN_LM_STEPS),
                 ("olmoe-1b-7b", 3, 32, False, 1, 8, 64, TRAIN_STEPS),
                 ("olmoe-1b-7b", 3, 8, False, 1, 8, 64, TRAIN_STEPS_8BIT))


def _lm_parity_batch(cfg):
    """The reduced parity batch: make_batch's 4 rows of 24 positions (a
    VLM's 20 tokens after its 4 image rows), past the 8-token windows
    and SSD chunks of the reduced configs."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import make_batch
    return make_batch(cfg, ShapeSpec("train-lm", 24, 4, "train"), seed=SEED)


def train_lm_phase(torch, card, dev):
    """[train-lm]: the LM training path on the card. One f32 AdamW step
    with remat of each family's reduced config against the CPU
    (train_parity: qwen2.5-14b's QKV bias, gemma3-1b's windows, tied head
    and embedding scale, llava-next-mistral-7b's image rows, olmoe-1b-7b's
    aux loss, mamba2-780m's SSD and recurrentgemma-9b's RG-LRU); then
    TRAIN_LM_RUNS at full width, random weights from seed SEED, f32
    parameters, bf16 compute, batches from launch.train.batches_for and a
    warmup-cosine lr (peak TRAIN_LR): a _train_run JSON line and one
    profiled step each; over an f32 run's steps the mean loss of the last
    5 falls below the first; an MoE's aux loss is finite. olmoe-1b-7b
    keeps 3 of its 16 layers: f32 AdamW state is 16 bytes a parameter,
    and a step holds the old state and the new one. No kernel launches
    (training runs the plain routes). Returns the launches of the
    phase."""
    import dataclasses

    from repro_torch.configs import get_config, param_count
    from repro_torch.kernels import ops
    from repro_torch.launch.train import batches_for
    from repro_torch.models import Ctx, build_model
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import make_train_step

    ops.reset_launches()
    for arch in TRAIN_LM_PARITY:
        train_parity(torch, dev, arch, _lm_parity_batch, remat=True, tag="[train-lm]")
    ctx = Ctx(compute_dtype=torch.bfloat16)
    for arch, layers, bits, remat, mb, batch, seq, steps in TRAIN_LM_RUNS:
        whole = get_config(arch)
        cfg = whole if layers is None else dataclasses.replace(whole, num_layers=layers)
        model = build_model(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
        n_params = sum(v.numel() for v in _params_leaves(torch, params).values())
        cut = ("whole" if layers is None else
               f"depth cut to {layers} of {whole.num_layers} layers (the whole model's "
               f"{param_count(whole) / 1e9:.2f} B parameters would need "
               f"{16 * param_count(whole) / 1e9:.0f} GB of f32 AdamW state)")
        tag = f"{arch} {'8-bit' if bits == 8 else 'f32'} AdamW"
        log(f"[train-lm] {arch} full width, {cut}: {n_params} parameters, f32, bf16 "
            f"compute; batches {batch} x {seq}, remat {remat}, microbatches {mb}")
        init, step = make_train_step(
            model, ctx=ctx, state_bits=bits, remat=remat, microbatches=mb,
            lr_fn=lambda s: warmup_cosine(s, peak_lr=TRAIN_LR, warmup=5, total=TRAIN_STEPS))
        batches = batches_for(cfg, batch, seq, seed=SEED, device=dev)
        state, losses, stats = _train_run(torch, step, init(params), batches, steps, tag,
                                          card, n_params, tokens=batch * seq, phase="train-lm")
        if bits == 32 and not np.mean(losses[-5:]) < losses[0]:
            raise AssertionError(f"[train-lm] {tag}: the loss did not fall: {losses}")
        log(f"[train-lm] {tag} losses: {[round(x, 4) for x in losses]}")
        if cfg.moe is not None and not (np.isfinite(stats["aux_loss_last"])
                                        and stats["aux_loss_last"] > 0):
            raise AssertionError(f"[train-lm] {tag}: aux loss {stats['aux_loss_last']}")
        b = next(batches)
        profiled_train_step(torch, lambda: float(step(state, b)[1]["loss"]),
                            f"[train-lm] {tag}", card)
        del model, params, state, init, step
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"[train-lm] kernels launched in training: {launches}")
    log(f"[train-lm] kernel launches over the phase: {launches} (training runs the plain "
        "torch routes: the kernels have no backward)")
    return launches


def _qtensors(tree):
    from repro_torch.core.qtensor import QTensor
    from repro_torch.tree import leaves_with_path
    return [(k, v) for k, v in leaves_with_path(tree) if isinstance(v, QTensor)]


def _grid_prompts(cfg, pair_list, n_sent):
    """decode_token_grid's requests, rebuilt: (pair, B=1 prompt) per
    sentence, drawn in the grid's order from the same eval stream."""
    from repro_torch.data import LANG_CODES, SyntheticTranslation
    ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=0, languages=EVAL_LANGS,
                              split="eval")
    out = []
    for src, tgt in pair_list:
        for row in ds.sample(n_sent, pair=(src, tgt))["src_tokens"]:
            out.append(((src, tgt), {"src_tokens": row[None],
                                     "tgt_in": np.array([[LANG_CODES[tgt]]], np.int32)}))
    return out


def eval_layouts(torch, cfg, params, ctx, dev):
    """The int8 grid of dense horizon 1, paged horizon 4 and paged horizon
    4 with serial rounds: the two paged grids equal, the dense one equal
    or parting only at near ties (near_tie_partings)."""
    from repro_torch.eval import decode_token_grid
    from repro_torch.serving import SamplingParams, deploy

    kw = dict(slots=EVAL_SERVE["slots"], max_len=EVAL_SERVE["max_len"], ctx=ctx, device=dev)
    layouts = {"dense-h1": dict(horizon=1),
               "paged-h4": dict(paged=True, page_size=EVAL_SERVE["page_size"], horizon=4),
               "paged-h4-serial": dict(paged=True, page_size=EVAL_SERVE["page_size"],
                                       horizon=4, overlap=False)}
    grids, pipes = {}, {}
    for name, lay in layouts.items():
        pipes[name] = deploy(cfg, "int8", params=params, **kw, **lay)
        grids[name] = decode_token_grid(pipes[name], EVAL_PAIRS, n_sent=EVAL_SENT, seed=0,
                                        languages=EVAL_LANGS)
    if grids["paged-h4"] != grids["paged-h4-serial"]:
        raise AssertionError("[eval] overlapped and serial paged rounds serve different grids")
    flat = {n: [c for pair in EVAL_PAIRS for c in g[pair]] for n, g in grids.items()}
    prompts = _grid_prompts(cfg, EVAL_PAIRS, EVAL_SENT)
    parting = [i for i, (a, b) in enumerate(zip(flat["paged-h4"], flat["dense-h1"])) if a != b]
    gen = len(flat["paged-h4"][0][0])
    for at in range(0, len(parting), EVAL_SERVE["slots"]):
        idx = parting[at:at + EVAL_SERVE["slots"]]
        near_tie_partings(torch, "eval-layouts", pipes["paged-h4"], [prompts[i][1] for i in idx],
                          [SamplingParams(max_new_tokens=gen)] * len(idx),
                          [list(flat["paged-h4"][i][0]) for i in idx],
                          [list(flat["dense-h1"][i][0]) for i in idx], engine_kw=EVAL_SERVE)
    log(f"[eval] layouts: int8 grids of {len(flat['dense-h1'])} sentences; paged horizon 4 "
        f"overlapped == serial; dense horizon 1 vs paged horizon 4: "
        f"{len(flat['dense-h1']) - len(parting)} equal, {len(parting)} part at near ties")


def eval_phase(torch, card, full_params, dev):
    """[eval]: the paper's quality grid on the card. The reduced config is
    trained by the port's TrainLoop at the reference test's settings
    (EVAL_FIT), then quant_sweep deploys it at every EVAL_FORMATS spec
    through the "kernels" bundle (paged, page 4, horizon 4, 4 slots,
    max_len 16; w8a8 calibrated on 3 batches of 8) over hin<->eng, 6
    sentences a direction, traced. Gates (the reference test's): bf16
    mean BLEU and chrF > 0.8; int8 within 0.15 of bf16 on both, with
    fewer model bytes; w8a8 mean BLEU > 0.5. Then the layouts
    (eval_layouts), and full width: the [train] phase's f32 parameters
    deployed at int4, paged, through the kernels, scored on hin<->eng
    with EVAL_FULL_SENT sentences of EVAL_FULL_MAX_LEN - 1 new tokens (floor scores: the
    model is barely trained); qmm and paged attention must launch. The
    report goes to build/eval_report.json and .md. Returns the launches
    of the sweep and the full-width run."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data import SyntheticTranslation
    from repro_torch.eval import (evaluate_pairs, load, make_report, quant_sweep,
                                  render_markdown, save, summarize)
    from repro_torch.kernels import ops
    from repro_torch.launch.eval import train_params
    from repro_torch.models import Ctx, build_model
    from repro_torch.serving import deploy, impl_routes
    from repro_torch.train import make_train_step

    cfg = reduce_config(get_config("nllb600m"))
    t0 = time.perf_counter()
    params = train_params(cfg, EVAL_LANGS, device=dev, log=lambda m: log(f"[eval] {m}"),
                          **EVAL_FIT)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    log(f"[eval] the reduced config's fit: {EVAL_FIT['steps']} steps in {fit_s:.1f} s "
        f"({1e3 * fit_s / EVAL_FIT['steps']:.2f} ms a step) on {card}")
    fit_model = build_model(cfg, dev)
    init, step = make_train_step(fit_model, lr_fn=lambda s: EVAL_FIT["lr"],
                                 ctx=Ctx(compute_dtype=torch.float32))
    state = init(params)
    b = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticTranslation(
        cfg.vocab_size, cfg.enc_len, seed=0, languages=EVAL_LANGS).sample(
        EVAL_FIT["batch"]).items() if not isinstance(v, str)}
    profiled_train_step(torch, lambda: float(step(state, b)[1]["loss"]), "[eval] fit", card)
    del state

    ctx = Ctx(compute_dtype=torch.float32, use_fasst_kernel=True)
    nb, rows = EVAL_CALIB

    def calib():
        ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=0, languages=EVAL_LANGS)
        return ({k: torch.as_tensor(v, device=dev) for k, v in ds.sample(rows).items()
                 if not isinstance(v, str)} for _ in range(nb))

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    sweep = quant_sweep(cfg, EVAL_FORMATS, params=params, pair_list=EVAL_PAIRS,
                        languages=EVAL_LANGS, n_sent=EVAL_SENT, seed=0,
                        calib_batches_fn=calib,
                        deploy_kwargs=dict(EVAL_SERVE, paged=True, ctx=ctx, device=dev,
                                           **impl_routes("kernels")),
                        trace=True, log=lambda m: log(f"[eval] {m}"))
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for name in ("qmm", "qmm_naf", "paged_attn", "fasst_act"):
        if not launches[name]:
            raise AssertionError(f"[eval] the sweep launched no {name}")
    rows = {r.fmt: r for r in sweep}
    for r in sweep:
        log(f"[eval] {r.fmt:6s} {r.spec:14s} model bytes {r.model_bytes} ({r.compression:.2f}x)"
            f" BLEU {r.mean_bleu:.4f} chrF {r.mean_chrf:.4f} (delta {r.bleu_delta}, "
            f"{r.chrf_delta}) tok/s {r.mean_tok_s} TTFT p95 {r.ttft_p95_ms} ms TPOT p95 "
            f"{r.tpot_p95_ms} ms calibrated {r.calibrated} phases {r.round_phases}")
    bf16, int8, w8a8 = rows["bf16"], rows["int8"], rows["w8a8"]
    if not (bf16.mean_bleu > 0.8 and bf16.mean_chrf > 0.8):
        raise AssertionError(f"[eval] bf16 BLEU {bf16.mean_bleu} / chrF {bf16.mean_chrf} <= 0.8")
    if not (abs(int8.bleu_delta) <= 0.15 and abs(int8.chrf_delta) <= 0.15
            and int8.model_bytes < bf16.model_bytes):
        raise AssertionError(f"[eval] int8 deltas {int8.bleu_delta}, {int8.chrf_delta}, "
                             f"bytes {int8.model_bytes} vs {bf16.model_bytes}")
    if not (w8a8.calibrated and w8a8.mean_bleu > 0.5):
        raise AssertionError(f"[eval] w8a8 BLEU {w8a8.mean_bleu} (calibrated {w8a8.calibrated})")
    report = make_report(arch=cfg.name, rows=[r.as_row() for r in sweep],
                         config={"formats": EVAL_FORMATS, "fit": EVAL_FIT,
                                 "pairs": [f"{s}-{t}" for s, t in EVAL_PAIRS],
                                 "n_sent": EVAL_SENT, "serve": EVAL_SERVE, "paged": True,
                                 "impl": "kernels", "device": card})
    (ROOT / "build").mkdir(exist_ok=True)
    save(report, str(ROOT / "build" / "eval_report.json"))
    (ROOT / "build" / "eval_report.md").write_text(render_markdown(report) + "\n")
    if load((ROOT / "build" / "eval_report.json").read_text()) != report:
        raise AssertionError("[eval] the report does not load back")
    log(f"[eval] sweep of {len(sweep)} formats in {sweep_s:.1f} s; gates met: bf16 BLEU "
        f"{bf16.mean_bleu:.4f} chrF {bf16.mean_chrf:.4f} (> 0.8), int8 delta "
        f"{int8.bleu_delta:+.4f} / {int8.chrf_delta:+.4f} (<= 0.15), w8a8 BLEU "
        f"{w8a8.mean_bleu:.4f} (> 0.5); launches {launches}; report in build/eval_report.json")

    eval_layouts(torch, cfg, params, ctx, dev)

    t0 = time.perf_counter()
    pipe = deploy("nllb600m", "int4", params=full_params, slots=EVAL_FULL_SENT,
                  max_len=EVAL_FULL_MAX_LEN, paged=True, page_size=PAGE, horizon=HORIZON,
                  ctx=Ctx(compute_dtype=torch.bfloat16, use_fasst_kernel=True), device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    scores = evaluate_pairs(pipe, EVAL_PAIRS, n_sent=EVAL_FULL_SENT, seed=0,
                            languages=EVAL_LANGS)
    torch.cuda.synchronize()
    full = dict(ops.LAUNCHES)
    if not (full["qmm"] and full["paged_attn"]):
        raise AssertionError(f"[eval] full width: qmm / paged_attn did not launch: {full}")
    agg = summarize(scores)
    log(f"[eval] full width nllb600m int4 paged ({TRAIN_STEPS}-step weights, floor scores): "
        + json.dumps({"pairs": [(s.src, s.tgt, s.bleu, s.chrf, s.gen_tokens, s.tok_s,
                                 s.ttft_p95_ms, s.tpot_p95_ms) for s in scores],
                      "mean_bleu": agg["mean_bleu"], "mean_chrf": agg["mean_chrf"],
                      "seconds": time.perf_counter() - t0, "launches": full, "card": card}))
    return {k: launches[k] + full[k] for k in launches}


def api_path(torch, pipe):
    """The ops API path of the two kernels that no serving path launches
    and of the FASST activation, which the served path launches only at
    prefill rows:
    ``ops.decode_attention`` on every layer's self and cross int8 caches
    of the dense engine with 8 live slots, ``ops.fasst_softmax`` as the
    sampler's temperature softmax over the engine's next-token logits,
    and ``ops.fasst`` as the FFN activation of every decoder layer's
    FFN-in product (random bf16 rows on the served weights), held bit for
    bit against the served route's qmm epilogue, and both against the
    plain versions. Counters are set to 0 just before and read just
    after."""
    from repro_torch.data import LANG_CODES
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attn import decode_attn_plain
    from repro_torch.kernels.fasst import fasst_softmax_plain
    from repro_torch.kernels.qmm import qmm_plain
    from repro_torch.models.layers import PLAIN_ACTS
    from repro_torch.serving import SamplingParams

    eng = pipe.engine
    srcs, langs = _requests(np.random.default_rng(SEED + 5), LANG_CODES, SLOTS)
    prompts = [{"src_tokens": s[None], "tgt_in": np.array([[LANG_CODES[lg]]], np.int32)}
               for s, lg in zip(srcs, langs)]
    for p in prompts:
        eng.submit(p, SamplingParams(max_new_tokens=GEN))
    eng.step(horizon=4)
    if not all(s.active for s in eng.slots):
        raise AssertionError("[api] not every slot is live")
    cfg, c = pipe.cfg, eng.cache
    B, H, d = SLOTS, cfg.num_heads, cfg.head_dim
    g = torch.Generator(device=eng.device).manual_seed(SEED + 5)
    qs = [torch.randn((B, H, d), generator=g, device=eng.device).to(torch.bfloat16)
          for _ in range(2 * cfg.num_layers)]
    w_in = pipe.params["decoder"]["layers"]["mlp"]["w_in"]
    ffn = [(torch.randn((B, cfg.d_model), generator=g, device=eng.device)
            .to(torch.bfloat16), w_in.select(i)) for i in range(cfg.num_layers)]
    mode = PLAIN_ACTS[cfg.mlp_act]
    with torch.no_grad():
        _, logits = pipe.model.decode_step(pipe.ctx, pipe.params, eng.cur,
                                           {k: v.clone() for k, v in c.items()})
    reads = []
    for i in range(cfg.num_layers):
        reads.append((c["k_codes"][i], c["k_scales"][i], c["v_codes"][i],
                      c["v_scales"][i], c["len"]))
        reads.append((c["cross_k_codes"][i], c["cross_k_scales"][i],
                      c["cross_v_codes"][i], c["cross_v_scales"][i], c["cross_len"]))
    torch.cuda.synchronize()
    ops.reset_launches()
    outs = [ops.decode_attention(q, *r, out_dtype=torch.float32) for q, r in zip(qs, reads)]
    probs = ops.fasst_softmax(logits[:, -1], scale=1 / 0.7)
    hs = [(x, w, ops.fasst(ops.qmm(x, w), mode)) for x, w in ffn]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    for name, n in (("decode_attn", 2 * cfg.num_layers), ("fasst_softmax", 1),
                    ("fasst_act", cfg.num_layers)):
        if launches[name] != n:
            raise AssertionError(f"[api] {name}: {launches[name]} launches, expected {n}")
    if not all(torch.equal(h, ops.qmm(x, w, naf=mode)) for x, w, h in hs):
        raise AssertionError(f"[api] ops.fasst(ops.qmm(x, w_in), {mode!r}) is not the "
                             "fused qmm epilogue's output bit for bit")
    bf = torch.bfloat16
    h_err = max(naf_vs_plain(torch, h, ops.qmm(x, w),
                             qmm_plain(x, w.data, w.block_scales(), w.fmt, out_dtype=bf),
                             mode, bf, f"[api] FFN-in {mode} of layer {i}")
                for i, (x, w, h) in enumerate(hs))
    err = max(float((o - decode_attn_plain(q.reshape(B, H, 1, d), *r, d ** -0.5)
                     .reshape(B, H, d)).abs().max()) for o, q, r in zip(outs, qs, reads))
    p_err, p_rel = softmax_err(probs, fasst_softmax_plain(logits[:, -1], scale=1 / 0.7))
    if not (err < 1e-5 and p_err <= 1e-6 and p_rel <= 1.0
            and bool(torch.isfinite(probs).all())):
        raise AssertionError(f"[api] decode_attn err {err:.3g}, fasst_softmax err "
                             f"{p_err:.3g} (relative-bound share {p_rel:.3g})")
    log(f"[api] on the dense engine's live caches (len {c['len'].tolist()}, cross_len "
        f"{c['cross_len'].tolist()}): decode_attn={launches['decode_attn']} launches, "
        f"max abs err {err:.3g} vs decode_attn_plain; fasst_softmax={launches['fasst_softmax']} "
        f"launch on {tuple(logits[:, -1].shape)} logits, max abs err {p_err:.3g}, "
        f"largest |y - p| / ({SOFTMAX_RTOL:g} |p| + {SOFTMAX_FLOOR:g}) {p_rel:.3g} vs "
        f"fasst_softmax_plain; fasst_act={launches['fasst_act']} {mode} launches on the "
        f"decoder's FFN-in products ({B}, {cfg.d_ff}), equal to qmm's fused epilogue bit "
        f"for bit, both within the bound of fasst_act_plain(qmm_plain) (max abs err "
        f"{h_err:.3g})")
    eng.run_until_drained()
    return launches


# ---------------------------------------------------------------------------
# [lm], [lm-gemma], [vlm]: the decoder-only LMs
# ---------------------------------------------------------------------------

# qwen2.5-14b at full width, its decode step's kernels timed at 24 of 48
# layers: deploy() draws the f32 tree whole and quantizes it, as the
# reference does; all 48 layers are 59 GB in f32 (14.77 B parameters) and
# the quantization temporaries of the stacked (48, 5120, 13824) gate and
# up leaves would pass 80 GB
LM_ARCH, LM_LAYERS = "qwen2.5-14b", 24
# served depth cuts: qwen2.5-14b's 48-layer f32 init and quantization do
# not fit the card; olmoe-1b-7b keeps 8 of its 16 layers for the script's
# time limit (with all 16 the script ran 1070.5 s of its 1200 on an
# "NVIDIA H100 80GB HBM3, 700.00 W" host); [lm] serves qwen2.5-14b at 12
# of 48 layers and [vlm] llava-next-mistral-7b at 16 of 32 (24 and whole
# until [tp-ssm] and [tp-hybrid] needed the script's time; rows 1q / 2q
# still time LM_LAYERS); [lm-gemma] serves gemma3-1b at 13 of 26 layers
# (two of its 5 local : 1 global groups and a local layer, as [tp-lm];
# whole until [tp-quant] and [tp-spec] needed the script's time)
DEPTH_CUTS = {LM_ARCH: 12, "llava-next-mistral-7b": 16, "olmoe-1b-7b": 8, "gemma3-1b": 13}
LM_KN = ((5120, 5120), (5120, 1024), (5120, 13824), (13824, 5120))
LM_HEAD_KN = (5120, 152064)
LONG_LEN = 768          # [lm-gemma] and [vlm] cache length


def check_lm_kernels(torch, dev):
    """qmm and paged attention at qwen2.5-14b's served shapes, held against
    their plain versions before the [lm] phase, and one decode step's
    worth of each timed:

    - qmm at the four served (K, N) pairs (int4, sub-block 64) and at the
      untied lm_head (int8; the served head takes the dequantize route,
      as in the reference, so this checks the kernel at that shape only),
      at decode rows (8) and prefill rows (512) (qmm_agree);
    - paged attention at B 8, H 40, Hkv 8 (G = 5), d 128, page 16, int8
      and bf16 pages, ragged lengths up to 128 and the edges 0/1/16/17/128
      (G·d/4 = 160 > 128 threads: the P·V loop strides).

    Each LM phase then holds the kernels at every shape its served run
    gave them (hold_served). Returns the ``lm_`` keys of the qmm and
    paged_attn entries."""
    from repro_torch.core.qtensor import QTensor

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    worst = 0.0
    for fmt, (k, n) in [("int4", kn) for kn in LM_KN] + [("int8", LM_HEAD_KN)]:
        qt = QTensor.quantize(torch.randn((k, n), generator=g, device=dev) * 0.02, fmt, 64)
        for m in (SLOTS, 512):
            err, _ = qmm_agree(torch, torch.randn((m, k), generator=g, device=dev), qt,
                               "[lm-kernels] qmm")
            if m == SLOTS:
                worst = max(worst, err)
        del qt
    log(f"[kernels] qmm at {LM_ARCH}'s served shapes: int4 (K, N) {list(LM_KN)} and the "
        f"int8 lm_head {LM_HEAD_KN}, M = {SLOTS} and 512, f32 and bf16 out, agree with "
        f"qmm_plain (norm-relative 1e-5 f32, 4e-3 bf16), every case launched twice and "
        f"bit-identical; max abs err (M={SLOTS}, f32 out) {worst:.3g}")

    # one decode step's qmm work: 24 layers x (q, o 5120x5120; k, v
    # 5120x1024; gate, up 5120x13824; down 13824x5120), each launch on its
    # own int4 weight, as in the model (3.3 GB of codes, far past the L2)
    layer = [(5120, 5120)] * 2 + [(5120, 1024)] * 2 + [(5120, 13824)] * 2 + [(13824, 5120)]
    ws = [QTensor.quantize(torch.randn(kn, generator=g, device=dev) * 0.02, "int4", 64)
          for _ in range(LM_LAYERS) for kn in layer]
    fns, (t, by) = qmm_window(torch, g, dev, ws, SLOTS)
    out = {"qmm": {**times(*fns, plain_reps=2), "bound_ms": t, "bound_by": by,
                   "max_abs_err": worst,
                   "work": f"one {LM_ARCH} decode step ({LM_LAYERS} layers): {len(ws)} int4 "
                           f"launches at M={SLOTS} (q, o 5120x5120; k, v 5120x1024; gate, "
                           "up 5120x13824; down 13824x5120)"}}
    del ws, fns
    torch.cuda.empty_cache()

    H, Hkv, d, ps, maxp = 40, 8, 128, PAGE, MAX_LEN // PAGE
    plans, worst = {}, 0.0
    for kind in ("int8", "bf16"):
        lens = torch.randint(1, MAX_LEN + 1, (SLOTS,), generator=g, device=dev).tolist()
        worst = max(worst, paged_case(torch, g, dev, SLOTS, H, Hkv, d, SLOTS * maxp + 1, ps,
                                      maxp, lens, kind, torch.bfloat16, "served", plans))
        paged_case(torch, g, dev, 5, H, Hkv, d, 5 * maxp + 1, ps, maxp,
                   [0, 1, 16, 17, MAX_LEN], kind, None, "edges", plans)
    log(f"[kernels] paged_attn at {LM_ARCH}'s served shape (B={SLOTS} H={H} Hkv={Hkv} "
        f"G={H // Hkv} d={d} ps={ps}): int8 and bf16 pages agree with paged_attn_plain "
        f"(< 1e-5), ragged lengths and 0/1/16/17/{MAX_LEN}, every case launched twice and "
        f"bit-identical; plans (int8): " + "; ".join(f"{k} {v}" for k, v in plans.items())
        + f"; max abs err {worst:.3g}")

    # one decode step's paged attention: 24 launches on their own int8
    # pools, ragged lengths up to max_len
    lens = torch.randint(1, MAX_LEN + 1, (SLOTS,), generator=g, device=dev)
    fns, (t, by), work = paged_window(torch, g, dev, H, Hkv, d, maxp, LM_LAYERS, lens)
    out["paged_attn"] = {**times(*fns), "bound_ms": t, "bound_by": by, "max_abs_err": worst,
                         "work": f"one {LM_ARCH} decode step: {work}"}
    del fns
    torch.cuda.empty_cache()
    return {name: {f"lm_{k}": v for k, v in e.items()} for name, e in out.items()}


@contextlib.contextmanager
def served_shapes():
    """While the block runs, wrap ops.qmm, ops.fasst and
    ops.paged_decode_attention to record the shapes the main path hands
    them: the first weight of each (rows, K, N, format, sub-block, compute
    dtype, NAF), each (shape, dtype, mode, out dtype) of the activation
    (an MoE layer's experts hand it 4-D (G, E, C, ff) inputs), and each
    (B, H, Hkv, d, page size, pages a row, page kind, query dtype) of the
    paged attention. The wrappers' launch counts are untouched."""
    import torch
    from repro_torch.kernels import ops
    qmm, fasst, paged = ops.qmm, ops.fasst, ops.paged_decode_attention
    seen = {"qmm": {}, "fasst_act": set(), "paged_attn": set()}

    def rec_qmm(x, w, **kw):
        k, n = w.shape[-2:]
        seen["qmm"].setdefault((x.numel() // k, k, n, w.fmt, k // w.scales_shape[-2],
                                kw.get("compute_dtype"), kw.get("naf")), w)
        return qmm(x, w, **kw)

    def rec_fasst(x, mode, **kw):
        seen["fasst_act"].add((tuple(x.shape), x.dtype, mode, kw.get("out_dtype")))
        return fasst(x, mode, **kw)

    def rec_paged(q, k_pages, v_pages, tables, lengths, **kw):
        kind = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}.get(k_pages.dtype, "bf16")
        seen["paged_attn"].add((*q.shape, k_pages.shape[2], k_pages.shape[1],
                                tables.shape[1], kind, q.dtype))
        return paged(q, k_pages, v_pages, tables, lengths, **kw)

    ops.qmm, ops.fasst, ops.paged_decode_attention = rec_qmm, rec_fasst, rec_paged
    try:
        yield seen
    finally:
        ops.qmm, ops.fasst, ops.paged_decode_attention = qmm, fasst, paged


def hold_served(torch, tag, seen, dev, need=("qmm", "fasst_act")):
    """Hold qmm (on the served weights themselves, random f32 rows, f32
    and bf16 out), the FASST activation (random inputs) and the paged
    attention (a random pool, ragged lengths up to the served chain)
    against their plain versions at every shape ``seen`` recorded
    (served_shapes); each kernel in ``need`` must have been given one."""
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    worst = {"qmm": 0.0, "fasst_act": 0.0, "paged_attn": 0.0}
    for B, H, d, Hkv, ps, maxp, kind, q_dt in sorted(seen["paged_attn"], key=str):
        lens = torch.randint(1, maxp * ps + 1, (B,), generator=g, device=dev).tolist()
        worst["paged_attn"] = max(worst["paged_attn"], paged_case(
            torch, g, dev, B, H, Hkv, d, B * maxp + 1, ps, maxp, lens, kind, q_dt))
    for (m, k, *_, naf), w in seen["qmm"].items():
        x = torch.randn((m, k), generator=g, device=dev)
        worst["qmm"] = max(worst["qmm"], qmm_agree(torch, x, w, f"[{tag}] served", naf)[0])
    for shape, dt, mode, out_dt in seen["fasst_act"]:
        x = (3 * torch.randn(shape, generator=g, device=dev)).to(dt)
        worst["fasst_act"] = max(worst["fasst_act"],
                                 fasst_agree(torch, x, mode, f"[{tag}] served ", out_dt))
    rows = sorted({key[0] for key in seen["qmm"]})
    kns = sorted({key[1:3] for key in seen["qmm"]})
    acts = sorted({(s, m) for s, _, m, _ in seen["fasst_act"]})
    paged = sorted({f"B={B} H={H} Hkv={Hkv} d={d} ps={ps} maxp={maxp} {kind}"
                    for B, H, d, Hkv, ps, maxp, kind, _ in seen["paged_attn"]})
    log(f"[{tag}] the kernels at every shape the served run gave them agree with their "
        f"plain versions: qmm at {len(seen['qmm'])} (rows, K, N, format) on the served "
        f"weights, rows {rows}, (K, N) {kns}, f32 and bf16 out (max abs err f32 "
        f"{worst['qmm']:.3g}); fasst_act at {acts} (max abs err {worst['fasst_act']:.3g})"
        + (f"; paged_attn at {paged}, launched twice and bit-identical (max abs err "
           f"{worst['paged_attn']:.3g})" if paged else ""))
    missing = [k for k in need if not seen[k]]
    if missing:
        raise AssertionError(f"[{tag}] the served run recorded no {missing} shape")


def _arch_line(c) -> str:
    """A deployed config's widths, per family."""
    if c.family == "ssm":
        s = c.ssm
        return (f"d {c.d_model}, SSD state {s.state_dim}, {s.expand * c.d_model // s.head_dim} "
                f"heads of {s.head_dim}, chunk {s.chunk}, no FFN")
    head = f"{c.num_heads}/{c.num_kv_heads} heads of {c.head_dim}"
    if c.family == "hybrid":
        head += f", RG-LRU width {c.d_rec}, local window {c.local_window}"
    return f"d {c.d_model}, {head}, d_ff {c.d_ff} ({c.mlp_act})"


def _lm_deploy(torch, tag, arch, paged, max_len, params=None, cut=""):
    from repro_torch.configs import get_config
    from repro_torch.models import Ctx
    from repro_torch.serving import deploy
    import dataclasses
    cfg = get_config(arch)
    if arch in DEPTH_CUTS:
        cfg = dataclasses.replace(cfg, num_layers=DEPTH_CUTS[arch])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = deploy(cfg, "int4", slots=SLOTS, max_len=max_len, horizon=HORIZON,
                  init_seed=SEED, params=params,
                  ctx=Ctx(compute_dtype=torch.bfloat16, use_fasst_kernel=True),
                  **(dict(paged=True, page_size=PAGE) if paged else {}))
    torch.cuda.synchronize()
    c = pipe.cfg
    kv = {"ssm": "recurrent state", "hybrid": "bf16 rolling KV"}.get(c.family, "int8 KV")
    log(f"[{tag}] deployed {arch} int4 ({'paged' if paged else 'dense'} {kv}, max_len "
        f"{max_len}) in {time.perf_counter() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB: {_arch_line(c)}, vocab "
        f"{c.vocab_size}, {c.num_layers} layers{cut}; "
        + (f"{pipe.fp_bytes / 1e9:.2f} GB f32 -> {pipe.quantized_bytes / 1e9:.2f} GB, "
           f"random weights from seed {SEED}" if params is None else
           f"the paged engine's {pipe.quantized_bytes / 1e9:.2f} GB of weights"))
    return pipe


def lm_serve(torch, card, tag, pipe, prompts, expect, prefill_only=()):
    """Serve ``prompts`` (8 requests x GEN new tokens, greedy) after a
    warm-up on the same prompts that records the shapes the engine hands
    qmm and the FASST activation and holds both there (hold_served), with
    the launch counters set to 0 just before and read just after. ``expect`` gives a decode step's wrapper launches: a kernel
    with n > 0 launches at least n a step over the run, one with 0 never,
    unless it is named in ``prefill_only`` (the prefill rows add qmm and
    fasst_act launches). Then a profiled
    4-step horizon, which must launch exactly ``expect``. Logs the phase's
    JSON line; returns (outputs, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import SamplingParams
    eng = pipe.engine
    # warm-up: the same requests, 4 tokens each, admitted in the same
    # prefill calls as the measured run; then the kernels are held at
    # every shape it gave them
    with served_shapes() as seen:
        pipe.generate(prompts, SamplingParams(max_new_tokens=4))
    hold_served(torch, tag, seen, eng.device,
                [k for k in ("qmm", "fasst_act") if expect[k] or k in prefill_only])
    eng.reset_metrics()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = pipe.generate(prompts, SamplingParams(max_new_tokens=GEN))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(outs) != len(prompts) or any(o.finish_reason != "length"
                                        or len(o.token_ids) != GEN for o in outs):
        raise AssertionError(f"[{tag}] not every request retired on length: "
                             f"{[(o.finish_reason, len(o.token_ids)) for o in outs]}")
    _check_vocab(pipe, outs)
    if eng.paged:
        eng.allocator.check()
        if eng.allocator.pages_in_use:
            raise AssertionError(f"[{tag}] {eng.allocator.pages_in_use} pages leaked")
    steps = eng.decode_steps
    for name, n in expect.items():
        if (n > 0 and launches[name] < n * steps) or (
                n == 0 and launches[name] and name not in prefill_only):
            raise AssertionError(f"[{tag}] {name}: {launches[name]} launches over "
                                 f"{steps} decode steps; a step launches {n}")
    prof = profile_decode(torch, pipe, prompts, f"{tag}-profile", expect=expect)
    tokens = sum(len(o.token_ids) for o in outs)
    stats = {"arch": pipe.cfg.name, "layers": pipe.cfg.num_layers,
             "layout": "paged" if eng.paged else "dense", "requests": len(outs),
             "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
             "decode_steps": steps, "decode_ms_per_step": 1e3 * eng.decode_s / max(steps, 1),
             "prefill_calls": eng.prefill_calls,
             "prefill_ms_per_call": 1e3 * eng.prefill_s / max(eng.prefill_calls, 1),
             "peak_mem_gb": peak, **prof,
             "launches_per_step": {k: v for k, v in expect.items()},
             "launches": launches, "card": card}
    log(f"[{tag}] " + json.dumps(stats))
    log(f"[{tag}] first stream: {outs[0].token_ids[:12]} ...")
    return outs, launches


def _lm_prompts(rng, vocab, lo, hi):
    return [{"tokens": rng.integers(0, vocab, (1, int(n))).astype(np.int32)}
            for n in rng.integers(lo, hi + 1, SLOTS)]


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def lm_phase(torch, card):
    """[lm]: qwen2.5-14b at int4, full width, 12 of its 48 layers, paged
    (the paged-attention kernel: no windows) and dense on the same
    weights; 8 requests of 32-64 prompt tokens x 32 new tokens, greedy.
    The kernel bundle agrees with the torch bundle on live slots, and
    dense and paged streams part only at near ties. Returns the launches
    of the measured runs."""
    from repro_torch.serving import SamplingParams
    cut = (f" (depth cut to {DEPTH_CUTS[LM_ARCH]} of 48: the 48-layer f32 init is 59 GB "
           "and its quantization temporaries pass 80 GB)")
    pipe = _lm_deploy(torch, "lm", LM_ARCH, True, MAX_LEN, cut=cut)
    L, V = pipe.cfg.num_layers, pipe.cfg.vocab_size
    prompts = _lm_prompts(np.random.default_rng(SEED + 20), V, 32, 64)
    expect = {"qmm": 7 * L, "qmm_naf": 0, "paged_attn": L, "fasst_act": L}
    outs, launches = lm_serve(torch, card, "lm", pipe, prompts, expect)
    routes_agree(torch, pipe, prompts, "lm-routes")
    pipe_d = _lm_deploy(torch, "lm-dense", LM_ARCH, False, MAX_LEN, params=pipe.params,
                        cut=cut)
    outs_d, launches_d = lm_serve(torch, card, "lm-dense", pipe_d, prompts,
                                  dict(expect, paged_attn=0))
    paged, dense = [o.token_ids for o in outs], [o.token_ids for o in outs_d]
    part = near_tie_partings(torch, "lm-dense-vs-paged", pipe, prompts,
                             [SamplingParams(max_new_tokens=GEN)] * len(prompts), paged, dense,
                             first_token_ties=True)
    log(f"[lm-dense-vs-paged] {sum(a == b for a, b in zip(paged, dense))}/{len(prompts)} "
        f"streams token-identical, {len(part)} part, each at a near tie")
    del pipe, pipe_d
    torch.cuda.empty_cache()
    return _add(dict(launches), launches_d)


def lm_gemma_phase(torch, card):
    """[lm-gemma]: gemma3-1b at int4, full width, 13 of its 26 layers
    (DEPTH_CUTS; tied head, q/k norm, embed scale, 5:1 local:global
    windows of 512: 11 local and 2 global layers), paged
    and dense; prompts of 520-700 tokens, so the local windows truncate.
    The paged step takes the reference's gather route: no paged-attention
    launch over the whole run. The kernel bundle agrees with the torch
    bundle on live slots, and dense and paged streams part only at near
    ties. Returns the launches of the measured runs."""
    from repro_torch.models.transformer import window_array
    from repro_torch.serving import SamplingParams
    pipe = _lm_deploy(torch, "lm-gemma", "gemma3-1b", True, LONG_LEN)
    cfg = pipe.cfg
    L = cfg.num_layers
    prompts = _lm_prompts(np.random.default_rng(SEED + 21), cfg.vocab_size, 520, 700)
    lens = [p["tokens"].shape[1] for p in prompts]
    wins = window_array(cfg)
    log(f"[lm-gemma] prompts of {min(lens)}-{max(lens)} tokens against windows "
        f"{sorted(set(wins))} ({wins.count(512)} local, {wins.count(0)} global layers): the "
        "local windows truncate; the paged step takes the gather route (no paged_attn "
        "launch), as the reference's does for a windowed arch")
    expect = {"qmm": 7 * L, "qmm_naf": 0, "paged_attn": 0, "fasst_act": L}
    outs, launches = lm_serve(torch, card, "lm-gemma", pipe, prompts, expect)
    routes_agree(torch, pipe, prompts, "lm-gemma-routes")
    pipe_d = _lm_deploy(torch, "lm-gemma-dense", "gemma3-1b", False, LONG_LEN,
                        params=pipe.params)
    outs_d, launches_d = lm_serve(torch, card, "lm-gemma-dense", pipe_d, prompts, expect)
    paged, dense = [o.token_ids for o in outs], [o.token_ids for o in outs_d]
    part = near_tie_partings(torch, "lm-gemma-dense-vs-paged", pipe, prompts,
                             [SamplingParams(max_new_tokens=GEN)] * len(prompts), paged,
                             dense, engine_kw=dict(max_len=LONG_LEN), first_token_ties=True)
    log(f"[lm-gemma] dense vs paged: {sum(a == b for a, b in zip(paged, dense))}/"
        f"{len(prompts)} streams token-identical, {len(part)} part, each at a near tie; "
        f"paged_attn launches over both runs {launches['paged_attn'] + launches_d['paged_attn']}")
    del pipe, pipe_d
    torch.cuda.empty_cache()
    return _add(dict(launches), launches_d)


def vlm_phase(torch, card):
    """[vlm]: llava-next-mistral-7b at int4, full width, 16 of its 32
    layers, dense (as in the reference); each request carries seeded
    random image embeddings (1, 576, 4096) ahead of 16-48 text tokens x
    32 new tokens. A second run repeats every stream, and the kernel
    bundle agrees with the torch bundle on live slots. Returns the
    launches of the measured run."""
    pipe = _lm_deploy(torch, "vlm", "llava-next-mistral-7b", False, LONG_LEN)
    cfg, dev = pipe.cfg, pipe.engine.device
    L = cfg.num_layers
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    prompts = [dict(p, img_embeds=0.02 * torch.randn((1, cfg.num_patches, cfg.d_model),
                                                     generator=g, device=dev))
               for p in _lm_prompts(np.random.default_rng(SEED + 22), cfg.vocab_size,
                                    16, 48)]
    expect = {"qmm": 7 * L, "qmm_naf": 0, "paged_attn": 0, "fasst_act": L}
    outs, launches = lm_serve(torch, card, "vlm", pipe, prompts, expect)
    from repro_torch.serving import SamplingParams
    again = pipe.generate(prompts, SamplingParams(max_new_tokens=GEN))
    if [o.token_ids for o in again] != [o.token_ids for o in outs]:
        raise AssertionError("[vlm] a second run changed a stream")
    err = routes_agree(torch, pipe, prompts, "vlm-routes")
    log(f"[vlm] {len(outs)} requests of {cfg.num_patches} image rows + 16-48 tokens: a "
        f"second run repeats every stream; kernels vs torch bundle {err:.4g}")
    del pipe
    torch.cuda.empty_cache()
    return launches


def repeat_run(tag, pipe, prompts, outs):
    """A second greedy run of the same engine on the same prompts must
    repeat every stream bit for bit: the MoE combine adds a token's rows
    by gathers in a fixed order, with no atomics."""
    from repro_torch.serving import SamplingParams
    again = pipe.generate(prompts, SamplingParams(max_new_tokens=GEN))
    if [o.token_ids for o in again] != [o.token_ids for o in outs]:
        raise AssertionError(f"[{tag}] a second run of the engine changed a stream")
    log(f"[{tag}] a second run of the engine repeats all {len(outs)} streams")


def time_paged_served(torch, tag, card, pipe, lens, timed):
    """The paged attention of one decode step at the served shape (one
    launch a layer, ``lens`` the cached lengths): kernel, plain, library
    and bound, as the kernels' [time] lines give them; kept in ``timed``
    under ``tag`` (the kernels' JSON line carries them as ``<tag>_...``
    keys of paged_attn)."""
    c = pipe.cfg
    g = torch.Generator(device=pipe.engine.device).manual_seed(SEED + 24)
    fns, (t, by), work = paged_window(torch, g, pipe.engine.device, c.num_heads,
                                      c.num_kv_heads, c.head_dim, MAX_LEN // PAGE,
                                      c.num_layers, lens)
    e = {**times(*fns), "bound_ms": t, "bound_by": by,
         "work": f"one {c.name} decode step: {work}"}
    log_time({"name": "paged_attn", **{f"{tag}_{k}": v for k, v in e.items()}}, card,
             f"{tag}_")
    timed[tag] = e
    del fns
    torch.cuda.empty_cache()


def dense_and_paged(torch, card, tag, pipe, pipe_d, prompts, expect, prefill_only=()):
    """Serve ``prompts`` on the paged engine and on the dense one (same
    weights): each run held as lm_serve holds it, the paged one repeated
    bit for bit, the kernel bundle against the torch bundle on live
    slots, and dense against paged up to near ties. Returns the summed
    launches of the two measured runs and the paged run's streams."""
    from repro_torch.serving import SamplingParams
    outs, launches = lm_serve(torch, card, tag, pipe, prompts, expect, prefill_only)
    repeat_run(tag, pipe, prompts, outs)
    routes_agree(torch, pipe, prompts, f"{tag}-routes")
    outs_d, launches_d = lm_serve(torch, card, f"{tag}-dense", pipe_d, prompts,
                                  dict(expect, paged_attn=0), prefill_only)
    repeat_run(f"{tag}-dense", pipe_d, prompts, outs_d)
    paged, dense = [o.token_ids for o in outs], [o.token_ids for o in outs_d]
    part = near_tie_partings(torch, f"{tag}-dense-vs-paged", pipe, prompts,
                             [SamplingParams(max_new_tokens=GEN)] * len(prompts), paged,
                             dense, first_token_ties=True)
    log(f"[{tag}-dense-vs-paged] {sum(a == b for a, b in zip(paged, dense))}/"
        f"{len(prompts)} streams token-identical, {len(part)} part, each at a near tie")
    return _add(dict(launches), launches_d), paged


def moe_phase(torch, card, timed, single):
    """[moe] / [moe-dense]: olmoe-1b-7b at int4, full width, 8 of its 16
    layers (64 experts x SiLU-GLU 1024, top-8, untied 50304 head), paged
    and dense on the same weights; 8 requests of 32-64 prompt tokens x 32
    new, greedy. A decode step launches qmm for the attention projections
    only (the experts are dequantize-then-einsum, as in the reference),
    the FASST kernel once a layer on the experts' 4-D (G, E, C, ff) gate
    products, and (paged) the paged-attention kernel once a layer. Keeps
    the prompts in ``single["moe-prompts"]`` ([tp-olmoe] serves them).
    Returns the launches of the measured runs."""
    from repro_torch.configs import get_config
    cut = f" (of {get_config('olmoe-1b-7b').num_layers}: the script's time limit)"
    pipe = _lm_deploy(torch, "moe", "olmoe-1b-7b", True, MAX_LEN, cut=cut)
    L = pipe.cfg.num_layers
    prompts = _lm_prompts(np.random.default_rng(SEED + 25), pipe.cfg.vocab_size, 32, 64)
    expect = {"qmm": 4 * L, "qmm_naf": 0, "paged_attn": L, "fasst_act": L}
    pipe_d = _lm_deploy(torch, "moe-dense", "olmoe-1b-7b", False, MAX_LEN, params=pipe.params,
                        cut=cut)
    launches, _ = dense_and_paged(torch, card, "moe", pipe, pipe_d, prompts, expect)
    single["moe-prompts"] = prompts
    lens = torch.tensor([p["tokens"].shape[1] + GEN for p in prompts], device=pipe.engine.device)
    del pipe_d
    time_paged_served(torch, "moe", card, pipe, lens, timed)
    del pipe
    torch.cuda.empty_cache()
    return launches


def moe_nllb_phase(torch, card, prompts, single):
    """[moe-nllb]: nllb600m-moe at int4, full width and depth (6 + 6
    layers, 16 experts x ReLU 8192, top-2; the paper's Fig. 3b), paged, on
    [serve]'s prompts. The encoder and the prefill dispatch with capacity
    per source row, the decode steps dropless. A decode step launches qmm
    for the self- and cross-attention projections (6 a layer), the FASST
    kernel once a layer on the experts' ReLU, and the paged-attention
    kernel once a layer; a second run repeats every stream. Keeps the
    streams in ``single["moe-nllb"]`` ([tp-moe] holds its ranks to them).
    Returns the launches of the measured run."""
    pipe = _lm_deploy(torch, "moe-nllb", "nllb600m-moe", True, MAX_LEN)
    L = pipe.cfg.num_layers
    expect = {"qmm": 6 * L, "qmm_naf": 0, "paged_attn": L, "fasst_act": L}
    outs, launches = lm_serve(torch, card, "moe-nllb", pipe, prompts, expect)
    single["moe-nllb"] = [o.token_ids for o in outs]
    repeat_run("moe-nllb", pipe, prompts, outs)
    routes_agree(torch, pipe, prompts, "moe-nllb-routes")
    del pipe
    torch.cuda.empty_cache()
    return launches


def _frame_prompts(torch, cfg, dev, n):
    """``n`` requests of enc_len seeded random frames (the stub conv
    frontend's output scale) and one prompt token each."""
    g = torch.Generator(device=dev).manual_seed(SEED + 26)
    rng = np.random.default_rng(SEED + 26)
    return [{"frames": 0.1 * torch.randn((1, cfg.enc_len, cfg.d_model), generator=g,
                                         device=dev),
             "tgt_in": rng.integers(0, cfg.vocab_size, (1, 1)).astype(np.int32)}
            for _ in range(n)]


def audio_phase(torch, card, timed, single):
    """[audio] / [audio-dense]: whisper-base at int4, full width and depth
    (6 + 6 layers, d 512, GELU FFNs, tied 51865 head), paged and dense on
    the same weights; 8 requests of 1500 random frames x 32 new tokens,
    greedy. Like [serve]: a decode step launches qmm 8 a layer, one of
    them with the GELU in its epilogue, no FASST kernel (the encoder's
    prefill rows launch it), and (paged) the paged-attention kernel once a
    layer. Keeps the paged streams in ``single["audio"]`` ([tp-audio]
    holds its ranks to them). Returns the launches of the measured
    runs."""
    pipe = _lm_deploy(torch, "audio", "whisper-base", True, MAX_LEN)
    L = pipe.cfg.num_layers
    prompts = _frame_prompts(torch, pipe.cfg, pipe.engine.device, SLOTS)
    expect = {"qmm": 8 * L, "qmm_naf": L, "paged_attn": L, "fasst_act": 0}
    pipe_d = _lm_deploy(torch, "audio-dense", "whisper-base", False, MAX_LEN,
                        params=pipe.params)
    launches, single["audio"] = dense_and_paged(torch, card, "audio", pipe, pipe_d, prompts,
                                                expect, prefill_only=("fasst_act",))
    if not launches["fasst_act"]:
        raise AssertionError("[audio] fasst_act: no launch on the encoder's prefill rows")
    lens = torch.full((SLOTS,), 1 + GEN, device=pipe.engine.device)
    del pipe_d
    time_paged_served(torch, "audio", card, pipe, lens, timed)
    del pipe
    torch.cuda.empty_cache()
    return launches


SSM_LEN, HYBRID_LEN = 576, 2560


def _prime_prompts(rng, vocab, lo, hi):
    """``_lm_prompts`` with the first prompt's length moved to the largest
    prime in [lo, hi] (the SSD's worst case: one-row chunks)."""
    prompts = _lm_prompts(rng, vocab, lo, hi)
    n = next(n for n in range(hi, lo - 1, -1) if all(n % d for d in range(2, int(n ** 0.5) + 1)))
    prompts[0] = {"tokens": rng.integers(0, vocab, (1, n)).astype(np.int32)}
    return prompts


def time_qmm_ssm(torch, card, dev):
    """qmm over one mamba2-780m decode step (48 layers x in_proj 1536x6448,
    out_proj 3072x1536, int4, M 8), each launch on its own weight as in
    the model: kernel, plain, library and bound, as the kernels' [time]
    lines give them; returns the ``ssm_`` keys of the qmm entry."""
    from repro_torch.core.qtensor import QTensor
    g = torch.Generator(device=dev).manual_seed(SEED + 27)
    ws = [QTensor.quantize(torch.randn(kn, generator=g, device=dev) * 0.02, "int4", 64)
          for _ in range(48) for kn in ((1536, 6448), (3072, 1536))]
    fns, (t, by) = qmm_window(torch, g, dev, ws, SLOTS)
    e = {**times(*fns, plain_reps=2), "bound_ms": t, "bound_by": by,
         "work": f"one mamba2-780m decode step: {len(ws)} int4 launches at M={SLOTS} "
                 "(in_proj 1536x6448, out_proj 3072x1536)"}
    log_time({"name": "qmm", **{f"ssm_{k}": v for k, v in e.items()}}, card, "ssm_")
    del ws, fns
    torch.cuda.empty_cache()
    return {f"ssm_{k}": v for k, v in e.items()}


def ssm_phase(torch, card, timed, single):
    """[ssm]: mamba2-780m whole (48 layers, d 1536, SSD state 128, 48
    heads of 64, chunk 128, tied 50280 head; 0.78 B parameters drawn and
    quantized on the card), int4, dense; 8 requests of 256-512 prompt
    tokens (one of prime length: one-row chunks) x 32 new, greedy. A
    decode step launches qmm twice a layer (in_proj, out_proj) and nothing
    else of the port's (the SiLUs are plain PyTorch, as in the
    reference). qmm is held at the in_proj's N 6448 (= 50 x 128 + 48, no
    multiple of 64) on the served weight at decode and prefill rows, and
    timed over one decode step (``timed["qmm"]``). Runs before the tp
    spawn and keeps its prompts and streams in ``single["ssm"]`` ([tp-ssm]
    holds its ranks to them). Returns the launches of the measured run."""
    pipe = _lm_deploy(torch, "ssm", "mamba2-780m", False, SSM_LEN)
    L, dev = pipe.cfg.num_layers, pipe.engine.device
    prompts = _prime_prompts(np.random.default_rng(SEED + 28), pipe.cfg.vocab_size,
                             256, 512)
    lens = [p["tokens"].shape[1] for p in prompts]
    w = pipe.params["layers"]["ssm"]["in_proj"].select(0)
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    errs = [qmm_agree(torch, torch.randn((m, w.shape[-2]), generator=g, device=dev), w,
                      "[ssm] in_proj")[0] for m in (SLOTS, lens[0])]
    log(f"[ssm] qmm at the served in_proj (K {w.shape[-2]}, N {w.shape[-1]}) agrees with "
        f"qmm_plain at M {SLOTS} and M {lens[0]}, f32 and bf16 out, each launched twice and "
        f"bit-identical; max abs err (f32 out) {max(errs):.3g}; prompt lengths {lens}")
    expect = {"qmm": 2 * L, "qmm_naf": 0, "paged_attn": 0, "fasst_act": 0}
    outs, launches = lm_serve(torch, card, "ssm", pipe, prompts, expect)
    single["ssm"] = {"prompts": prompts, "streams": [o.token_ids for o in outs]}
    repeat_run("ssm", pipe, prompts, outs)
    routes_agree(torch, pipe, prompts, "ssm-routes")
    del pipe
    torch.cuda.empty_cache()
    timed["qmm"] = time_qmm_ssm(torch, card, dev)
    return launches


def hybrid_phase(torch, card):
    """[hybrid]: recurrentgemma-9b whole (12 super-blocks of (RG-LRU,
    RG-LRU, local attention) and a 2-layer RG-LRU tail, d 4096, MQA 16/1
    heads of 256, window 2048, GELU-GLU 12288, tied 256000 head; 9.40 B
    parameters, the 2.18 B of the RG-LRU kept bf16 as the policy exempts
    them), int4, dense (bf16 rolling KV whatever the spec says, as in the
    reference), max_len 2560; 8 requests of 2100-2400 prompt tokens x 32
    new, greedy: the rolling buffer wraps in prefill and again in decode.
    A decode step launches qmm 3 a recurrent layer (the MLP) and 7 an
    attention layer (q, k, v, o and the MLP), the FASST kernel twice a
    recurrent layer (the RG-LRU's output gate, the MLP's GELU) and once an
    attention layer. Returns the launches of the measured run."""
    from repro_torch.models.hybrid import hybrid_layout
    pipe = _lm_deploy(torch, "hybrid", "recurrentgemma-9b", False, HYBRID_LEN)
    n_super, tail = hybrid_layout(pipe.cfg)
    rec = 2 * n_super + tail
    prompts = _lm_prompts(np.random.default_rng(SEED + 30), pipe.cfg.vocab_size, 2100, 2400)
    log(f"[hybrid] {n_super} super-blocks + {tail} tail layers ({rec} RG-LRU, {n_super} "
        f"attention); prompts of {sorted(p['tokens'].shape[1] for p in prompts)} tokens "
        f"against a rolling buffer of {pipe.engine.cache['b_k'].shape[2]} rows")
    expect = {"qmm": 3 * rec + 7 * n_super, "qmm_naf": 0, "paged_attn": 0,
              "fasst_act": 2 * rec + n_super}
    outs, launches = lm_serve(torch, card, "hybrid", pipe, prompts, expect)
    repeat_run("hybrid", pipe, prompts, outs)
    routes_agree(torch, pipe, prompts, "hybrid-routes")
    del pipe
    torch.cuda.empty_cache()
    return launches


LM_PHASES = (("lm", lm_phase), ("lm-gemma", lm_gemma_phase), ("vlm", vlm_phase))


# ---------------------------------------------------------------------------
# scale-out: tensor-parallel ranks, the compressed all-reduce, replicas
# ---------------------------------------------------------------------------

TP = 2
# [tp-lm] / [tp-lm-dense]: gemma3-1b cut to 13 of its 26 layers (two of its
# 5 local : 1 global groups and a local layer; whole until [tp-ssm] and
# [tp-hybrid] needed the script's time)
TP_GEMMA_LAYERS = 13
# [tp-qwen]: qwen2.5-14b cut to 4 of its 48 layers (8 GB f32 a rank); 8 until
# [tp-ssm] and [tp-hybrid] needed the script's time
TP_QWEN_LAYERS = 4
# [tp-olmoe]: olmoe-1b-7b cut to 4 of its 16 layers for the script's time
# limit ([moe] serves 8: with [tp-olmoe] at 8 too the script ran 1048.0 s
# of its 1200 on an "NVIDIA H100 80GB HBM3, 700.00 W" host)
TP_OLMOE_LAYERS = 4
# [tp-hybrid]: recurrentgemma-9b cut to 5 of its 38 layers: one (RG-LRU,
# RG-LRU, local attention) super-block and the 2-layer RG-LRU tail
TP_HYBRID_LAYERS = 5
# [tp-ssm] / [tp-hybrid]: the (largest, mean) logit difference a
# teacher-forced step of a rank may show against one device. On an H100 a
# sound rank gave (0.314, 0.048) and (0.25, 0.0102) over 32 steps, a rank
# with a planted fault (the norm over its own columns; the gates from its
# own channels) (3.81, 0.476) and (0.879, 0.131); the bits repeat from run
# to run. The routes' 0.3 does not fit 48 recurrent layers in bf16.
TP_RECURRENT_LOGIT_TOL = {"tp-ssm": (1.0, 0.15), "tp-hybrid": (0.5, 0.04)}
COMPRESS_SHAPES = {"w_in": (1024, 8192), "wo": (1024, 1024), "bias": (1000,)}


def compress_check(torch, rank, device):
    """[compress]: ``compressed_psum`` of this rank's seeded gradient tree
    (a full-width FFN-in and attention-out gradient, a ragged bias and a
    None leaf) on the card, over the ranks' gloo group, byte-equal to the
    same call on CPU tensors; its error against the plain f32 sum; its
    time on the card."""
    import torch.distributed as dist
    from repro_torch.optim import compressed_psum
    g = torch.Generator().manual_seed(SEED + 31 + rank)
    tree = {k: torch.randn(shape, generator=g) * 10 ** (-i)
            for i, (k, shape) in enumerate(COMPRESS_SHAPES.items())}
    tree["none"] = None
    cpu = compressed_psum(tree)
    dev_tree = {k: None if v is None else v.to(device) for k, v in tree.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = compressed_psum(dev_tree)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    worst = 0.0
    for k, v in tree.items():
        if v is None:
            if got[k] is not None:
                raise AssertionError(f"[compress] the None leaf {k} came back")
            continue
        if not torch.equal(got[k].cpu().view(torch.int32), cpu[k].view(torch.int32)):
            raise AssertionError(f"[compress] {k}: the card's sum is not the CPU's, "
                                 "byte for byte")
        plain = v.to(device).clone()
        dist.all_reduce(plain)
        worst = max(worst, float((got[k] - plain).abs().max() / plain.abs().max()))
    if not worst < 0.02:
        raise AssertionError(f"[compress] relative error {worst:.3g} against the f32 sum")
    n = sum(v.numel() for v in tree.values() if v is not None)
    return {"values": n, "ms": ms, "max_rel_err_vs_f32_sum": worst,
            "byte_equal_to_cpu": True}


def engine_memory(torch, device, build):
    """``build()``'s device memory on this process: what stays allocated
    after it (the engine's weights, KV storage and buffers) and its peak
    above what was allocated before it. Returns those bytes and what
    ``build`` returned under ``built``."""
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    built = build()
    torch.cuda.synchronize(device)
    return {"resident": torch.cuda.memory_allocated(device) - before,
            "build_peak": torch.cuda.max_memory_allocated(device) - before,
            "built": built}


def _mem_line(mem):
    return (f"resident {mem['resident'] / 1e9:.3f} GB after the deploy, peak "
            f"{mem['build_peak'] / 1e9:.3f} GB during it (above the raw weights)")


def _group_gather(grp, obj):
    """``obj`` of every rank of the tensor-parallel group ``grp`` (a
    ``parallel.tp.TPGroup``), in group rank order."""
    import torch.distributed as dist
    every = [None] * grp.size
    dist.all_gather_object(every, obj, group=grp.group)
    return every


def _group_bcast(grp, obj):
    """``obj`` of the group's rank 0, on every rank of the group."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(grp.group, 0), group=grp.group)
    return box[0]


def counted_decode(eng):
    """Count the wrapper launches made inside ``eng``'s decode loop (the
    run's decode steps alone: its prefills launch at other shapes and
    counts) and, on a tensor-parallel rank, its collectives: every sum
    and max of its group (``collectives`` and the buffers' bytes) and,
    among them, the experts' gathers along E (``expert_gathers`` and
    bytes) and the maxes (``maxes``: a dynamic activation scale's over
    the ranks, a sequence-split cache's score max and x<fmt> PV scale).
    Returns the counts, filled as the engine runs; end_count(eng) ends
    the count."""
    from repro_torch.kernels import ops
    in_decode, real_loop = dict.fromkeys(ops.LAUNCHES, 0), eng._decode_loop
    sums = dict.fromkeys(("collectives", "collective_bytes", "expert_gathers",
                          "expert_gather_bytes", "maxes"), 0)
    grp = eng.ctx.tp
    if grp is not None:
        real_sum, real_max, real_gather = grp._sum, grp._max, grp.gather

        def counted_sum(y):
            sums["collectives"] += 1
            sums["collective_bytes"] += y.numel() * y.element_size()
            return real_sum(y)

        def counted_max(y):
            sums["collectives"] += 1
            sums["maxes"] += 1
            sums["collective_bytes"] += y.numel() * y.element_size()
            return real_max(y)

        def counted_gather(x, dim):
            if dim == 1:                # an MoE layer's experts, along E
                sums["expert_gathers"] += 1
                sums["expert_gather_bytes"] += x.numel() * grp.size * 4
            return real_gather(x, dim)

        grp._sum, grp._max, grp.gather = counted_sum, counted_max, counted_gather
        in_decode.update(sums)

    def counted_loop(*a, **kw):
        before, sums0 = dict(ops.LAUNCHES), dict(sums)
        got = real_loop(*a, **kw)
        for k, v in ops.LAUNCHES.items():
            in_decode[k] += v - before[k]
        if grp is not None:
            for k, v in sums.items():
                in_decode[k] += v - sums0[k]
        return got

    eng._decode_loop = counted_loop
    return in_decode


def end_count(eng):
    """Undo counted_decode's wrappers."""
    del eng._decode_loop
    if eng.ctx.tp is not None:
        del eng.ctx.tp._sum, eng.ctx.tp._max, eng.ctx.tp.gather


def tp_vs_single(torch, tag, grp, pipe, prompts, sp, streams, single, engine_kw=None,
                 logit_tol=None):
    """Hold a tensor-parallel engine's greedy ``streams`` against one
    device's, on every rank of the engine's group: group rank 0 takes the
    single device's streams from ``single["streams"]``, or serves them on
    the pipe ``single["build"]()`` deploys; where they part, the common
    prefix is replayed teacher-forced on both sides, a fresh engine of
    the tensor-parallel pipe (every rank of the group) against a fresh
    single-device one (group rank 0, built then if it was not), and the
    parting must be a near tie (near_tie_partings). With ``logit_tol``
    (largest, mean) every step of the streams is replayed, parted or not,
    and holds the sides' logits to it. Returns (partings, the single
    device's deploy memory or None, its streams on group rank 0)."""
    lead = grp.rank == 0
    n, part, smem, spipe, want = len(prompts), {}, None, None, None
    kw = engine_kw or {}

    def build():
        mem = engine_memory(torch, pipe.engine.device, single["build"])
        log(f"[{tag}] the single-device engine: {_mem_line(mem)}")
        return mem.pop("built"), mem

    if lead:
        want = single.get("streams")
        if want is None:
            spipe, smem = build()
            want = [o.token_ids for o in spipe.generate(prompts, sp)]
        part = _partings(tag, streams, want, first_token_ties=True)
    every = GEN - 1 if logit_tol is not None else 0
    steps = _group_bcast(grp, max(list(part.values()) + [3, every])
                         if part or every else 0)
    if steps:
        side = [(_fresh_engine(pipe, pipe.engine.paged, **kw), list(range(n)))]
        if lead:
            if spipe is None:
                spipe, smem = build()
            near_tie_partings(torch, tag, pipe, prompts, [sp] * n, streams, want,
                              first_token_ties=True,
                              sides=[side, [(_fresh_engine(spipe, pipe.engine.paged, **kw),
                                             list(range(n)))]],
                              logit_tol=logit_tol, steps=every)
        else:
            tp_follow_replay(torch, [side], prompts, [sp] * n, streams, steps)
    del spipe
    torch.cuda.empty_cache()
    return part, smem, want


def _experts_held(tree):
    """The experts an MoE tree's stacks hold (their E dim), or None."""
    if not isinstance(tree, dict):
        return None
    if "experts" in tree:
        return next(iter(tree["experts"].values())).shape[-3]
    return next((e for e in map(_experts_held, tree.values()) if e is not None), None)


def _mixer_held(pipe) -> str:
    """What a recurrent rank's shard holds of its mixers, or ""."""
    c, p = pipe.cfg, pipe.params
    if c.family == "ssm":
        ssm = p["layers"]["ssm"]
        return (f", {ssm['a_log'].shape[-1]} of {c.ssm.expand * c.d_model // c.ssm.head_dim} "
                f"SSD heads (in_proj N {ssm['in_proj'].shape[-1]}, conv channels "
                f"{ssm['conv_w'].shape[-1]})")
    if c.family == "hybrid":
        w = p["blocks"]["r1"]["rglru"]["w_rg"]
        return f", RG-LRU {w.shape[-1]} of {c.d_rec} channels (w_rg {tuple(w.shape[-2:])})"
    return ""


def _layout(eng) -> str:
    """What a rank replicates (``RankConfig.replicated``) and the rows of
    its dense self-attention cache (the sequence split), for the deploy
    line."""
    lc, c = eng.model.cfg, eng.cache
    k = None if "block_tables" in c else next((c[n] for n in ("k_codes", "k", "b_k")
                                               if n in c), None)
    rows = "" if k is None else f", {k.shape[2]} of {eng.max_len} KV rows"
    return f"; replicated: {', '.join(lc.replicated) or 'none'}{rows}"


def tp_serve(torch, tag, card, pipe, mem, prompts, per_step, single, need, engine_kw=None,
             collectives=None, logit_tol=None, whole=False):
    """One tensor-parallel engine's served run, called alike on every rank
    of its mesh; rank 0 prints. The measured greedy run (no warm-up run
    before it: the phases before the spawn compiled every kernel) with
    the launch counters set to 0 just before and read just after, and
    rank 0 holding ``need``'s kernels at the shapes it gave them
    (hold_served); every rank's streams and launches equal; a decode step
    launching exactly ``per_step`` (and summing exactly ``collectives``
    times over the ranks, when given) and, where ``need`` names it, the
    prefills the FASST kernel; the streams against one device's up to
    near ties (tp_vs_single; with ``logit_tol``, every step's logits held
    to it teacher-forced). A rank must hold fewer weight bytes than
    the whole quantized tree, or, ``whole`` (every sublayer replicated),
    exactly its bytes. Rank 0 prints one line per rank: tokens/s, decode
    ms a step, the collectives a step (and the experts' gathers among
    them), its weights against the whole tree's, its KV bytes and its
    resident memory against the deploy's peak. Returns the launches,
    streams, numbers and, on rank 0, the single device's streams."""
    import torch.distributed as dist
    from repro_torch.core import tree_nbytes
    from repro_torch.kernels import ops
    from repro_torch.serving import SamplingParams
    t_phase = time.perf_counter()
    eng = pipe.engine
    grp, lc = eng.ctx.tp, eng.model.cfg
    lead = grp.rank == 0
    say = log if lead else (lambda *a: None)
    held = _experts_held(pipe.params)
    experts = ("" if held is None else f", {held} of {lc.moe.num_experts} experts") \
        + _mixer_held(pipe)
    kv = {"ssm": "recurrent state", "hybrid": "bf16 rolling KV"}.get(lc.family,
                                                                   f"{eng.kv_dtype} KV")
    say(f"[{tag}] deployed {pipe.cfg.name} {pipe.spec_str}, {pipe.cfg.num_layers} layers, on "
        f"tp{grp.size} ({'paged' if eng.paged else 'dense'} {kv}): each rank "
        f"{lc.num_heads}/{lc.num_kv_heads} heads of {lc.head_dim}, d_ff {lc.d_ff}{experts}, "
        f"vocab slice {pipe.params['embedding'].shape[0]} of {lc.vocab_size}, "
        f"{tree_nbytes(pipe.params) / 1e9:.3f} GB of weights (of "
        f"{pipe.quantized_bytes / 1e9:.3f} GB){_layout(eng)}; {_mem_line(mem)}")
    n = len(prompts)
    sp = SamplingParams(max_new_tokens=GEN)
    eng.reset_metrics()
    torch.cuda.synchronize()
    dist.barrier(group=grp.group)
    in_decode = counted_decode(eng)
    steps0 = eng.decode_steps
    ops.reset_launches()
    t0 = time.perf_counter()
    with served_shapes() as seen:
        outs = pipe.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    end_count(eng)
    if lead:
        hold_served(torch, tag, seen, eng.device, need)
    streams = [o.token_ids for o in outs]
    if any(o.finish_reason != "length" or len(o.token_ids) != GEN for o in outs):
        raise AssertionError(f"[{tag}] not every request retired on length")
    _check_vocab(pipe, outs)
    if eng.paged:
        eng.allocator.check()
        if eng.allocator.pages_in_use:
            raise AssertionError(f"[{tag}] {eng.allocator.pages_in_use} pages leaked")
    every = _group_gather(grp, (streams, launches))
    if any(s != streams for s, _ in every):
        raise AssertionError(f"[{tag}] the ranks' streams differ")
    steps_run = eng.decode_steps - steps0
    if not steps_run or any(in_decode[k] != c * steps_run for k, c in per_step.items()):
        raise AssertionError(f"[{tag}] {steps_run} decode steps launched {in_decode}; "
                             f"a step launches {per_step}")
    if collectives is not None and in_decode["collectives"] != collectives * steps_run:
        raise AssertionError(f"[{tag}] {steps_run} decode steps summed "
                             f"{in_decode['collectives']} times over the ranks; a step sums "
                             f"{collectives} times")
    if "fasst_act" in need and not launches["fasst_act"] > in_decode["fasst_act"]:
        raise AssertionError(f"[{tag}] the prefills launched no FASST kernel: {launches}")
    part, smem, want = tp_vs_single(torch, tag, grp, pipe, prompts, sp, streams, single,
                                    engine_kw, logit_tol)
    tokens = sum(len(t) for t in streams)
    weights = tree_nbytes(pipe.params)
    if not (weights == pipe.quantized_bytes if whole else weights < pipe.quantized_bytes):
        raise AssertionError(f"[{tag}] rank {grp.rank} holds {weights} weight bytes, "
                             f"{'not' if whole else 'not under'} the whole tree's "
                             f"{pipe.quantized_bytes}")
    mine = {"rank": grp.rank, "tokens_per_s": tokens / wall,
            "decode_ms_per_step": 1e3 * eng.decode_s / max(eng.decode_steps, 1),
            **{f"{k}_per_step": in_decode[k] / steps_run
               for k in ("collectives", "collective_bytes", "expert_gathers",
                         "expert_gather_bytes", "maxes")},
            "weights_gb": weights / 1e9, "whole_weights_gb": pipe.quantized_bytes / 1e9,
            "kv_gb": eng.kv_cache_bytes / 1e9,
            "resident_gb": mem["resident"] / 1e9, "deploy_peak_gb": mem["build_peak"] / 1e9}
    per_rank = _group_gather(grp, mine)
    for m in per_rank:
        say(f"[{tag}] rank {m['rank']} of {grp.size}: {json.dumps(m)}")
    stats = {"arch": pipe.cfg.name, "layers": pipe.cfg.num_layers, "requests": n,
             "tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall, "decode_steps": eng.decode_steps,
             "decode_ms_per_step": 1e3 * eng.decode_s / max(eng.decode_steps, 1),
             "prefill_ms_per_call": 1e3 * eng.prefill_s / max(eng.prefill_calls, 1),
             "launches_per_step": per_step,
             "same_as_single_device": n - len(part), "near_tie_partings": len(part),
             "launches_per_rank": [c for _, c in every], "per_rank": per_rank,
             "rank_memory_gb": {k: v / 1e9 for k, v in mem.items()},
             **({"single_device_memory_gb": {k: v / 1e9 for k, v in smem.items()}}
                if smem else {}),
             "note": f"{grp.size} ranks share one card over {grp.backend}", "card": card}
    say(f"[{tag}] {json.dumps(stats)}")
    say(f"[{tag}] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "streams": streams, "stats": stats, "single_streams": want}


TP_SLA_TTFT_MS = 1e-3      # [tp-sla]'s target: every window of 2 breaches it
CLOCK_AHEAD_S = 3600.0     # rank 1's clock in [tp-faults]'s second run


class _AheadClock:
    """The ``time`` module as the engine module reads it, ``perf_counter``
    ``ahead_s`` ahead."""

    def __init__(self, ahead_s: float):
        self.ahead_s = ahead_s

    def perf_counter(self) -> float:
        return time.perf_counter() + self.ahead_s


@contextlib.contextmanager
def _clock_ahead(on: bool, ahead_s: float):
    """Inside, the engine module's clock runs ``ahead_s`` ahead where
    ``on``."""
    from repro_torch.serving import engine as engine_mod
    real = engine_mod.time
    if on:
        engine_mod.time = _AheadClock(ahead_s)
    try:
        yield
    finally:
        engine_mod.time = real


def _launched_every(tag, launches):
    """Raise unless the run launched every kernel of the paged nllb600m
    path."""
    idle = [k for k in ("qmm", "qmm_naf", "paged_attn", "fasst_act") if not launches[k]]
    if idle:
        raise AssertionError(f"[{tag}] the run launched no {idle}: {launches}")


def channel_count(eng):
    """Count ``eng``'s control-channel broadcasts and their host time
    (the whole channel step: pack, broadcast, apply) from now on; the
    wrapper goes with ``del eng._rank0_decides``."""
    n = {"broadcasts": 0, "channel_s": 0.0}
    real = eng._rank0_decides

    def timed(deadlined):
        t0 = time.perf_counter()
        got = real(deadlined)
        n["channel_s"] += time.perf_counter() - t0
        n["broadcasts"] += 1
        return got

    eng._rank0_decides = timed
    return n


def channel_bench(torch, grp, n_flags: int, n_obs: int, reps: int = 200):
    """Host ms of one channel message (3 + n_flags + 2 n_obs f64) through
    the engine's tensor broadcast and through broadcast_object_list of
    the same values as a Python list, ``reps`` each, on every rank of the
    group alike."""
    import torch.distributed as dist
    msg = torch.zeros(3 + n_flags + 2 * n_obs, dtype=torch.float64)
    src = dist.get_global_rank(grp.group, 0)
    out = {}
    for name, fn in (("tensor", lambda: grp.broadcast(msg)),
                     ("object", lambda: dist.broadcast_object_list(
                         [msg.tolist()], src=src, group=grp.group))):
        dist.barrier(group=grp.group)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def tp_faults_phase(torch, card, pipe, prompts, tp_stats):
    """[tp-faults]: [faults]'s plan and constants on a fresh engine of
    [tp]'s pipe, called alike on both ranks: reasons, events and counters
    equal on both ranks and [faults]'s, survivors [tp]'s streams (a
    resumed one may part only at a near tie of its replay), casualties
    prefixes, the pool clean after release_all, one channel broadcast a
    round boundary and [tp]'s collectives a decode step (``tp_stats``:
    [tp]'s streams and numbers). Then the same
    run with rank 1's clock CLOCK_AHEAD_S ahead from after the submits
    (past every DEADLINE_MS budget): every rank's outputs and counters
    are the first run's, rank 0's expiries. Returns the first run's
    launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineSaturated, FaultPlan, SamplingParams, TraceConfig
    t_phase = time.perf_counter()
    grp = pipe.ctx.tp
    say = log if grp.rank == 0 else (lambda *a: None)
    sp = SamplingParams(max_new_tokens=GEN)
    dl = SamplingParams(max_new_tokens=GEN, deadline_ms=DEADLINE_MS)
    per_step = tp_stats["stats"]["per_rank"][grp.rank]["collectives_per_step"]
    runs = []
    for ahead in (False, True):
        plan = FaultPlan(exhaust_at=[(1, SLOTS * pipe.engine.max_pages, 4)],
                         nan_at=[(0, FAULT_NAN_SLOT, 5)], skew_at=[(1, SKEW_MS)])
        eng = _fresh_engine(pipe, True, faults=plan, max_pending=len(prompts),
                            preempt_limit=16, trace=TraceConfig())
        in_decode = counted_decode(eng)
        chan = channel_count(eng)
        steps0 = eng.decode_steps
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        ids = [eng.submit(p, dl if i in FAULT_DEADLINED else sp)
               for i, p in enumerate(prompts)]
        try:
            eng.submit(prompts[0], sp)
        except EngineSaturated as e:
            if (e.pending, e.limit) != (len(prompts), len(prompts)):
                raise AssertionError(f"[tp-faults] EngineSaturated({e.pending}, "
                                     f"{e.limit})") from e
        else:
            raise AssertionError("[tp-faults] a submit past max_pending was queued")
        with _clock_ahead(ahead and grp.rank == 1, CLOCK_AHEAD_S):
            by_id = {o.request_id: o for o in eng.stream()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        end_count(eng)
        del eng._rank0_decides
        _launched_every("tp-faults", launches)
        outs = [by_id[i] for i in ids]
        m = eng.metrics()
        facts = {"reasons": [o.finish_reason for o in outs],
                 "streams": [o.token_ids for o in outs], "events": list(plan.events),
                 "counters": (m.slot_errors, m.deadline_expirations, m.admission_rejections,
                              m.preemptions, m.resumed_requests)}
        every = _group_gather(grp, facts)
        if any(f != facts for f in every):
            raise AssertionError(f"[tp-faults] the ranks differ{' (rank 1 ahead)' * ahead}: "
                                 f"{[f['reasons'] for f in every]}, "
                                 f"{[f['counters'] for f in every]}")
        want = ["error" if i == FAULT_NAN_SLOT else "deadline" if i in FAULT_DEADLINED
                else "length" for i in range(len(prompts))]
        if facts["reasons"] != want or facts["counters"][:3] != (1, 2, 1) \
                or not facts["counters"][3] or not {"exhaust", "nan", "skew"} <= {
                    e[0] for e in plan.events}:
            raise AssertionError(f"[tp-faults] reasons {facts['reasons']} (expected {want}), "
                                 f"counters {facts['counters']}, events {plan.events}")
        steps_run = eng.decode_steps - steps0
        if chan["broadcasts"] != eng._boundaries \
                or in_decode["collectives"] != per_step * steps_run:
            raise AssertionError(f"[tp-faults] {chan['broadcasts']} channel broadcasts in "
                                 f"{eng._boundaries} rounds; {in_decode['collectives']} "
                                 f"collectives in {steps_run} decode steps ([tp]'s "
                                 f"{per_step} a step)")
        plan.release_all(eng)
        eng.allocator.check()
        if eng.allocator.pages_in_use:
            raise AssertionError(f"[tp-faults] {eng.allocator.pages_in_use} pages in use "
                                 "after release_all")
        runs.append((facts, eng, outs, wall, launches, chan))
    (facts, eng, outs, wall, launches, chan), ahead_run = runs
    if ahead_run[0] != facts:
        raise AssertionError("[tp-faults] with rank 1's clock ahead the ranks served "
                             f"{ahead_run[0]['reasons']} / {ahead_run[0]['counters']}, not "
                             f"{facts['reasons']} / {facts['counters']}")
    ref = tp_stats["streams"]
    part = replay_partings(torch, "tp-faults", pipe, prompts, ref, facts["streams"],
                           _resumes(eng.trace))
    tokens = sum(len(t) for t in facts["streams"])
    say("[tp-faults] " + json.dumps({
        "reasons": facts["reasons"], "tokens": [len(t) for t in facts["streams"]],
        "events": [list(e) for e in facts["events"]],
        "slot_errors_deadline_expirations_admission_rejections_preemptions_resumed":
            facts["counters"],
        "survivors_same_as_tp": sum(o.token_ids == r for o, r in zip(outs, ref)
                                    if o.finish_reason == "length"),
        "casualty_prefixes": sum(o.token_ids == r[:len(o.token_ids)] for o, r in zip(outs, ref)
                                 if o.finish_reason != "length"),
        "near_tie_partings": len(part), "rank1_clock_ahead_s": CLOCK_AHEAD_S,
        "rank1_ahead_same_outputs": True, "tokens_per_s": tokens / wall,
        "tp_tokens_per_s": tp_stats["stats"]["tokens_per_s"],
        "rounds": [r[1]._boundaries for r in runs],
        "channel_broadcasts": [r[5]["broadcasts"] for r in runs],
        "channel_ms_per_round": [1e3 * r[5]["channel_s"] / r[1]._boundaries for r in runs],
        "collectives_per_step": per_step, "wall_s": [r[3] for r in runs],
        "launches": launches,
        "card": card}))
    say(f"[tp-faults] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def tp_sla_phase(torch, card, pipe, prompts, tp_stats):
    """[tp-sla]: [serve]'s prompts on a fresh engine of [tp]'s pipe under
    a p95 TTFT target of TP_SLA_TTFT_MS with a window of 2, so every
    window halves the horizon and the prefill cap; the budgets step down
    from GEN by 4 a request, so retirements (and retunes) spread over the
    rounds. Every rank's (horizon, prefill cap, retunes, windows) equal
    after every round, the horizon down to 1, each stream the prefix of
    [tp]'s (every request is admitted in [tp]'s one prefill group, and
    a decode step's rows do not depend on the horizon), one channel
    broadcast a round and [tp]'s collectives a decode step. Then the
    channel's message timed through the tensor broadcast and through
    broadcast_object_list. Returns the launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving import SamplingParams, SLATarget
    t_phase = time.perf_counter()
    grp = pipe.ctx.tp
    say = log if grp.rank == 0 else (lambda *a: None)
    eng = _fresh_engine(pipe, True, sla=SLATarget(p95_ttft_ms=TP_SLA_TTFT_MS, window=2))
    ctl = eng.sla
    trail = []
    in_decode = counted_decode(eng)
    chan = channel_count(eng)
    steps0 = eng.decode_steps
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, SamplingParams(max_new_tokens=GEN - 4 * i))
           for i, p in enumerate(prompts)]
    by_id = {o.request_id: o for o in eng.stream(on_round=lambda: trail.append(
        (ctl.horizon, ctl.prefill_cap, ctl.retunes, ctl.windows)))}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    end_count(eng)
    del eng._rank0_decides
    _launched_every("tp-sla", launches)
    trail.append((ctl.horizon, ctl.prefill_cap, ctl.retunes, ctl.windows))
    streams = [by_id[i].token_ids for i in ids]
    every = _group_gather(grp, (trail, streams))
    if any(e != (trail, streams) for e in every):
        raise AssertionError("[tp-sla] the ranks' controllers or streams differ")
    ref = tp_stats["streams"]
    bad = [i for i, (s, r) in enumerate(zip(streams, ref))
           if s != r[:len(s)] or len(s) != GEN - 4 * i]
    if bad or trail[-1][0] != 1 or trail[-1][3] != len(prompts) // 2:
        raise AssertionError(f"[tp-sla] requests {bad} are not prefixes of [tp]'s streams; "
                             f"controller {trail[-1]}")
    steps_run = eng.decode_steps - steps0
    per_step = tp_stats["stats"]["per_rank"][grp.rank]["collectives_per_step"]
    if chan["broadcasts"] != eng._boundaries or in_decode["collectives"] != per_step * steps_run:
        raise AssertionError(f"[tp-sla] {chan['broadcasts']} channel broadcasts in "
                             f"{eng._boundaries} rounds; {in_decode['collectives']} "
                             f"collectives in {steps_run} decode steps ([tp]'s {per_step} a "
                             "step)")
    bench = channel_bench(torch, grp, 0, 2)
    tokens = sum(len(t) for t in streams)
    say("[tp-sla] " + json.dumps({
        "target_p95_ttft_ms": TP_SLA_TTFT_MS, "window": 2,
        "trajectory_horizon_cap_retunes_windows": sorted(set(trail), key=trail.index),
        "rounds": eng._boundaries, "prefixes_of_tp": len(streams) - len(bad),
        "tokens": tokens, "tokens_per_s": tokens / wall,
        "tp_tokens_per_s": tp_stats["stats"]["tokens_per_s"],
        "channel_broadcasts": chan["broadcasts"],
        "channel_ms_per_round": 1e3 * chan["channel_s"] / eng._boundaries,
        "broadcast_ms_tensor_vs_object": [bench["tensor"], bench["object"]],
        "collectives_per_step": per_step, "decode_steps": steps_run, "wall_s": wall,
        "launches": launches, "card": card}))
    say(f"[tp-sla] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def tp_rank(rank, world, device, prompts, lm):
    """[tp], [tp-faults], [tp-sla], [tp-dense], [compress], [tp-lm],
    [tp-lm-dense], [tp-qwen], [tp-moe], [tp-olmoe], [tp-audio], [tp-ssm],
    [tp-hybrid], [tp-quant-*] and [tp-spec] on one of
    ``world`` ranks that
    share the one card over gloo (launch_ranks), each engine a
    deploy(mesh=tp_mesh(world)) served by tp_serve: full-width nllb600m
    int4, paged (page 16) then dense, horizon 16, [serve]'s prompts, the
    paged engine's pipe serving [tp-faults] and [tp-sla] on fresh engines
    before it is freed;
    gemma3-1b cut to TP_GEMMA_LAYERS (one KV head, a copy on each rank),
    paged then dense, against one device's engine of the cut,
    on [lm-gemma]'s prompts past its 512-token windows; qwen2.5-14b at
    full width cut to ``lm["qwen_layers"]`` of its 48 layers, paged, on
    [lm]'s prompts, against the single device's streams that the parent
    served before the spawn (the ranks draw and quantize the whole cut
    one after the other); then, paged, nllb600m-moe whole on [serve]'s
    prompts and whisper-base whole on [audio]'s frames, against the
    streams [moe-nllb] and [audio] served before the spawn, and
    olmoe-1b-7b cut to TP_OLMOE_LAYERS on [moe]'s prompts, against one
    device's engine of that cut (tp_family_phases); then the SSM and
    hybrid meshes (tp_recurrent_phases), then the quantization arms and
    the draft arm under the mesh (tp_quant_phases). Returns each phase's
    launches and numbers."""
    import torch
    import torch.distributed as dist
    from repro_torch.cluster import tp_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import Ctx, build_model
    from repro_torch.serving import deploy
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lead = rank == 0
    say = log if lead else (lambda *a: None)
    mesh = tp_mesh(world)
    say(f"[tp] {world} ranks on {device} of one {torch.cuda.get_device_name(device)}, "
        f"{mesh!r}: the ranks share the card, so a rank's times include the other's work")
    out = {"compress": compress_check(torch, rank, device)}
    say(f"[compress] {json.dumps(out['compress'])}")
    ctx = Ctx(compute_dtype=torch.bfloat16, use_fasst_kernel=True)

    def paging(paged):
        return dict(paged=True, page_size=PAGE) if paged else {}

    # [tp] / [tp-dense]: a decode step launches 8 qmm a layer (q, k, v, o,
    # cross q, cross o, FFN in with the activation in its epilogue, FFN
    # out), one paged attention a layer on a paged cache, no FASST launch
    # of its own; the prefills take the FASST kernel at their rows
    raw = build_model(get_config("nllb600m"), device).init(
        torch.Generator(device=device).manual_seed(SEED))
    for tag, paged in (("tp", True), ("tp-dense", False)):
        kw = dict(slots=SLOTS, max_len=MAX_LEN, horizon=HORIZON, params=raw, device=device,
                  ctx=ctx, **paging(paged))
        mem = engine_memory(torch, device, lambda: deploy("nllb600m", "int4", mesh=mesh, **kw))
        pipe = mem.pop("built")
        L = pipe.cfg.num_layers
        out[tag] = tp_serve(
            torch, tag, lm["card"], pipe, mem, prompts,
            {"qmm": 8 * L, "qmm_naf": L, "paged_attn": L if paged else 0, "fasst_act": 0},
            {"build": lambda: deploy("nllb600m", "int4", **kw)},
            ("qmm", "fasst_act") + (("paged_attn",) if paged else ()))
        if paged:
            # the clock-driven arms under the mesh, on [tp]'s engine
            out["tp-faults"] = tp_faults_phase(torch, lm["card"], pipe, prompts, out["tp"])
            out["tp-sla"] = tp_sla_phase(torch, lm["card"], pipe, prompts, out["tp"])
        del pipe
        torch.cuda.empty_cache()
    del raw
    torch.cuda.empty_cache()

    # [tp-lm] / [tp-lm-dense]: gemma3-1b cut to TP_GEMMA_LAYERS, a step 7
    # qmm and one FASST GLU gate a layer, no paged attention (its windows
    # take the gather route)
    gemma = dataclasses.replace(get_config("gemma3-1b"), num_layers=TP_GEMMA_LAYERS)
    for tag, paged in (("tp-lm", True), ("tp-lm-dense", False)):
        kw = dict(slots=SLOTS, max_len=LONG_LEN, horizon=HORIZON, init_seed=SEED,
                  device=device, ctx=ctx, **paging(paged))
        mem = engine_memory(torch, device, lambda: deploy(gemma, "int4", mesh=mesh, **kw))
        pipe = mem.pop("built")
        L = pipe.cfg.num_layers
        out[tag] = tp_serve(torch, tag, lm["card"], pipe, mem, lm["gemma_prompts"],
                            {"qmm": 7 * L, "qmm_naf": 0, "paged_attn": 0, "fasst_act": L},
                            {"build": lambda: deploy(gemma, "int4", **kw)},
                            ("qmm", "fasst_act"), dict(max_len=LONG_LEN))
        del pipe
        torch.cuda.empty_cache()

    # [tp-qwen]: the paged attention at the rank's 20 of 40 heads and 4 of
    # 8 KV heads; the ranks draw the f32 cut in turn
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=lm["qwen_layers"])
    kw = dict(slots=SLOTS, max_len=MAX_LEN, horizon=HORIZON, init_seed=SEED, device=device,
              ctx=ctx, **paging(True))
    for turn in range(world):
        if rank == turn:
            mem = engine_memory(torch, device, lambda: deploy(cfg, "int4", mesh=mesh, **kw))
            torch.cuda.empty_cache()
        dist.barrier()
    pipe = mem.pop("built")
    L = cfg.num_layers
    out["tp-qwen"] = tp_serve(torch, "tp-qwen", lm["card"], pipe, mem, lm["qwen_prompts"],
                              {"qmm": 7 * L, "qmm_naf": 0, "paged_attn": L, "fasst_act": L},
                              {"streams": lm["qwen_streams"],
                               "build": lambda: deploy(cfg, "int4", **kw)},
                              ("qmm", "fasst_act", "paged_attn"))
    del pipe
    torch.cuda.empty_cache()

    out.update(tp_family_phases(torch, rank, world, device, mesh, ctx, prompts, lm))
    out.update(tp_recurrent_phases(torch, device, mesh, ctx, lm))
    out.update(tp_quant_phases(torch, rank, device, mesh, prompts, lm, out["tp"]["streams"]))
    return out


def tp_family_phases(torch, rank, world, device, mesh, ctx, prompts, lm):
    """[tp-moe] / [tp-olmoe] / [tp-audio] on this rank: expert parallelism
    (each rank E / tp experts, the experts' FASST activation at the
    rank-local (G, E / tp, C, ff), one gather along E a layer) and the
    audio mesh (whisper's odd vocabulary replicated), paged, each held by
    tp_serve against the single device's streams of [moe-nllb] and
    [audio] (``lm["families"]``) and, for olmoe-1b-7b cut to
    TP_OLMOE_LAYERS, against a single-device engine of the cut that
    tp_vs_single serves on rank 0; a second run of each MoE engine must
    repeat its bits. Returns each phase's launches and numbers."""
    from repro_torch.configs import get_config
    from repro_torch.serving import SamplingParams, deploy
    say = log if rank == 0 else (lambda *a: None)
    out = {}
    fam = lm["families"]
    olmoe = dataclasses.replace(get_config("olmoe-1b-7b"), num_layers=TP_OLMOE_LAYERS)
    whisper = get_config("whisper-base")
    for tag, arch, prompts_of, per_layer, streams in (
            ("tp-moe", get_config("nllb600m-moe"), prompts,
             {"qmm": 6, "qmm_naf": 0, "paged_attn": 1, "fasst_act": 1}, fam["moe-nllb"]),
            ("tp-olmoe", olmoe, fam["moe-prompts"],
             {"qmm": 4, "qmm_naf": 0, "paged_attn": 1, "fasst_act": 1}, None),
            ("tp-audio", whisper, _frame_prompts(torch, whisper, device, SLOTS),
             {"qmm": 8, "qmm_naf": 1, "paged_attn": 1, "fasst_act": 0}, fam["audio"])):
        kw = dict(slots=SLOTS, max_len=MAX_LEN, horizon=HORIZON, init_seed=SEED,
                  device=device, ctx=ctx, paged=True, page_size=PAGE)
        mem = engine_memory(torch, device, lambda: deploy(arch, "int4", mesh=mesh, **kw))
        torch.cuda.empty_cache()
        pipe = mem.pop("built")
        L = arch.num_layers
        out[tag] = tp_serve(torch, tag, lm["card"], pipe, mem, prompts_of,
                            {k: v * L for k, v in per_layer.items()},
                            {"streams": streams, "build": lambda: deploy(arch, "int4", **kw)},
                            ("qmm", "fasst_act", "paged_attn"))
        if arch.moe is not None:
            again = pipe.generate(prompts_of, SamplingParams(max_new_tokens=GEN))
            if [o.token_ids for o in again] != out[tag]["streams"]:
                raise AssertionError(f"[{tag}] a second run of the engine changed a stream")
            say(f"[{tag}] a second run of the engine repeats all {len(again)} streams")
        del pipe
        torch.cuda.empty_cache()
    return out


def tp_recurrent_phases(torch, device, mesh, ctx, lm):
    """[tp-ssm] / [tp-hybrid] on this rank, dense (as on one device), each
    held by tp_serve with its collectives a step held exactly:
    mamba2-780m whole on [ssm]'s prompts against [ssm]'s streams
    (``lm["families"]["ssm"]``), each rank on 24 of the 48 SSD heads
    (layout (e)); a decode step launches qmm twice a layer and sums twice
    a layer (the gated norm's sums of squares, out_proj) plus the
    embedding's sum and the head's gather. recurrentgemma-9b at full
    width cut to TP_HYBRID_LAYERS (one (RG-LRU, RG-LRU, local attention)
    super-block and the 2-layer RG-LRU tail) on [hybrid]'s prompts, past
    its window, against one device's engine of the cut served on rank 0
    (tp_vs_single), each rank on half the RG-LRU channels and heads
    (layout (f), the one KV head copied): a step launches qmm 3 a
    recurrent and 7 an attention layer and the FASST kernel 2 and 1, and
    sums 3 times a recurrent layer (the conv output's gather, out_proj,
    the MLP) and twice an attention layer, plus the embedding and the
    head. Returns each phase's launches and numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models.hybrid import hybrid_layout
    from repro_torch.serving import deploy
    out = {}
    ssm = get_config("mamba2-780m")
    hybrid = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=TP_HYBRID_LAYERS)
    n_super, tail = hybrid_layout(hybrid)
    rec = 2 * n_super + tail
    hybrid_prompts = _lm_prompts(np.random.default_rng(SEED + 30), hybrid.vocab_size,
                                 2100, 2400)
    fam = lm["families"]["ssm"]
    for tag, arch, max_len, prompts_of, per_step, sums, streams, need in (
            ("tp-ssm", ssm, SSM_LEN, fam["prompts"],
             {"qmm": 2 * ssm.num_layers, "qmm_naf": 0, "paged_attn": 0, "fasst_act": 0},
             2 * ssm.num_layers + 2, fam["streams"], ("qmm",)),
            ("tp-hybrid", hybrid, HYBRID_LEN, hybrid_prompts,
             {"qmm": 3 * rec + 7 * n_super, "qmm_naf": 0, "paged_attn": 0,
              "fasst_act": 2 * rec + n_super},
             3 * rec + 2 * n_super + 2, None, ("qmm", "fasst_act"))):
        kw = dict(slots=SLOTS, max_len=max_len, horizon=HORIZON, init_seed=SEED,
                  device=device, ctx=ctx)
        mem = engine_memory(torch, device, lambda: deploy(arch, "int4", mesh=mesh, **kw))
        torch.cuda.empty_cache()
        pipe = mem.pop("built")
        out[tag] = tp_serve(torch, tag, lm["card"], pipe, mem, prompts_of, per_step,
                            {"streams": streams, "build": lambda: deploy(arch, "int4", **kw)},
                            need, dict(max_len=max_len), collectives=sums,
                            logit_tol=TP_RECURRENT_LOGIT_TOL[tag])
        del pipe
        torch.cuda.empty_cache()
    return out


# [tp-quant]: the arms [quant] serves on one device, each on the tp ranks
# (name, spec, calibrated on quant_calib)
TP_QUANT_ARMS = (("w8a8", "w8a8", True), ("fp8e2e", "fp8e2e", False),
                 ("w4a8kv8", "w4a8kv8", True), ("qlora", "int4", False))
# [tp-quant]: the (largest, mean) logit difference a teacher-forced step of
# a rank may show against one device, by arm, about 3x what a sound rank
# showed over 32 steps on an H100 ("NVIDIA H100 80GB HBM3, 700.00 W"):
# w8a8 (0.1055, 0.01462), fp8e2e (0.1719, 0.02746), w4a8kv8 (0.08789,
# 0.01337), qlora (0.03906, 0.005735). A planted fault (a rank quantizing
# its K slice on its own absmax) moved fp8e2e only to (0.2031, 0.03022):
# e4m3's relative step hardly depends on the scale, so no bound separates
# it; row_parallel_codes catches it exactly
TP_QUANT_LOGIT_TOL = {"w8a8": (0.3, 0.045), "fp8e2e": (0.5, 0.08), "w4a8kv8": (0.3, 0.04),
                      "qlora": (0.12, 0.02)}


def row_parallel_codes(torch, tag, pipe):
    """A dynamic act-quantizing arm's rank: the decoder's first FFN-out
    product (a row-parallel ".out" site) of seeded random bf16 rows, the
    same whole rows on every rank with an outlier in the last rank's
    slice, through the served ctx's ``Ctx.dot`` on the rank's K slice.
    The activation codes and per-token scales qmatmul quantizes with must
    be one device's codes of the whole rows, sliced, bit for bit (a rank
    on its own absmax gets other scales). Returns the codes held."""
    import repro_torch.core.qlinear as ql
    ctx, grp, dev = pipe.ctx, pipe.ctx.tp, pipe.engine.device
    w = pipe.params["decoder"]["layers"]["mlp"]["w_out"].select(0)
    k = w.shape[-2]
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    x = (3 * torch.randn((SLOTS, 1, k * grp.size), generator=g, device=dev)).to(torch.bfloat16)
    x[0, 0, -1] = 40.0
    real, seen = ql.quantize_activations, []

    def spy(xs, fmt="int8", scale=None):
        seen.append(real(xs, fmt, scale))
        return seen[-1]

    ql.quantize_activations = spy
    try:
        ctx.dot(x[..., grp.rank * k:(grp.rank + 1) * k], w, site="dec.ffn.out")
    finally:
        ql.quantize_activations = real
    codes, scale = real(x, ctx.act_fmt)
    (got, got_scale), = seen
    mine = codes[..., grp.rank * k:(grp.rank + 1) * k]
    if not (torch.equal(got.view(torch.uint8), mine.view(torch.uint8))
            and torch.equal(got_scale, scale)):
        raise AssertionError(f"[{tag}] rank {grp.rank}: the row-parallel FFN-out's "
                             f"{ctx.act_fmt} codes or per-token scales are not one device's")
    return got.numel()


def tp_quant_phases(torch, rank, device, mesh, prompts, lm, tp_streams):
    """[tp-quant] and [tp-spec] on this rank, paged, [serve]'s prompts, the
    raw weights of seed SEED at full width.

    [tp-quant-<arm>]: each of [quant]'s arms (TP_QUANT_ARMS: w8a8 and
    w4a8kv8 calibrated on [quant]'s batches, fp8e2e dynamic, int4 with
    [quant]'s rank-16 QLoRA adapters) deployed on the mesh and served by
    tp_serve against the streams [quant] served on one device
    (``lm["quant"]``): every rank's calibrated site table equal; a decode
    step launching what [quant]'s step launches; every step teacher-forced
    within TP_QUANT_LOGIT_TOL; a step's collectives exactly [tp]'s (the
    three row-parallel sums a decoder layer, the embedding's sum and the
    head's gather: 3 L + 2) plus, for the dynamic fp8e2e, one max of the
    per-token absmax at each row-parallel site (3 L).

    [tp-spec]: the int4 target with a w4a8kv8 draft arm calibrated on the
    same batches (lookahead SPEC_K): every rank's draft table and
    acceptance counters equal, the greedy streams [tp]'s target-only
    streams of this rank (``tp_streams``) up to near ties (replayed on
    fresh paged and dense target-only engines of the mesh), qmm, the
    FASST kernel and the paged attention held at every served shape.
    The dynamic arm's row-parallel codes are held exactly
    (row_parallel_codes). Returns each phase's launches and numbers."""
    import warnings
    from repro_torch.configs import get_config
    from repro_torch.core import resolve_spec
    from repro_torch.kernels import ops
    from repro_torch.models import Ctx, build_model
    from repro_torch.serving import SamplingParams, deploy
    say = log if rank == 0 else (lambda *a: None)
    cfg = get_config("nllb600m")
    L = cfg.num_layers
    raw = build_model(cfg, device).init(torch.Generator(device=device).manual_seed(SEED))
    calib = quant_calib(cfg)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, horizon=HORIZON, device=device, paged=True,
              page_size=PAGE, ctx=Ctx(compute_dtype=torch.bfloat16, use_fasst_kernel=True))
    act = {"qmm": 0, "qmm_naf": 0, "paged_attn": L, "fasst_act": L}
    per_step = {"w8a8": act, "fp8e2e": act,
                "w4a8kv8": {"qmm": 8 * L, "qmm_naf": L, "paged_attn": L, "fasst_act": 0},
                "qlora": {"qmm": 8 * L, "qmm_naf": 0, "paged_attn": L, "fasst_act": L}}
    out = {}

    def build(spec, params, calibrated, mesh=mesh, **more):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")       # fp8e2e quantizes dynamically
            return deploy("nllb600m", spec, params=params, mesh=mesh,
                          calib_batches=calib if calibrated else None, **kw, **more)

    def one_table(tag, pipe, calibrated, draft=False):
        table = (pipe.engine.draft.ctx if draft else pipe.ctx).act_scales
        if bool(table) != calibrated:
            raise AssertionError(f"[{tag}] calibrated={calibrated}, table {table}")
        if any(t != table for t in _group_gather(pipe.ctx.tp, table)):
            raise AssertionError(f"[{tag}] the ranks' calibrated site tables differ")
        if table:
            say(f"[{tag}] every rank holds the same {len(table)}-site table, merged by "
                f"max over the ranks once (dec.ffn.out {dict(table)['dec.ffn.out']:.6g})")

    for arm, spec, calibrated in TP_QUANT_ARMS:
        tag = f"tp-quant-{arm}"
        t0 = time.perf_counter()
        params = qlora_tree(torch, raw, device) if arm == "qlora" else raw
        mem = engine_memory(torch, device, lambda: build(spec, params, calibrated))
        pipe = mem.pop("built")
        dynamic = resolve_spec(spec).quantizes_act and not calibrated
        say(f"[{tag}] deployed in {time.perf_counter() - t0:.1f} s"
            + (", calibrated on [quant]'s batches" if calibrated else
               ", activations quantized dynamically" if dynamic else ""))
        one_table(tag, pipe, calibrated)
        if dynamic:
            n = row_parallel_codes(torch, tag, pipe)
            say(f"[{tag}] every rank's {pipe.ctx.act_fmt} codes and per-token scales at the "
                f"row-parallel FFN-out ({n} codes a rank) are one device's, bit for bit")
        need = ("fasst_act", "paged_attn") + (("qmm",) if per_step[arm]["qmm"] else ())
        out[tag] = tp_serve(torch, tag, lm["card"], pipe, mem, prompts, per_step[arm],
                            {"streams": lm["quant"][arm],
                             "build": lambda: build(spec, params, calibrated, mesh=None)},
                            need, collectives=3 * L + 2 + (3 * L if dynamic else 0),
                            logit_tol=TP_QUANT_LOGIT_TOL[arm])
        del pipe, params
        torch.cuda.empty_cache()

    tag = "tp-spec"
    t_phase = time.perf_counter()
    mem = engine_memory(torch, device, lambda: build("int4", raw, True, draft_spec="w4a8kv8",
                                                     draft_lookahead=SPEC_K))
    pipe = mem.pop("built")
    eng, grp = pipe.engine, pipe.ctx.tp
    one_table(tag, pipe, True, draft=True)
    sp = SamplingParams(max_new_tokens=GEN)
    eng.reset_metrics()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with served_shapes() as seen:
        outs = pipe.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if rank == 0:
        hold_served(torch, tag, seen, device, ("qmm", "fasst_act", "paged_attn"))
    streams = [o.token_ids for o in outs]
    if any(o.finish_reason != "length" or len(o.token_ids) != GEN for o in outs):
        raise AssertionError(f"[{tag}] not every request retired on length")
    eng.allocator.check()
    if eng.allocator.pages_in_use:
        raise AssertionError(f"[{tag}] {eng.allocator.pages_in_use} pages leaked")
    m = eng.metrics()
    counters = (m.drafted_tokens, m.accepted_tokens, m.verify_calls)
    every = _group_gather(grp, (streams, counters))
    if any(c != counters for _, c in every) or any(t != streams for t, _ in every):
        raise AssertionError(f"[{tag}] the ranks' streams or acceptance counters differ: "
                             f"{[c for _, c in every]}")
    if not (m.verify_calls and launches["qmm"] and launches["paged_attn"]):
        raise AssertionError(f"[{tag}] {m.verify_calls} verify rounds, launches {launches}")
    n = len(prompts)
    part = _partings(tag, streams, tp_streams) if rank == 0 else {}
    steps = _group_bcast(grp, max(list(part.values()) + [3]) if part else 0)
    if steps:
        sides = [[(_fresh_engine(pipe, paged), list(range(n)))] for paged in (True, False)]
        if rank == 0:
            near_tie_partings(torch, tag, pipe, prompts, [sp] * n, streams, tp_streams,
                              sides=sides)
        else:
            tp_follow_replay(torch, sides, prompts, [sp] * n, streams, steps)
    tokens = sum(len(t) for t in streams)
    say(f"[{tag}] " + json.dumps({
        "draft": pipe.draft_spec_str, "lookahead": SPEC_K, "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "acceptance_rate": m.acceptance_rate,
        "drafted_accepted_verify_rounds": counters, "same_counters_on_every_rank": True,
        "same_as_tp_target_only": n - len(part), "near_tie_partings": len(part),
        "decode_ms_per_step": 1e3 * eng.decode_s / max(eng.decode_steps, 1),
        "launches": launches, "rank_memory_gb": {k: v / 1e9 for k, v in mem.items()},
        "card": lm["card"]}))
    say(f"[{tag}] phase took {time.perf_counter() - t_phase:.1f} s")
    out[tag] = {"launches": launches, "streams": streams}
    del pipe, eng, raw
    torch.cuda.empty_cache()
    return out


def tp_lm_inputs(torch, card):
    """The LM inputs of the tp spawn: [lm-gemma]'s and [lm]'s prompts, and
    the single device's greedy streams of [tp-qwen]'s cut (qwen2.5-14b,
    TP_QWEN_LAYERS of its 48 layers, int4 paged), served here before the
    spawn and freed."""
    from repro_torch.configs import get_config
    from repro_torch.models import Ctx
    from repro_torch.serving import SamplingParams, deploy
    qcfg = get_config(LM_ARCH)
    gemma = _lm_prompts(np.random.default_rng(SEED + 21), get_config("gemma3-1b").vocab_size,
                        520, 700)
    qwen = _lm_prompts(np.random.default_rng(SEED + 20), qcfg.vocab_size, 32, 64)
    t0 = time.perf_counter()
    mem = engine_memory(torch, torch.device("cuda"), lambda: deploy(
        dataclasses.replace(qcfg, num_layers=TP_QWEN_LAYERS), "int4", slots=SLOTS,
        max_len=MAX_LEN, horizon=HORIZON, init_seed=SEED, paged=True, page_size=PAGE,
        ctx=Ctx(compute_dtype=torch.bfloat16, use_fasst_kernel=True)))
    pipe = mem.pop("built")
    pipe.generate(qwen[:2], SamplingParams(max_new_tokens=4))
    streams = [o.token_ids for o in pipe.generate(qwen, SamplingParams(max_new_tokens=GEN))]
    log(f"[tp-qwen] the single device's streams of {LM_ARCH} cut to {TP_QWEN_LAYERS} of 48 "
        f"layers (int4 paged), served before the spawn in {time.perf_counter() - t0:.1f} s: "
        f"{_mem_line(mem)}")
    del pipe
    torch.cuda.empty_cache()
    return {"gemma_prompts": gemma, "qwen_prompts": qwen, "qwen_streams": streams,
            "qwen_layers": TP_QWEN_LAYERS, "card": card}


def time_tp_kernels(torch, card, dev):
    """qmm and paged attention over one tp2 rank's NLLB decode step, timed
    on the card alone (no other rank running), then the same for
    qwen2.5-14b and for nllb600m-moe (with its experts' FASST
    activation): qmm at the shard shapes
    (6 decoder layers x q, k, v, cross q 1024x512; o, cross o 512x1024;
    FFN in 1024x4096, out 4096x1024; int4, M 8: 48 launches, each on its
    own weight), paged attention at the rank's 8 of 16 heads (6 launches,
    d 64, int8 pages of 16, lengths as row 2's); then the same over one
    tp2 rank's qwen2.5-14b decode step at [tp-qwen]'s cut (TP_QWEN_LAYERS
    layers x 7 int4 launches at the shard shapes; paged attention at 20 of
    40 heads, 4 of 8 KV heads, d 128); the nllb600m-moe step as its
    comment below says; qmm over one tp2 rank's mamba2-780m decode step
    ([tp-ssm]) and recurrentgemma-9b decode step at [tp-hybrid]'s cut.
    Returns the ``tp_``, ``tp_qwen_``, ``tp_moe_``, ``tp_ssm_`` and
    ``tp_hybrid_`` keys of the qmm, paged_attn and fasst_act entries."""
    from repro_torch.core.qtensor import QTensor
    g = torch.Generator(device=dev).manual_seed(SEED + 33)
    layer = [(1024, 512)] * 4 + [(512, 1024)] * 2 + [(1024, 4096), (4096, 1024)]
    ws = [QTensor.quantize(torch.randn(kn, generator=g, device=dev) * 0.02, "int4", 64)
          for _ in range(6) for kn in layer]
    fns, (t, by) = qmm_window(torch, g, dev, ws, SLOTS)
    out = {"qmm": {**times(*fns, plain_reps=2), "bound_ms": t, "bound_by": by,
                   "work": f"one tp{TP} rank's nllb600m decode step: {len(ws)} int4 launches "
                           f"at M={SLOTS} (q, k, v, cross q 1024x512; o, cross o 512x1024; "
                           "FFN 1024x4096, 4096x1024)"}}
    del ws, fns
    lens = torch.randint(1, 257, (SLOTS,), generator=g, device=dev)
    fns, (t, by), work = paged_window(torch, g, dev, 16 // TP, 16 // TP, 64, 16, 6, lens)
    out["paged_attn"] = {**times(*fns), "bound_ms": t, "bound_by": by,
                         "work": f"one tp{TP} rank's nllb600m decode step: {work}"}
    del fns
    torch.cuda.empty_cache()
    # one tp2 rank's qwen2.5-14b decode step at [tp-qwen]'s cut: qmm at the
    # shard shapes (q 5120x2560; k, v 5120x512; o 2560x5120; gate, up
    # 5120x6912; down 6912x5120), paged attention at 20 of 40 heads, 4 of
    # 8 KV heads (d 128, int8 pages of 16)
    layer = ([(5120, 2560)] + [(5120, 512)] * 2 + [(2560, 5120)] + [(5120, 6912)] * 2
             + [(6912, 5120)])
    ws = [QTensor.quantize(torch.randn(kn, generator=g, device=dev) * 0.02, "int4", 64)
          for _ in range(TP_QWEN_LAYERS) for kn in layer]
    fns, (t, by) = qmm_window(torch, g, dev, ws, SLOTS)
    qwen = {"qmm": {**times(*fns, plain_reps=2), "bound_ms": t, "bound_by": by,
                    "work": f"one tp{TP} rank's {LM_ARCH} decode step ({TP_QWEN_LAYERS} "
                            f"layers): {len(ws)} int4 launches at M={SLOTS} (q 5120x2560; k, v "
                            "5120x512; o 2560x5120; gate, up 5120x6912; down 6912x5120)"}}
    del ws, fns
    torch.cuda.empty_cache()
    lens = torch.randint(1, MAX_LEN + 1, (SLOTS,), generator=g, device=dev)
    fns, (t, by), work = paged_window(torch, g, dev, 40 // TP, 8 // TP, 128, MAX_LEN // PAGE,
                                      TP_QWEN_LAYERS, lens)
    qwen["paged_attn"] = {**times(*fns), "bound_ms": t, "bound_by": by,
                          "work": f"one tp{TP} rank's {LM_ARCH} decode step: {work}"}
    del fns
    torch.cuda.empty_cache()
    # one tp2 rank's nllb600m-moe decode step: qmm at the attention's shard
    # shapes (q, k, v, cross q 1024x512; o, cross o 512x1024; the experts
    # are dequantize-then-einsum), paged attention at 8 of 16 heads, and
    # the FASST activation (relu) on the rank's 8 of 16 experts' rows of
    # the dropless decode buffer, (G, E / tp, C, ff) = (8, 8, 1, 8192) bf16
    layer = [(1024, 512)] * 4 + [(512, 1024)] * 2
    ws = [QTensor.quantize(torch.randn(kn, generator=g, device=dev) * 0.02, "int4", 64)
          for _ in range(6) for kn in layer]
    fns, (t, by) = qmm_window(torch, g, dev, ws, SLOTS)
    moe = {"qmm": {**times(*fns, plain_reps=2), "bound_ms": t, "bound_by": by,
                   "work": f"one tp{TP} rank's nllb600m-moe decode step: {len(ws)} int4 "
                           f"launches at M={SLOTS} (q, k, v, cross q 1024x512; o, cross o "
                           "512x1024)"}}
    del ws, fns
    lens = torch.randint(1, 257, (SLOTS,), generator=g, device=dev)
    fns, (t, by), work = paged_window(torch, g, dev, 16 // TP, 16 // TP, 64, 16, 6, lens)
    moe["paged_attn"] = {**times(*fns), "bound_ms": t, "bound_by": by,
                         "work": f"one tp{TP} rank's nllb600m-moe decode step: {work}"}
    shape = (SLOTS, 16 // TP, 1, 8192)
    fns, (t, by) = fasst_window(torch, g, dev, shape, 6)
    moe["fasst_act"] = {**times(*fns, plain_reps=20), "bound_ms": t, "bound_by": by,
                        "work": f"one tp{TP} rank's nllb600m-moe decode step: 6 relu launches "
                                f"on its experts' {shape} bf16 (G, E/tp, C, ff)"}
    del fns
    torch.cuda.empty_cache()
    # one tp2 rank's mamba2-780m decode step: 48 layers x in_proj at the
    # rank's 24 of 48 SSD heads (1536 x (2 x 1536 + 2 x 128 + 24) = 1536 x
    # 3352, N no multiple of 64) and out_proj's rows (1536 x 1536)
    ws = [QTensor.quantize(torch.randn(kn, generator=g, device=dev) * 0.02, "int4", 64)
          for _ in range(48) for kn in ((1536, 3352), (1536, 1536))]
    fns, (t, by) = qmm_window(torch, g, dev, ws, SLOTS)
    ssm = {"qmm": {**times(*fns, plain_reps=2), "bound_ms": t, "bound_by": by,
                   "work": f"one tp{TP} rank's mamba2-780m decode step: {len(ws)} int4 "
                           f"launches at M={SLOTS} (in_proj 1536x3352, out_proj 1536x1536)"}}
    del ws, fns
    torch.cuda.empty_cache()
    # one tp2 rank's recurrentgemma-9b decode step at [tp-hybrid]'s cut:
    # the MLP of each of the 5 layers (gate, up 4096x6144; down 6144x4096)
    # and the attention layer's q 4096x2048, k, v 4096x256 (the one KV head
    # copied), o 2048x4096; the RG-LRU is bf16 (the policy exempts it)
    layers = [[(4096, 6144)] * 2 + [(6144, 4096)]] * TP_HYBRID_LAYERS \
        + [[(4096, 2048)] + [(4096, 256)] * 2 + [(2048, 4096)]]
    ws = [QTensor.quantize(torch.randn(kn, generator=g, device=dev) * 0.02, "int4", 64)
          for layer in layers for kn in layer]
    fns, (t, by) = qmm_window(torch, g, dev, ws, SLOTS)
    hybrid = {"qmm": {**times(*fns, plain_reps=2), "bound_ms": t, "bound_by": by,
                      "work": f"one tp{TP} rank's recurrentgemma-9b decode step "
                              f"({TP_HYBRID_LAYERS} layers): {len(ws)} int4 launches at "
                              f"M={SLOTS} (MLP gate, up 4096x6144, down 6144x4096; q "
                              "4096x2048; k, v 4096x256; o 2048x4096)"}}
    del ws, fns
    torch.cuda.empty_cache()
    keyed = {}
    for pre, group in (("tp_", out), ("tp_qwen_", qwen), ("tp_moe_", moe),
                       ("tp_ssm_", ssm), ("tp_hybrid_", hybrid)):
        for name, e in group.items():
            keyed.setdefault(name, {}).update({f"{pre}{k}": v for k, v in e.items()})
            log_time({"name": name, **{f"{pre}{k}": v for k, v in e.items()}}, card, pre)
    return keyed


def fasst_window(torch, g, dev, shape, n, mode="relu"):
    """Kernel, plain and library calls of ``n`` FASST activations on their
    own bf16 inputs of ``shape``, one launch each, and the bound of that
    work (each value read and written once, one operation a value)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fasst import fasst_act_plain
    xs = [(3 * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)
          for _ in range(n)]
    numel = n * int(np.prod(shape))
    return ((lambda: [ops.fasst(x, mode) for x in xs],
             lambda: [fasst_act_plain(x, mode) for x in xs],
             lambda: [torch.relu(x) for x in xs]),
            bound_ms(numel * 2 * 2, numel, F32_FLOPS_PER_MS))


def tp_phase(card, prompts, lm):
    """[tp] / [tp-faults] / [tp-sla] / [tp-dense] / [compress] / [tp-lm] /
    [tp-lm-dense] / [tp-qwen] / [tp-moe] / [tp-olmoe] / [tp-audio] /
    [tp-ssm] / [tp-hybrid] / [tp-quant-*] / [tp-spec] on TP ranks sharing
    the card."""
    from repro_torch.cluster import launch_ranks, rank_backend
    backend = rank_backend("cuda", TP)
    if backend != "gloo":
        raise AssertionError(f"{TP} ranks on one card must take gloo, got {backend}")
    t0 = time.perf_counter()
    results = launch_ranks(tp_rank, TP, device="cuda", args=(prompts, lm))
    log(f"[tp] {TP} ranks over {backend} on {card} took {time.perf_counter() - t0:.1f} s "
        "(process start, deploys, nllb600m's two layouts and [tp]'s clock-driven arms, "
        "gemma3-1b's cut's two, qwen2.5-14b's "
        "cut, nllb600m-moe, olmoe-1b-7b's cut, whisper-base, mamba2-780m, "
        "recurrentgemma-9b's cut, nllb600m's four quantization arms and its draft arm)")
    return results[0]


TP3 = 3
# [tp3-dense]: 14 cache rows a rank; a request's 1 prompt + 31 fed tokens
# write positions 0-31, so every rank's block holds some (at 48, with 16
# rows a rank, the third block would hold none)
TP3_DENSE_LEN = 42
# [tp3-dense] / [tp3-lm]: the (largest, mean) logit difference a
# teacher-forced step of a rank may show against one device, every step
# replayed, so that a combine that loses a rank's partial fails where the
# greedy streams hold. On an H100 sound ranks gave (0.03125, 0.001192) and
# (0.07812, 0.01016) over 32 steps; with the last rank's packed partial
# zeroed (0.1562, 0.01326) and (1.469, 0.2077), neither stream parting.
TP3_LOGIT_TOL = {"tp3-dense": (0.1, 0.004), "tp3-lm": (0.25, 0.03)}


def tp3_rank(rank, world, device, prompts, lm):
    """[tp3] / [tp3-dense] / [tp3-lm] on one of ``world`` (3) ranks sharing
    the card over gloo, each engine a deploy(mesh=tp_mesh(3)) served by
    tp_serve, the decode step's collectives held exactly. Full-width
    nllb600m int4 on [serve]'s prompts and weights (seed), where 3 divides
    no width: paged as [serve] ([tp3]: every sublayer and the pool whole,
    no collective, the streams [serve]'s bit for bit) and dense at
    TP3_DENSE_LEN ([tp3-dense]: 2 collectives a layer, the sequence
    split's max and sum, against one device's engine of that shape);
    then gemma3-1b cut to TP_GEMMA_LAYERS, dense at LONG_LEN ([tp3-lm]: 2
    + 1 a layer, the FFN split) on [lm-gemma]'s prompts, against the
    single device's streams [tp-lm-dense] served. Both dense phases hold
    every teacher-forced step's logits to TP3_LOGIT_TOL. Returns each
    phase's launches and numbers."""
    import torch
    from repro_torch.cluster import tp_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import Ctx, build_model
    from repro_torch.serving import deploy
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = tp_mesh(world)
    if rank == 0:
        log(f"[tp3] {world} ranks on {device} of one {torch.cuda.get_device_name(device)}, "
            f"{mesh!r}")
    ctx = Ctx(compute_dtype=torch.bfloat16, use_fasst_kernel=True)
    raw = build_model(get_config("nllb600m"), device).init(
        torch.Generator(device=device).manual_seed(SEED))
    out = {}
    for tag, paged, max_len in (("tp3", True, MAX_LEN), ("tp3-dense", False, TP3_DENSE_LEN)):
        kw = dict(slots=SLOTS, max_len=max_len, horizon=HORIZON, params=raw, device=device,
                  ctx=ctx, **(dict(paged=True, page_size=PAGE) if paged else {}))
        mem = engine_memory(torch, device, lambda: deploy("nllb600m", "int4", mesh=mesh, **kw))
        pipe = mem.pop("built")
        L = pipe.cfg.num_layers
        single = {"build": lambda: deploy("nllb600m", "int4", **kw)}
        if paged:
            single["streams"] = lm["serve_streams"]
        out[tag] = tp_serve(
            torch, tag, lm["card"], pipe, mem, prompts,
            {"qmm": 8 * L, "qmm_naf": L, "paged_attn": L if paged else 0, "fasst_act": 0},
            single, ("qmm", "fasst_act") + (("paged_attn",) if paged else ()),
            dict(max_len=max_len), collectives=0 if paged else 2 * L,
            logit_tol=TP3_LOGIT_TOL.get(tag), whole=True)
        if paged and out[tag]["streams"] != lm["serve_streams"]:
            raise AssertionError("[tp3] a rank's streams are not [serve]'s bit for bit")
        if paged and rank == 0:
            log(f"[tp3] every rank's {len(prompts)} streams are [serve]'s bit for bit")
        del pipe
        torch.cuda.empty_cache()
    del raw
    torch.cuda.empty_cache()
    gemma = dataclasses.replace(get_config("gemma3-1b"), num_layers=TP_GEMMA_LAYERS)
    kw = dict(slots=SLOTS, max_len=LONG_LEN, horizon=HORIZON, init_seed=SEED, device=device,
              ctx=ctx)
    mem = engine_memory(torch, device, lambda: deploy(gemma, "int4", mesh=mesh, **kw))
    pipe = mem.pop("built")
    L = pipe.cfg.num_layers
    out["tp3-lm"] = tp_serve(torch, "tp3-lm", lm["card"], pipe, mem, lm["gemma_prompts"],
                             {"qmm": 7 * L, "qmm_naf": 0, "paged_attn": 0, "fasst_act": L},
                             {"streams": lm["gemma_streams"],
                              "build": lambda: deploy(gemma, "int4", **kw)},
                             ("qmm", "fasst_act"), dict(max_len=LONG_LEN),
                             collectives=3 * L, logit_tol=TP3_LOGIT_TOL["tp3-lm"])
    del pipe
    torch.cuda.empty_cache()
    return out


def tp3_phase(card, prompts, lm):
    """[tp3] / [tp3-dense] / [tp3-lm] on TP3 ranks sharing the card."""
    from repro_torch.cluster import launch_ranks, rank_backend
    backend = rank_backend("cuda", TP3)
    if backend != "gloo":
        raise AssertionError(f"{TP3} ranks on one card must take gloo, got {backend}")
    t0 = time.perf_counter()
    results = launch_ranks(tp3_rank, TP3, device="cuda", args=(prompts, lm))
    log(f"[tp3] {TP3} ranks over {backend} on {card} took {time.perf_counter() - t0:.1f} s "
        "(process start, deploys, nllb600m's two layouts, gemma3-1b's cut)")
    return results[0]


def dp_phase(torch, card, prompts, serve_pipe, serve_outs):
    """[dp]: deploy_replicas(replicas=2) on the one card, [serve]'s engine
    shape, weights (seed) and prompts, routed by the ReplicaRouter. Each
    replica's streams equal a lone engine serving that replica's requests
    alone, bit for bit (replicas share nothing); against [serve]'s
    streams, a parting must be a near tie (the replicas prefill their
    halves in smaller groups, so their rows take other qmm tile plans);
    the merged counters and histograms are the replicas' sums, and the
    Prometheus text carries both sections. Returns the launches."""
    from repro_torch.cluster import ReplicaRouter, deploy_replicas
    from repro_torch.kernels import ops
    from repro_torch.models import Ctx
    from repro_torch.serving import SamplingParams
    t0 = time.perf_counter()
    pipe = deploy_replicas("nllb600m", "int4", replicas=2, slots=SLOTS, max_len=MAX_LEN,
                           horizon=HORIZON, init_seed=SEED, paged=True, page_size=PAGE,
                           ctx=Ctx(compute_dtype=torch.bfloat16, use_fasst_kernel=True))
    torch.cuda.synchronize()
    router = pipe.engine
    if not isinstance(router, ReplicaRouter):
        raise AssertionError("deploy_replicas returned no router")
    devs = [str(e.device) for e in router.replicas]
    log(f"[dp] deployed 2 replicas of nllb600m int4 (paged) on {devs} in "
        f"{time.perf_counter() - t0:.1f} s")
    sp = SamplingParams(max_new_tokens=GEN)
    pipe.generate(prompts[:2], SamplingParams(max_new_tokens=4))
    router.reset_metrics()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    gids = [router.submit(p, sp) for p in prompts]
    placed = [router._owner[g][0] for g in gids]
    by_id = {o.request_id: o for o in router.run_until_drained()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    outs = [by_id[g] for g in gids]
    if any(o.finish_reason != "length" or len(o.token_ids) != GEN for o in outs):
        raise AssertionError("[dp] not every request retired on length")
    streams = [o.token_ids for o in outs]
    # replicas share nothing: each serves its requests as a lone engine would
    for r, eng in enumerate(router.replicas):
        idx = [i for i, p in enumerate(placed) if p == r]
        lone = _fresh_engine(dataclasses.replace(pipe, engine=eng), True)
        ids = [lone.submit(prompts[i], sp) for i in idx]
        got = {o.request_id: o.token_ids for o in lone.run_until_drained()}
        if [got[i] for i in ids] != [streams[i] for i in idx]:
            raise AssertionError(f"[dp] replica {r}'s streams are not a lone engine's")
    serve_streams = [o.token_ids for o in serve_outs]
    part = _partings("dp", streams, serve_streams, first_token_ties=True)
    if part:
        side = [(_fresh_engine(dataclasses.replace(pipe, engine=eng), True),
                 [i for i, p in enumerate(placed) if p == r])
                for r, eng in enumerate(router.replicas)]
        near_tie_partings(torch, "dp", pipe, prompts, [sp] * len(prompts), streams,
                          serve_streams, first_token_ties=True,
                          sides=[side, [(_fresh_engine(serve_pipe, True),
                                         list(range(len(prompts))))]])
    m = router.metrics()
    per = [e.metrics() for e in router.replicas]
    for field in ("synced_tokens", "decode_syncs", "decode_steps", "kv_cache_bytes"):
        if getattr(m, field) != sum(getattr(p, field) for p in per):
            raise AssertionError(f"[dp] merged {field} is not the replicas' sum")
    hist = router.merged_latency_histograms()["ttft_ms"]
    if hist.count != sum(e.latency_histograms()["ttft_ms"].count for e in router.replicas):
        raise AssertionError("[dp] the merged TTFT histogram is not the replicas' sum")
    prom = router.prometheus()
    if 'repro_cluster_replica_synced_tokens{replica="1"}' not in prom \
            or "repro_cluster_ttft_ms_bucket" not in prom:
        raise AssertionError("[dp] prometheus() lacks the merged or per-replica section")
    tokens = sum(len(t) for t in streams)
    stats = {"requests": len(outs), "placements": placed, "tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall, "same_as_serve": len(outs) - len(part),
             "near_tie_partings": len(part), "merged_synced_tokens": m.synced_tokens,
             "ttft_p95_ms": m.ttft_p95_ms, "launches": launches, "card": card}
    log(f"[dp] {json.dumps(stats)}")
    del pipe, router
    torch.cuda.empty_cache()
    return launches, placed, [m.synced_tokens for m in per]


def dp_tp_rank(rank, world, device, prompts, card):
    """[dp-tp] on one of the 4 ranks sharing the card over gloo:
    deploy_replicas("nllb600m", "int4", replicas=2, tp=2) of [serve]'s
    engine shape and weights (seed), [serve]'s prompts routed by the
    replicated GroupRouter. Every rank returns the same outputs; each
    group's rank 0 holds the kernels at the shard shapes its warm-up gave
    them; a decode step of each rank's engine launches exactly a tp2
    rank's; each replica's streams equal a lone tensor-parallel engine of
    its group serving its requests alone, bit for bit, and one device's
    serving them up to near ties replayed on both sides (tp_vs_single);
    the merged counters and histograms are the replicas' sums; every
    request is submitted with ``on_token``, and every rank's callback
    streams equal the drained outputs. Returns the placements, streams,
    launches and numbers."""
    import torch
    import torch.distributed as dist
    from repro_torch.cluster import GroupRouter, deploy_replicas
    from repro_torch.kernels import ops
    from repro_torch.models import Ctx
    from repro_torch.serving import SamplingParams, deploy
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    kw = dict(slots=SLOTS, max_len=MAX_LEN, horizon=HORIZON, init_seed=SEED, paged=True,
              page_size=PAGE, ctx=Ctx(compute_dtype=torch.bfloat16, use_fasst_kernel=True),
              device=device)
    mem = engine_memory(torch, device, lambda: deploy_replicas(
        "nllb600m", "int4", replicas=2, tp=2, **kw))
    pipe = mem.pop("built")
    router = pipe.engine
    if not isinstance(router, GroupRouter):
        raise AssertionError("[dp-tp] deploy_replicas(tp=2) returned no GroupRouter")
    eng = router.own
    grp, lc = eng.ctx.tp, eng.model.cfg
    glead = grp.rank == 0
    say = log if rank == 0 else (lambda *a: None)
    say(f"[dp-tp] deployed 2 replicas x tp2 of nllb600m int4 (paged) on {world} ranks of "
        f"one {torch.cuda.get_device_name(device)} over {grp.backend}: each rank "
        f"{lc.num_heads}/{lc.num_kv_heads} heads, d_ff {lc.d_ff}; {_mem_line(mem)}")
    sp = SamplingParams(max_new_tokens=GEN)
    with served_shapes() as seen:
        pipe.generate(prompts, SamplingParams(max_new_tokens=4))
    if glead:
        hold_served(torch, f"dp-tp group {router.group}", seen, device,
                    ("qmm", "fasst_act", "paged_attn"))
    router.reset_metrics()
    torch.cuda.synchronize()
    dist.barrier()
    in_decode = counted_decode(eng)
    steps0 = eng.decode_steps
    ops.reset_launches()
    t0 = time.perf_counter()
    heard = [[] for _ in prompts]       # every rank's on_token streams
    gids = [router.submit(p, sp, on_token=heard[i].append) for i, p in enumerate(prompts)]
    placed = [router._owner[g][0] for g in gids]
    by_id = {o.request_id: o for o in router.run_until_drained()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    end_count(eng)
    outs = [by_id[g] for g in gids]
    if any(o.finish_reason != "length" or len(o.token_ids) != GEN for o in outs):
        raise AssertionError("[dp-tp] not every request retired on length")
    streams = [o.token_ids for o in outs]
    if heard != streams:
        raise AssertionError(f"[dp-tp] rank {rank}'s on_token streams are not the drained "
                             "outputs")
    every = [None] * world
    dist.all_gather_object(every, (streams, placed, [o.ttft_ms for o in outs]))
    if any(e != every[0] for e in every):
        raise AssertionError("[dp-tp] the ranks' outputs or placements differ")
    L = lc.num_layers
    per_step = {"qmm": 8 * L, "qmm_naf": L, "paged_attn": L, "fasst_act": 0}
    steps_run = eng.decode_steps - steps0
    if not steps_run or any(in_decode[k] != c * steps_run for k, c in per_step.items()):
        raise AssertionError(f"[dp-tp] {steps_run} decode steps launched {in_decode}; a "
                             f"step launches {per_step}")
    m = router.metrics()
    per = [e.metrics() for e in router.replicas]
    for field in ("synced_tokens", "decode_syncs", "decode_steps", "kv_cache_bytes"):
        if getattr(m, field) != sum(getattr(p, field) for p in per):
            raise AssertionError(f"[dp-tp] merged {field} is not the replicas' sum")
    hists = [e.latency_histograms()["ttft_ms"].count for e in router.replicas]
    if router.merged_latency_histograms()["ttft_ms"].count != sum(hists):
        raise AssertionError("[dp-tp] the merged TTFT histogram is not the replicas' sum")
    prom = router.prometheus()
    if 'repro_cluster_replica_synced_tokens{replica="1"}' not in prom:
        raise AssertionError("[dp-tp] prometheus() lacks the per-replica section")
    # each replica as a lone tensor-parallel engine of its group, and
    # against one device, on its own requests
    idx = [i for i, r in enumerate(placed) if r == router.group]
    mine = [prompts[i] for i in idx]
    lone = _fresh_engine(dataclasses.replace(pipe, engine=eng), True)
    ids = [lone.submit(p, sp) for p in mine]
    got = {o.request_id: o.token_ids for o in lone.run_until_drained()}
    if [got[i] for i in ids] != [streams[i] for i in idx]:
        raise AssertionError(f"[dp-tp] replica {router.group}'s streams are not a lone tp2 "
                             "engine's")
    tp_pipe = dataclasses.replace(pipe, engine=eng)
    kw.pop("device")
    part, smem, _ = tp_vs_single(torch, f"dp-tp group {router.group}", grp, tp_pipe, mine, sp,
                              [streams[i] for i in idx],
                              {"build": lambda: deploy("nllb600m", "int4", device=device,
                                                       **kw)})
    parts = [None] * world
    dist.all_gather_object(parts, len(part) if glead else None)
    tokens = sum(len(t) for t in streams)
    stats = {"requests": len(outs), "placements": placed, "tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall,
             "near_tie_partings_vs_single_device": [parts[0], parts[2]],
             "merged_synced_tokens": m.synced_tokens,
             "replica_synced_tokens": [p.synced_tokens for p in per],
             "ttft_p95_ms": m.ttft_p95_ms, "launches_per_step": per_step,
             "on_token_streams_equal_outputs": "every rank",
             "rank_memory_gb": {k: v / 1e9 for k, v in mem.items()},
             "note": f"{world} ranks share one card over {grp.backend}", "card": card}
    say(f"[dp-tp] {json.dumps(stats)}")
    say(f"[dp-tp] phase took {time.perf_counter() - t_phase:.1f} s in the ranks")
    del pipe, router, eng, lone, tp_pipe
    torch.cuda.empty_cache()
    return {"launches": launches, "placements": placed, "streams": streams,
            "replica_synced_tokens": stats["replica_synced_tokens"]}


def dp_tp_phase(card, prompts, dp_placed):
    """[dp-tp]: the composed stack on 4 ranks sharing the card; its
    placements must be [dp]'s (the same router over replicas of the same
    shape). Returns rank 0's launches."""
    from repro_torch.cluster import launch_ranks, rank_backend
    backend = rank_backend("cuda", 4)
    if backend != "gloo":
        raise AssertionError(f"4 ranks on one card must take gloo, got {backend}")
    t0 = time.perf_counter()
    results = launch_ranks(dp_tp_rank, 4, device="cuda", args=(prompts, card))
    if results[0]["placements"] != dp_placed:
        raise AssertionError(f"[dp-tp] placements {results[0]['placements']} are not "
                             f"[dp]'s {dp_placed}")
    log(f"[dp-tp] placements equal [dp]'s {dp_placed}; 4 ranks over {backend} on {card} "
        f"took {time.perf_counter() - t0:.1f} s (process start, deploys and the run)")
    return results[0]["launches"]



def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from repro_torch.core.qtensor import QTensor
    from repro_torch.kernels import build, ops
    t0 = time.perf_counter()
    build.build()
    t_nvcc = time.perf_counter() - t0
    ops.fasst(torch.zeros(4, 8, device=dev), "relu")       # Triton JIT compiles
    ops.fasst_softmax(torch.zeros(4, 8, device=dev))
    ops.qmm(torch.zeros(1, 64, device=dev),                  # load + codebooks
            QTensor.quantize(torch.zeros(64, 8, device=dev), "int4"),
            compute_dtype=torch.float32)
    torch.cuda.synchronize()
    log(f"[build] nvcc ({len(build.SOURCES)} sources in parallel) {t_nvcc:.1f} s; with "
        f"Triton compile and load {time.perf_counter() - t0:.1f} s")
    for name, text in build.PTXAS_LOG.items():
        for fn, line in ptxas_lines(text):
            log(f"[ptxas {name}] {fn}: {line}")
    log_sass("qmm", build.library_path("qmm"))

    t0 = time.perf_counter()
    entries = [check_qmm(torch, dev), check_qmm_naf(torch, dev, card),
               check_paged_attn(torch, dev), check_fasst(torch, dev),
               check_decode_attn(torch, dev), check_fasst_softmax(torch, dev)]
    log(f"[kernels] the six kernel checks and their times took "
        f"{time.perf_counter() - t0:.1f} s")
    for e in entries:
        log_time(e, card)
    q = entries[0]
    for m in q["prefill_ms"]:
        log(f"[time] qmm prefill {m}: kernel {q['prefill_ms'][m]:.4f} ms, plain "
            f"{q['prefill_plain_ms'][m]:.4f} ms, library {q['prefill_library_ms'][m]:.4f} "
            f"ms, bound {q['prefill_bound_ms'][m]:.4f} ms ({q['prefill_bound_by'][m]}); "
            f"device only: kernel {fmt_ms(q['prefill_device_ms'][m])}, library "
            f"{fmt_ms(q['prefill_library_device_ms'][m])}; on {card}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pipe, launches, prompts, paged_outs, paged_stats = serve(torch, card, paged=True)
    routes_agree(torch, pipe, prompts)
    profile_decode(torch, pipe, prompts)
    pipe_d, _, _, dense_outs, dense_stats = serve(torch, card, paged=False,
                                                  params=pipe.params)
    profile_decode(torch, pipe_d, prompts, "profile-dense")
    profile_decode(torch, pipe_d, prompts, "profile-dense-sampled", sampled=True)
    dense_vs_paged(torch, pipe, prompts, paged_outs, dense_outs)
    sampled(torch, pipe, pipe_d, prompts)
    log(f"[serve] [serve] to [sampled] took {time.perf_counter() - t0:.1f} s")
    for name, phase in (("serve-preempt", lambda: serve_preempt(torch, card, pipe, prompts,
                                                                paged_outs)),
                        ("overlap", lambda: overlap_phase(torch, card, pipe, pipe_d, prompts)),
                        ("stream", lambda: stream_phase(torch, pipe, prompts, paged_outs)),
                        ("metrics", lambda: trace_phase(torch, pipe, prompts, paged_outs))):
        t0 = time.perf_counter()
        phase()
        log(f"[{name}] phase took {time.perf_counter() - t0:.1f} s")
    runs = {True: (pipe, paged_outs, paged_stats), False: (pipe_d, dense_outs, dense_stats)}
    phase_launches = {}
    # the single device's streams that the tp phases hold their ranks to
    # ([quant]'s arms, [moe-nllb], [audio], [ssm]) and the kernel times at
    # served shapes
    timed, single = {}, {}
    for name, phase in (("spec", lambda: spec_phase(torch, card, prompts, runs)),
                        ("faults", lambda: faults_phase(torch, card, pipe, prompts,
                                                        paged_outs)),
                        ("launch", lambda: launch_phase(card)),
                        ("quant", lambda: quant_phase(torch, card, prompts, pipe, single))):
        t0 = time.perf_counter()
        phase_launches[name] = phase()
        log(f"[{name}] phase took {time.perf_counter() - t0:.1f} s")
    # the MoE, audio and SSM families on one device, before the tp spawn,
    # whose [tp-moe], [tp-audio] and [tp-ssm] hold their ranks to the
    # streams kept in ``single`` and [tp-olmoe] serves [moe]'s prompts;
    # paged attention and qmm timed at their served shapes go into
    # ``timed``
    for name, phase in (("moe", lambda: moe_phase(torch, card, timed, single)),
                        ("audio", lambda: audio_phase(torch, card, timed, single)),
                        ("moe-nllb", lambda: moe_nllb_phase(torch, card, prompts, single)),
                        ("ssm", lambda: ssm_phase(torch, card, timed, single))):
        t0 = time.perf_counter()
        phase_launches[name] = phase()
        log(f"[{name}] phase took {time.perf_counter() - t0:.1f} s")
    # scale-out: TP ranks sharing the card (their own processes), then two
    # routed replicas in this one, both on [serve]'s prompts and weights
    t0 = time.perf_counter()
    tp_kernels = time_tp_kernels(torch, card, dev)
    for e in entries:
        e.update(tp_kernels.get(e["name"], {}))
    tp_lm = tp_lm_inputs(torch, card)
    tp_out = tp_phase(card, prompts, dict(tp_lm, families=single, quant=single["quant"]))
    for tag in ("tp-moe", "tp-olmoe", "tp-audio", "tp-ssm", "tp-hybrid"):
        phase_launches[tag] = tp_out[tag]["launches"]
    phase_launches["tp"] = tp_out["tp"]["launches"]
    phase_launches["tp-dense"] = tp_out["tp-dense"]["launches"]
    phase_launches["tp-lm"] = _add(dict(tp_out["tp-lm"]["launches"]),
                                   tp_out["tp-lm-dense"]["launches"])
    phase_launches["tp-qwen"] = tp_out["tp-qwen"]["launches"]
    phase_launches["tp-quant"] = {}
    for arm, _, _ in TP_QUANT_ARMS:
        _add(phase_launches["tp-quant"], tp_out[f"tp-quant-{arm}"]["launches"])
    phase_launches["tp-spec"] = tp_out["tp-spec"]["launches"]
    phase_launches["tp-faults"] = tp_out["tp-faults"]
    phase_launches["tp-sla"] = tp_out["tp-sla"]
    log(f"[tp] phase took {time.perf_counter() - t0:.1f} s")
    # any tp: three ranks, where 3 divides no width of nllb600m
    t0 = time.perf_counter()
    tp3_out = tp3_phase(card, prompts, {
        "card": card, "serve_streams": [o.token_ids for o in paged_outs],
        "gemma_prompts": tp_lm["gemma_prompts"],
        "gemma_streams": tp_out["tp-lm-dense"]["single_streams"]})
    phase_launches["tp3"] = {}
    for tag in ("tp3", "tp3-dense", "tp3-lm"):
        _add(phase_launches["tp3"], tp3_out[tag]["launches"])
    log(f"[tp3] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_launches["dp"], dp_placed, _ = dp_phase(torch, card, prompts, pipe, paged_outs)
    log(f"[dp] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_launches["dp-tp"] = dp_tp_phase(card, prompts, dp_placed)
    log(f"[dp-tp] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_launches["train"], trained = train_phase(torch, card, dev)
    log(f"[train] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_launches["eval"] = eval_phase(torch, card, trained, dev)
    log(f"[eval] phase took {time.perf_counter() - t0:.1f} s")
    del trained
    torch.cuda.empty_cache()
    api_launches = api_path(torch, pipe_d)
    del pipe, pipe_d, runs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_launches["train-lm"] = train_lm_phase(torch, card, dev)
    log(f"[train-lm] phase took {time.perf_counter() - t0:.1f} s")

    # the decoder-only LMs: the kernels at qwen2.5-14b's served shapes,
    # then one deploy at a time, each freed before the next
    t0 = time.perf_counter()
    lm_kernels = check_lm_kernels(torch, dev)
    for e in entries:
        if e["name"] in lm_kernels:
            e.update(lm_kernels[e["name"]])
            log_time(e, card, "lm_")
    log(f"[lm-kernels] took {time.perf_counter() - t0:.1f} s")
    for name, phase in LM_PHASES + (("hybrid", hybrid_phase),):
        t0 = time.perf_counter()
        phase_launches[name] = phase(torch, card)
        log(f"[{name}] phase took {time.perf_counter() - t0:.1f} s")

    by_run = {**phase_launches["spec"], "faults": phase_launches["faults"],
              "quant": phase_launches["quant"], "train": phase_launches["train"],
              "eval": phase_launches["eval"], "train_lm": phase_launches["train-lm"],
              "lm": phase_launches["lm"],
              "lm_gemma": phase_launches["lm-gemma"], "vlm": phase_launches["vlm"],
              "moe": phase_launches["moe"], "moe_nllb": phase_launches["moe-nllb"],
              "audio": phase_launches["audio"], "ssm": phase_launches["ssm"],
              "hybrid": phase_launches["hybrid"], "tp": phase_launches["tp"],
              "tp_dense": phase_launches["tp-dense"], "dp": phase_launches["dp"],
              "tp_lm": phase_launches["tp-lm"], "tp_qwen": phase_launches["tp-qwen"],
              "tp_moe": phase_launches["tp-moe"], "tp_olmoe": phase_launches["tp-olmoe"],
              "tp_audio": phase_launches["tp-audio"], "tp_ssm": phase_launches["tp-ssm"],
              "tp_hybrid": phase_launches["tp-hybrid"], "tp_quant": phase_launches["tp-quant"],
              "tp_spec": phase_launches["tp-spec"], "dp_tp": phase_launches["dp-tp"],
              "tp_faults": phase_launches["tp-faults"], "tp_sla": phase_launches["tp-sla"],
              "tp3": phase_launches["tp3"]}
    for e in entries:
        if e["name"] == "paged_attn":
            for tag in ("moe", "audio"):
                e.update({f"{tag}_{k}": v for k, v in timed[tag].items()})
        if e["name"] == "qmm":
            e.update(timed["qmm"])
        served = e.setdefault("path", "served") == "served"
        e["launches"] = (launches if served else api_launches)[e["name"]]
        # spec, spec_dense, faults, quant, train, eval, train_lm, lm,
        # lm_gemma, vlm, moe, moe_nllb, audio, ssm, hybrid, tp (rank 0),
        # tp_dense (rank 0), dp, tp_lm (rank 0, paged + dense), tp_qwen,
        # tp_moe, tp_olmoe, tp_audio, tp_ssm, tp_hybrid, tp_quant (the four
        # arms), tp_spec (rank 0), dp_tp (rank 0), tp_faults and tp_sla
        # (rank 0), tp3 (rank 0 of 3: [tp3], [tp3-dense] and [tp3-lm])
        for run, counts in by_run.items():
            e[f"launches_{run}"] = counts[e["name"]]
    log(f"[time] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s")
    log("kernels: " + ", ".join(f"{e['name']}={e['launches']} ({e['path']})"
                                for e in entries))
    log("kernels in [train] / [eval] / [train-lm]: " + ", ".join(
        f"{e['name']}={e['launches_train']} / {e['launches_eval']} / {e['launches_train_lm']}"
        for e in entries))
    log("kernels in [lm] / [lm-gemma] / [vlm]: " + ", ".join(
        f"{e['name']}={e['launches_lm']} / {e['launches_lm_gemma']} / {e['launches_vlm']}"
        for e in entries))
    log("kernels in [moe] / [moe-nllb] / [audio]: " + ", ".join(
        f"{e['name']}={e['launches_moe']} / {e['launches_moe_nllb']} / "
        f"{e['launches_audio']}" for e in entries))
    log("kernels in [ssm] / [hybrid]: " + ", ".join(
        f"{e['name']}={e['launches_ssm']} / {e['launches_hybrid']}" for e in entries))
    log("kernels in [tp] (rank 0 of 2) / [tp-dense] (rank 0 of 2) / [dp]: " + ", ".join(
        f"{e['name']}={e['launches_tp']} / {e['launches_tp_dense']} / {e['launches_dp']}"
        for e in entries))
    log("kernels in [tp-lm] + [tp-lm-dense] (rank 0 of 2) / [tp-qwen] (rank 0 of 2) / "
        "[dp-tp] (rank 0 of 4): " + ", ".join(
            f"{e['name']}={e['launches_tp_lm']} / {e['launches_tp_qwen']} / "
            f"{e['launches_dp_tp']}" for e in entries))
    log("kernels in [tp-moe] / [tp-olmoe] / [tp-audio] (rank 0 of 2): " + ", ".join(
        f"{e['name']}={e['launches_tp_moe']} / {e['launches_tp_olmoe']} / "
        f"{e['launches_tp_audio']}" for e in entries))
    log("kernels in [tp-ssm] / [tp-hybrid] (rank 0 of 2): " + ", ".join(
        f"{e['name']}={e['launches_tp_ssm']} / {e['launches_tp_hybrid']}" for e in entries))
    log("kernels in [tp-quant] (4 arms) / [tp-spec] (rank 0 of 2): " + ", ".join(
        f"{e['name']}={e['launches_tp_quant']} / {e['launches_tp_spec']}" for e in entries))
    log("kernels in [tp-faults] / [tp-sla] (rank 0 of 2): " + ", ".join(
        f"{e['name']}={e['launches_tp_faults']} / {e['launches_tp_sla']}" for e in entries))
    log("kernels in [tp3] + [tp3-dense] + [tp3-lm] (rank 0 of 3): " + ", ".join(
        f"{e['name']}={e['launches_tp3']}" for e in entries))
    keys = ("name", "route", "path", "source", "replaces", "launches", "launches_spec",
            "launches_spec_dense", "launches_faults", "launches_quant", "launches_train",
            "launches_eval", "launches_train_lm", "launches_lm", "launches_lm_gemma", "launches_vlm",
            "launches_moe", "launches_moe_nllb", "launches_audio", "launches_ssm",
            "launches_hybrid", "launches_tp", "launches_tp_dense", "launches_dp",
            "launches_tp_lm", "launches_tp_qwen", "launches_tp_moe", "launches_tp_olmoe",
            "launches_tp_audio", "launches_tp_ssm", "launches_tp_hybrid", "launches_tp_quant",
            "launches_tp_spec", "launches_dp_tp", "launches_tp_faults", "launches_tp_sla",
            "launches_tp3",
            "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
            "library_device_ms", "unfused_ms", "unfused_device_ms", "work")
    print(json.dumps({"kernels": [{k: v for k, v in e.items()
                                   if k in keys or k.startswith(("prefill_", "lm_", "moe_",
                                                                 "audio_", "ssm_", "tp_"))}
                                  for e in entries]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
