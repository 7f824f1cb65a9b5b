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
   could take;
3. full-width NLLB-600M, int4 weights, int8 embedding, paged int8 KV:
   deploy(paged=True) serves 8 requests through the kernels, with every
   launch counter set to 0 just before and read just after ([serve]);
4. one decode step of the served engine state through the "kernels" and
   the "torch" route bundles: logits agree within the reference engine's
   int8-KV bound ([routes]);
5. where one decode micro-step's time goes (torch.profiler);
6. deploy() with its defaults (the dense int8 KV engine) serves the same
   8 requests on the same weights ([serve-dense]), profiled as in 5,
   greedy and sampled; its greedy streams equal the paged engine's, or
   part only at a near tie ([dense-vs-paged]);
7. seeded temperature / top-p requests on both engines: in the
   vocabulary, repeatable, and dense equal to paged up to near ties
   ([sampled]);
8. the ops API path of the dense decode attention and the row softmax,
   driven on the dense engine's live caches and logits, with the launch
   counters set to 0 just before and read just after ([api]);
9. a launch-count line, the kernels' JSON line, the card line, and last
   {"ok": true, "device": {...}}.

It needs a CUDA device and the repository's ``src/repro_torch``; without
either it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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
    (host gaps between launches left out). None where the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / reps if total > 0 else None


def times(kernel, plain, library, plain_reps: int = 5) -> dict:
    """CUDA-event times of the kernel, its plain version and the library
    call (host gaps inside the window included), and the device-only
    times of the kernel and the library call."""
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain, reps=plain_reps),
            "library_ms": cuda_ms(library), "device_ms": device_ms(kernel),
            "library_device_ms": device_ms(library)}


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


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
             + [(m, k, n, 64) for k, n in QMM_SERVED_KN for m in (1, 8, 64, 512)])


def check_qmm(torch, dev):
    from repro_torch.core.qtensor import QTensor
    from repro_torch.kernels import ops
    from repro_torch.kernels.qmm import qmm_plain, qmm_plan

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    regimes = set()
    for fmt in ("int4", "fp4", "nf4", "int8", "fp8"):
        for m, k, n, block in QMM_CASES:
            w = torch.randn((k, n), generator=g, device=dev) * 0.05
            qt = QTensor.quantize(w, fmt, block, double_quant=(fmt == "nf4"))
            x = torch.randn((m, k), generator=g, device=dev)
            plan = qmm_plan(m, n, k, block, fmt)
            regimes.add((plan.regime, plan.splits > 1))
            for x_dt, out_dt in ((torch.float32, torch.float32),
                                 (torch.bfloat16, torch.bfloat16)):
                xi = x.to(x_dt)
                y = ops.qmm(xi, qt, compute_dtype=out_dt)
                again = ops.qmm(xi, qt, compute_dtype=out_dt)
                where = f"qmm {fmt} M={m} K={k} N={n} sub_block={block} {out_dt} ({plan})"
                # the split-K partials are summed in split order by the
                # tile's last block: reruns are bit-identical
                if not torch.equal(y, again):
                    raise AssertionError(f"{where}: two launches differ")
                y = y.float()
                p = qmm_plain(xi, qt.data, qt.block_scales(), fmt, out_dtype=out_dt).float()
                rel = float((y - p).norm() / (p.norm() + 1e-9))
                # f32 out: same bf16 rounding points, only the f32 sum
                # order differs (CPU test bound). bf16 out: the two f32
                # sums round to bf16 independently, at most one bf16 ulp
                # (2^-8 relative) apart element by element.
                tol = 1e-5 if out_dt == torch.float32 else 4e-3
                if not (rel <= tol and bool(torch.isfinite(y).all())):
                    raise AssertionError(f"{where}: rel err {rel:.3g} > {tol}")
                if out_dt == torch.float32 and (k, n) in QMM_SERVED_KN:
                    worst = max(worst, float((y - p).abs().max()))
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

    def window(ws, m):
        """kernel, plain and library calls over the int4 weights ``ws`` at
        M = m bf16 rows, and the bound of that work"""
        xs = {k: torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
              for k in (1024, 8192)}
        dense = [qt.dequantize(torch.bfloat16) for qt in ws]
        scales = [qt.block_scales() for qt in ws]

        def run_kernel():
            for qt in ws:
                ops.qmm(xs[qt.shape[0]], qt, compute_dtype=torch.bfloat16)

        def run_plain():
            for qt, s in zip(ws, scales):
                qmm_plain(xs[qt.shape[0]], qt.data, s, "int4", out_dtype=torch.bfloat16)

        def run_library():
            for qt, wd in zip(ws, dense):
                torch.matmul(xs[qt.shape[0]], wd)

        nbytes = flops = 0
        for qt in ws:
            k, n = qt.shape
            nbytes += m * k * 2 + k * n // 2 + (k // 64) * n * 4 + m * n * 2
            flops += 2 * m * k * n
        return (run_kernel, run_plain, run_library), bound_ms(nbytes, flops, BF16_FLOPS_PER_MS)

    fns, (t, by) = window(weights, SLOTS)
    entry = {"name": "qmm", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/qmm.cu",
             "replaces": "src/repro/kernels/qmm.py:85",
             "max_abs_err": worst, **times(*fns), "bound_ms": t, "bound_by": by}
    # prefill rows: one launch on each served (K, N) shape, at the dense
    # engine's 64-row admission and a batched 512-row one
    firsts = [weights[0], weights[6], weights[7]]
    for m in (64, 512):
        fns, (t, by) = window(firsts, m)
        for key, val in times(*fns).items():
            entry.setdefault(f"prefill_{key}", {})[f"M={m}"] = val
        entry.setdefault("prefill_bound_ms", {})[f"M={m}"] = t
        entry.setdefault("prefill_bound_by", {})[f"M={m}"] = by
    entry["work"] = (f"one decode step: 48 int4 launches at M={SLOTS} (36 of 1024x1024, "
                     "6 of 1024x8192, 6 of 8192x1024); prefill: one int4 launch on each "
                     "of 1024x1024, 1024x8192, 8192x1024 at M=64 and at M=512")
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


def check_paged_attn(torch, dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attn import paged_attn_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = 0.0

    def case(B, H, Hkv, d, P, ps, maxp, lengths, kind, q_dt=torch.float32):
        kc, ks, vc, vs = _pool(torch, g, dev, P, ps, Hkv, d, kind)
        perm = 1 + torch.randperm(P - 1, generator=g, device=dev)
        tables = perm[:B * maxp].reshape(B, maxp).to(torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = torch.randn((B, H, d), generator=g, device=dev).to(q_dt)
        out = ops.paged_decode_attention(q, kc, vc, tables, lens, k_scales=ks,
                                         v_scales=vs, out_dtype=torch.float32)
        ref = paged_attn_plain(q.reshape(B, Hkv, H // Hkv, d), kc, ks, vc, vs,
                               tables, lens, d ** -0.5).reshape(B, H, d)
        err = float((out - ref).abs().max())
        if not err < 1e-5:
            raise AssertionError(f"paged_attn {kind} B={B} H={H} Hkv={Hkv} d={d}: "
                                 f"max abs err {err:.3g}")
        return err

    for kind in ("int8", "fp8", "bf16"):
        for H, Hkv, d in [(8, 2, 64), (4, 1, 128), (16, 16, 64), (10, 2, 64)]:
            case(2, H, Hkv, d, 17, 16, 4, [64, 33], kind)
        case(4, 8, 2, 64, 33, 8, 4, [32, 1, 17, 29], kind)
        case(3, 4, 2, 64, 9, 8, 2, [0, 5, 16], kind)
        lens = torch.randint(1, 257, (SLOTS,), generator=g, device=dev).tolist()
        worst = max(worst, case(SLOTS, 16, 16, 64, SLOTS * 16 + 1, 16, 16, lens,
                                kind, torch.bfloat16))

    # poisoned trash page: out-of-chain entries name page 0, whose
    # contents must not change one output bit
    kc, ks, vc, vs = _pool(torch, g, dev, 5, 8, 2, 64, "int8")
    q = torch.randn((1, 4, 64), generator=g, device=dev)
    tbl = torch.tensor([[1, 0, 0, 0]], dtype=torch.int32, device=dev)
    lens = torch.tensor([8], dtype=torch.int32, device=dev)
    base = ops.paged_decode_attention(q, kc, vc, tbl, lens, k_scales=ks, v_scales=vs,
                                      out_dtype=torch.float32)
    kc[0], vc[0], ks[0], vs[0] = 127, -127, 1e3, 1e3
    poisoned = ops.paged_decode_attention(q, kc, vc, tbl, lens, k_scales=ks,
                                          v_scales=vs, out_dtype=torch.float32)
    if not torch.equal(base, poisoned):
        raise AssertionError("paged_attn: the poisoned trash page changed the output")
    log(f"[kernels] paged_attn: int8/fp8/bf16 pages agree with paged_attn_plain "
        f"(< 1e-5); trash page unobservable; max abs err at the served shape {worst:.3g}")

    # the served shape: B=slots, Hkv=16, G=1, d=64, ps=16, int8 pages,
    # ragged lengths up to 256; one decode step = 6 launches (one a layer)
    B, H, d, ps, maxp = SLOTS, 16, 64, 16, 16
    lens = torch.randint(1, 257, (B,), generator=g, device=dev)
    pools = [_pool(torch, g, dev, B * maxp + 1, ps, H, d, "int8") for _ in range(6)]
    tables = (1 + torch.arange(B * maxp, device=dev)).reshape(B, maxp).to(torch.int32)
    q = torch.randn((B, H, d), generator=g, device=dev).to(torch.bfloat16)
    lens32 = lens.to(torch.int32)

    def run_kernel():
        for kc, ks, vc, vs in pools:
            ops.paged_decode_attention(q, kc, vc, tables, lens32, k_scales=ks,
                                       v_scales=vs, out_dtype=torch.float32)

    def run_plain():
        for kc, ks, vc, vs in pools:
            paged_attn_plain(q.reshape(B, H, 1, d), kc, ks, vc, vs, tables, lens32,
                             d ** -0.5)

    # library yardstick: SDPA on K/V already gathered dense (the gather
    # and dequantization are left out of its time)
    S = maxp * ps
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    dense = [(torch.randn((B, H, S, d), generator=g, device=dev).to(torch.bfloat16),
              torch.randn((B, H, S, d), generator=g, device=dev).to(torch.bfloat16))
             for _ in range(6)]
    q4 = q[:, :, None, :]

    def run_library():
        for k, v in dense:
            torch.nn.functional.scaled_dot_product_attention(q4, k, v, attn_mask=mask)

    tokens = int(lens.sum())
    nbytes = 6 * (B * H * d * 2 + tokens * H * (2 * d + 2 * 4) + B * maxp * 4
                  + B * 4 + B * H * d * 4)
    flops = 6 * 4 * tokens * H * d
    t, by = bound_ms(nbytes, flops, F32_FLOPS_PER_MS)
    return {"name": "paged_attn", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
            "replaces": "src/repro/kernels/paged_attn.py:105",
            "max_abs_err": worst, **times(run_kernel, run_plain, run_library),
            "bound_ms": t, "bound_by": by,
            "work": f"one decode step: 6 launches, B={B} Hkv=16 G=1 d=64 ps=16 "
                    f"int8 pages, {tokens} cached tokens (lengths 1..256)"}


def check_fasst(torch, dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels.fasst import MODES, fasst_act_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    worst = 0.0
    for shape in ((37, 100), (SLOTS, 8192)):
        x = torch.randn(shape, generator=g, device=dev) * 3
        for mode in MODES:
            for dt in (torch.float32, torch.bfloat16):
                xi = x.to(dt)
                y = ops.fasst(xi, mode).float()
                p = fasst_act_plain(xi, mode).float()
                err = (y - p).abs()
                # f32: the CPU test bound. bf16 out: the two f32 results
                # may round to adjacent bf16 values: one bf16 ulp, at most
                # 2^-7 of the value, beside the CPU test's 2e-2.
                tol = 1e-5 if dt == torch.float32 else torch.clamp(
                    p.abs() * 2.0 ** -7, min=2e-2)
                if not bool((err <= tol).all()):
                    raise AssertionError(f"fasst {mode} {dt} {shape}: max abs err "
                                         f"{float(err.max()):.3g}")
                if dt == torch.bfloat16 and shape[1] == 8192 and mode == "relu":
                    worst = float(err.max())
    log("[kernels] fasst_act: 8 modes x (f32, bf16) agree with fasst_act_plain")

    # one decode step: 6 FFN relu launches on (slots, 8192) bf16
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
            "work": f"one decode step: 6 relu launches on ({SLOTS}, 8192) bf16"}


def _int8_cache(torch, g, dev, B, S, Hkv, d):
    from repro_torch.kernels import ops
    kc, ks = ops.quantize_kv(torch.randn((B, S, Hkv, d), generator=g, device=dev))
    vc, vs = ops.quantize_kv(torch.randn((B, S, Hkv, d), generator=g, device=dev))
    return kc, ks, vc, vs


def check_decode_attn(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attn import decode_attn_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    def case(B, H, Hkv, d, S, lengths, q_dt=torch.float32):
        kc, ks, vc, vs = _int8_cache(torch, g, dev, B, S, Hkv, d)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = torch.randn((B, H, d), generator=g, device=dev).to(q_dt)
        out = ops.decode_attention(q, kc, ks, vc, vs, lens, out_dtype=torch.float32)
        ref = decode_attn_plain(q.reshape(B, Hkv, H // Hkv, d), kc, ks, vc, vs, lens,
                                d ** -0.5).reshape(B, H, d)
        err = float((out - ref).abs().max())
        if not err < 1e-5:
            raise AssertionError(f"decode_attn B={B} H={H} Hkv={Hkv} d={d} S={S}: "
                                 f"max abs err {err:.3g}")
        if not bool((out[lens == 0] == 0).all()):
            raise AssertionError("decode_attn: a zero-length row is not exactly zero")
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
    log(f"[kernels] decode_attn: GQA (8,2,64) (4,1,128) (16,16,64) (10,2,64), ragged "
        f"S=384, a zero-length row and the served shapes (self S={MAX_LEN}, cross "
        f"S={enc_len} and 64) agree with decode_attn_plain (< 1e-5); max abs err at "
        f"the served shapes {worst:.3g}")

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
                    f"{tokens} valid cached tokens read (plain and SDPA read all S)"}


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
    from repro_torch.kernels.fasst import fasst_softmax_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    worst = (0.0, 0.0)
    vocab = (SLOTS, 256204)
    for shape in ((8, 64), (33, 100), (1, 128), (128, 128), vocab):
        x = torch.randn(shape, generator=g, device=dev) * 5
        for valid in (-1, shape[1] // 3, shape[1] + 7):
            y = ops.fasst_softmax(x, scale=0.7, valid_cols=valid)
            p = fasst_softmax_plain(x, scale=0.7, valid_cols=valid)
            err, rel = softmax_err(y, p)
            vc = shape[1] if valid < 0 else min(valid, shape[1])
            if not (err <= 1e-6 and rel <= 1.0) or not bool((y[:, vc:] == 0).all()):
                raise AssertionError(f"fasst_softmax {shape} valid_cols={valid}: max abs "
                                     f"err {err:.3g}, relative-bound share {rel:.3g}, "
                                     f"masked columns zero {bool((y[:, vc:] == 0).all())}")
            if shape == vocab and valid == -1:
                worst = (err, rel)
        yb = ops.fasst_softmax(x, scale=0.7, out_dtype=torch.bfloat16).float()
        pb = fasst_softmax_plain(x, scale=0.7, out_dtype=torch.bfloat16).float()
        # the two f32 results may round to adjacent bf16 values: one ulp
        if not bool(((yb - pb).abs() <= pb.abs() * 2.0 ** -7).all()):
            raise AssertionError(f"fasst_softmax {shape} bf16: more than one ulp apart")
    log(f"[kernels] fasst_softmax: (8,64) (33,100) (1,128) (128,128) {vocab}, full, "
        f"masked and clamped valid_cols, agree with fasst_softmax_plain (<= 1e-6 abs "
        f"and {SOFTMAX_RTOL:g} * |p| + {SOFTMAX_FLOOR:g} per entry in f32, masked "
        f"columns exactly 0, one ulp in bf16); on the vocabulary rows max abs err "
        f"{worst[0]:.3g}, largest |y - p| / ({SOFTMAX_RTOL:g} |p| + {SOFTMAX_FLOOR:g}) "
        f"{worst[1]:.3g}")

    # the sampler's shape: a temperature softmax over the vocabulary for
    # every slot, f32 logits in, f32 probabilities out
    x = torch.randn(vocab, generator=g, device=dev) * 5
    xs = x * 0.7
    small = torch.randn((128, 128), generator=g, device=dev)
    small_ms = (cuda_ms(lambda: ops.fasst_softmax(small)),
                cuda_ms(lambda: torch.softmax(small, dim=-1)))
    log(f"[kernels] fasst_softmax at (128, 128) f32: kernel {small_ms[0]:.4f} ms, "
        f"torch.softmax {small_ms[1]:.4f} ms")
    nbytes = 2 * x.numel() * 4
    t, by = bound_ms(nbytes, 4 * x.numel(), F32_FLOPS_PER_MS)
    return {"name": "fasst_softmax", "route": "triton", "path": "ops API",
            "source": "src/repro_torch/kernels/fasst.py",
            "replaces": "src/repro/kernels/fasst.py:95",
            "max_abs_err": worst[0],
            **times(lambda: ops.fasst_softmax(x, scale=0.7),
                    lambda: fasst_softmax_plain(x, scale=0.7),
                    lambda: torch.softmax(xs, dim=-1), plain_reps=20),
            "bound_ms": t, "bound_by": by,
            "work": f"one launch on {vocab} f32 logits, scale 0.7 (torch.softmax "
                    "timed on logits scaled beforehand)"}


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
    for name in ("decode_steps", "decode_syncs", "prefill_calls"):
        setattr(eng, name, 0)
    eng.prefill_s = eng.decode_s = 0.0
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
    # per decode step and layer: self q,k,v,o + cross q,o + ffn in,out;
    # the dense engine reads its self-attention cache in torch, as the
    # reference does through XLA
    L = pipe.cfg.num_layers
    per_step = {"qmm": 8 * L, "fasst_act": L}
    if paged:
        per_step["paged_attn"] = L
    elif launches["paged_attn"]:
        raise AssertionError("the dense engine launched the paged-attention kernel")
    for name, n in per_step.items():
        if launches[name] < n * steps or launches[name] == 0:
            raise AssertionError(f"{name}: {launches[name]} launches < {n} x {steps} "
                                 "decode steps")
    tokens = sum(len(o.token_ids) for o in outs)
    stats = {"requests": len(outs), "tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall, "decode_steps": steps,
             "decode_syncs": eng.decode_syncs,
             "decode_ms_per_step": 1e3 * eng.decode_s / max(steps, 1),
             "prefill_calls": eng.prefill_calls,
             "prefill_ms_per_call": 1e3 * eng.prefill_s / max(eng.prefill_calls, 1),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches, "card": card}
    log(f"[{tag}] " + json.dumps(stats))
    log(f"[{tag}] first stream: {outs[0].token_ids[:12]} ...")
    return pipe, launches, prompts, outs


def _check_vocab(pipe, outs):
    if any(not 0 <= t < pipe.cfg.vocab_size for o in outs for t in o.token_ids):
        raise AssertionError("a token outside the vocabulary")


def routes_agree(torch, pipe, prompts):
    """One decode step of a live engine state through both bundles."""
    from repro_torch.models import Ctx
    from repro_torch.serving import SamplingParams
    eng = pipe.engine
    for p in prompts:
        eng.submit(p, SamplingParams(max_new_tokens=GEN))
    eng.step(horizon=4)
    eng.step(horizon=4)
    active = [s.id for s in eng.slots if s.active]
    if not active:
        raise AssertionError("no active slot to compare routes on")
    kern = Ctx(compute_dtype=torch.bfloat16, matmul_impl="kernel",
               paged_attn_impl="kernel", use_fasst_kernel=True)
    plain = Ctx(compute_dtype=torch.bfloat16)
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
        raise AssertionError(f"kernel and torch routes differ by {err:.3g} >= 0.3")
    # greedy argmax must agree wherever the top-2 margin exceeds twice the
    # routes' largest logit difference (closer calls are ties at this
    # precision, and random weights make some)
    top2 = lt.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * err
    same = lk.argmax(-1) == lt.argmax(-1)
    if not bool(same[decided].all()):
        raise AssertionError(f"argmax differs between routes on a slot with margin > "
                             f"2 x {err:.3g}: margins {margin.tolist()}, same {same.tolist()}")
    log(f"[routes] kernels vs torch bundle on {len(active)} live slots: max |logit "
        f"diff| {err:.4g} (< 0.3); argmax equal on {int(same.sum())}/{len(active)} "
        f"slots, required on the {int(decided.sum())} with top-2 margin > {2 * err:.3g}")
    eng.run_until_drained()
    eng.allocator.check()


def profile_decode(torch, pipe, prompts, tag="profile", sampled=False):
    """Where a decode micro-step's time goes: torch.profiler over one
    4-step horizon of the served engine with 8 live slots, greedy or
    sampled (temperature 0.7, top-p 0.9)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import SamplingParams
    eng = pipe.engine
    for i, p in enumerate(prompts):
        knobs = dict(temperature=0.7, top_p=0.9, seed=100 + i) if sampled else {}
        eng.submit(p, SamplingParams(max_new_tokens=GEN, **knobs))
    eng.step(horizon=1)                       # admit all 8, one step
    torch.cuda.synchronize()
    K = 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(horizon=K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_drained()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and getattr(e, "self_device_time_total", 0) > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        log(f"[{tag}] the profiler recorded no device time: not measured")
        return
    log(f"[{tag}] {K} decode micro-steps, 8 live slots: host wall {wall_ms / K:.3f} ms "
        f"per step, device busy {busy_ms / K:.3f} ms per step "
        f"(idle share {1 - busy_ms / wall_ms:.3f}), "
        f"{sum(e.count for e in kernels) / K:.0f} kernel launches per step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3 / K:8.4f} ms/step "
            f"x{e.count / K:5.1f}  {e.key[:100]}")


def _fresh_engine(pipe, paged: bool):
    """An idle engine of the given layout on ``pipe``'s model and weights."""
    from repro_torch.serving import ServeEngine
    return ServeEngine(pipe.model, pipe.params, slots=SLOTS, max_len=MAX_LEN,
                       kv_dtype=pipe.engine.kv_dtype, ctx=pipe.ctx, paged=paged,
                       page_size=PAGE, horizon=HORIZON, device=pipe.engine.device)


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


def near_tie_partings(torch, tag, pipe, prompts, sps, paged_streams, dense_streams):
    """Where a dense and a paged stream part, show that the step was a
    near tie. Both layouts replay the common prefix teacher-forced in
    fresh engines of the same slots. At a greedy slot's parting step the
    top-2 margin of the paged engine's logits must be at most twice the
    engines' largest logit difference at that step. A sampled slot's
    draws are replayed from its key: either both tokens pass both
    engines' filters and their Gumbel-max margin is at most twice the
    difference over the temperature, or one sits on the top-k / top-p
    edge within what that difference can move. Returns the parting
    steps."""
    from repro_torch import random as prng
    from repro_torch.serving.sampler import filter_logits

    part = {}
    for i, (a, b) in enumerate(zip(paged_streams, dense_streams)):
        j = next((t for t in range(min(len(a), len(b))) if a[t] != b[t]), None)
        if j is None and len(a) != len(b):
            raise AssertionError(f"[{tag}] request {i}: streams of {len(a)} and "
                                 f"{len(b)} tokens share every token")
        if j == 0:
            raise AssertionError(f"[{tag}] request {i}: the prefill tokens differ")
        if j is not None:
            part[i] = j
    steps = max(list(part.values()) + [3])
    engines = [_fresh_engine(pipe, paged) for paged in (True, False)]
    with torch.no_grad():
        for eng in engines:
            for p, sp in zip(prompts, sps):
                eng.submit(p, sp)
            eng._admit_pending()
            if [s.request.id for s in eng.slots] != list(range(len(prompts))):
                raise AssertionError(f"[{tag}] admission placed requests out of order")
        dev = engines[0].device
        forced = torch.tensor([t[:steps] for t in paged_streams], dtype=torch.int32,
                              device=dev)
        knobs = [torch.tensor([getattr(sp, k) for sp in sps], dtype=dt, device=dev)
                 for k, dt in (("temperature", torch.float32), ("top_k", torch.int64),
                               ("top_p", torch.float32))]
        for j in range(1, steps + 1):
            lgs = []
            for eng in engines:
                eng.cache, lg = eng.model.decode_step(eng.ctx, eng.params,
                                                      forced[:, j - 1:j], eng.cache)
                lgs.append(lg[:, -1].float())
            lp, ld = lgs
            err = float((lp - ld).abs().max())
            parting = [i for i, pj in part.items() if pj == j]
            if any(not sps[i].greedy for i in parting):
                # filter the whole batch, as the engines' sampler does
                fp, fd = (filter_logits(lg, *knobs) for lg in (lp, ld))
            for i in parting:
                sp, a, b = sps[i], paged_streams[i][j], dense_streams[i][j]
                where = f"[{tag}] request {i} parts at token {j} ({a} vs {b})"
                # the routes' int8-KV bound of [routes] holds here too
                if not err < 0.3:
                    raise AssertionError(f"{where}: the engines' logits differ by "
                                         f"{err:.3g} >= 0.3")
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
        eng.decode_steps, eng.decode_s = 0, 0.0
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


def api_path(torch, pipe):
    """The ops API path of the two kernels that no serving path launches:
    ``ops.decode_attention`` on every layer's self and cross int8 caches
    of the dense engine with 8 live slots, and ``ops.fasst_softmax`` as
    the sampler's temperature softmax over the engine's next-token
    logits. Counters are set to 0 just before and read just after."""
    from repro_torch.data import LANG_CODES
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attn import decode_attn_plain
    from repro_torch.kernels.fasst import fasst_softmax_plain
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
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    for name, n in (("decode_attn", 2 * cfg.num_layers), ("fasst_softmax", 1)):
        if launches[name] != n:
            raise AssertionError(f"[api] {name}: {launches[name]} launches, expected {n}")
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
        f"fasst_softmax_plain")
    eng.run_until_drained()
    return launches


def main() -> int:
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

    entries = [check_qmm(torch, dev), check_paged_attn(torch, dev), check_fasst(torch, dev),
               check_decode_attn(torch, dev), check_fasst_softmax(torch, dev)]
    for e in entries:
        log(f"[time] {e['name']}: kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
            f"library {e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}); device only: kernel {fmt_ms(e['device_ms'])}, library "
            f"{fmt_ms(e['library_device_ms'])} — {e['work']}")
    q = entries[0]
    for m in q["prefill_ms"]:
        log(f"[time] qmm prefill {m}: kernel {q['prefill_ms'][m]:.4f} ms, plain "
            f"{q['prefill_plain_ms'][m]:.4f} ms, library {q['prefill_library_ms'][m]:.4f} "
            f"ms, bound {q['prefill_bound_ms'][m]:.4f} ms ({q['prefill_bound_by'][m]}); "
            f"device only: kernel {fmt_ms(q['prefill_device_ms'][m])}, library "
            f"{fmt_ms(q['prefill_library_device_ms'][m])}")
    torch.cuda.empty_cache()

    pipe, launches, prompts, paged_outs = serve(torch, card, paged=True)
    routes_agree(torch, pipe, prompts)
    profile_decode(torch, pipe, prompts)
    pipe_d, _, _, dense_outs = serve(torch, card, paged=False, params=pipe.params)
    profile_decode(torch, pipe_d, prompts, "profile-dense")
    profile_decode(torch, pipe_d, prompts, "profile-dense-sampled", sampled=True)
    dense_vs_paged(torch, pipe, prompts, paged_outs, dense_outs)
    sampled(torch, pipe, pipe_d, prompts)
    api_launches = api_path(torch, pipe_d)

    for e in entries:
        served = e.setdefault("path", "served") == "served"
        e["launches"] = (launches if served else api_launches)[e["name"]]
    log("kernels: " + ", ".join(f"{e['name']}={e['launches']} ({e['path']})"
                                for e in entries))
    keys = ("name", "route", "path", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
            "library_device_ms", "work")
    print(json.dumps({"kernels": [{k: v for k, v in e.items()
                                   if k in keys or k.startswith("prefill_")}
                                  for e in entries]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
