"""The split plan of the dense decode-attention kernel (``decode_attn_plan``)
held on the CPU: its invariants, a plain-torch emulation of the kernel's
split-and-merge (partials per live split, merged in split order) at the
plan's boundaries against the JAX kernel (Pallas interpret mode), and the
build hash that names a kernel library by its source and the shared
header."""

import math
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attn import (MIN_TOKENS, SMEM_LIMIT,  # noqa: E402
                                             decode_attn_plain, decode_attn_plan)
from repro_torch.kernels.split_attn import TARGET_TOKENS, smem_bytes  # noqa: E402

SMS = build.H100_SMS

# (B, Hkv, G, d, S): the served self and cross reads, the wrapper's GQA
# shapes (G = 4 with d = 128, G = 5 with d = 64, G = 1 and 4 with d = 64)
# at every S it takes, and a batch wide enough for one split a row
PLAN_SHAPES = ([(8, 16, 1, 64, 128), (8, 16, 1, 64, 256), (8, 16, 1, 64, 64)]
               + [(B, Hkv, G, d, S) for B, Hkv, G, d in ((2, 1, 4, 128), (2, 2, 5, 64),
                                                        (2, 16, 1, 64), (4, 2, 4, 64))
                  for S in (32, 64, 128, 256, 384)]
               + [(64, 16, 1, 64, 256), (6, 2, 5, 64, 200), (3, 2, 2, 64, 0)])


@pytest.mark.parametrize("B,Hkv,G,d,S", PLAN_SHAPES)
def test_decode_attn_plan_invariants(B, Hkv, G, d, S):
    plan = decode_attn_plan(B, Hkv, G, d, S)
    T = plan.tokens_per_split
    assert plan.grid == (B, Hkv, plan.splits)
    # the splits cover [0, S), none wholly past S
    assert plan.splits * T >= S and (S == 0 or (plan.splits - 1) * T < S)
    assert MIN_TOKENS <= T <= TARGET_TOKENS
    # one split's K, V and scales fit one batch of copies into shared memory
    assert plan.smem_bytes == smem_bytes(T, G, d, 1) <= SMEM_LIMIT
    # two blocks per SM wherever S allows at the shortest split
    if B * Hkv * math.ceil(S / MIN_TOKENS) >= 2 * SMS:
        assert B * Hkv * plan.splits >= 2 * SMS
    if (B, Hkv, G, d) == (8, 16, 1, 64) and S >= 128:
        assert plan.splits > 1 and B * Hkv * plan.splits >= 2 * 132
    one = plan.splits == 1
    assert plan.workspace_elems == (0 if one else B * Hkv * plan.splits * G * (d + 2))
    assert plan.counters == (0 if one else B * Hkv)


@pytest.mark.parametrize("d", [64, 128])
def test_decode_attn_plan_takes_every_group_the_tiled_kernel_took(d):
    """Every G that the one-block-per-row kernel fitted in 48 KB (q, acc and
    a 64-token score tile per query head) still gets a plan."""
    most = max(G for G in range(1, 512) if 4 * (2 * G * d + G * 64 + 3 * G) <= 48 * 1024)
    for G in range(1, most + 1):
        plan = decode_attn_plan(2, 2, G, d, 384)
        assert plan.smem_bytes <= SMEM_LIMIT and plan.tokens_per_split >= 1


def test_decode_attn_plan_refuses_what_the_kernel_cannot_copy():
    with pytest.raises(ValueError, match="16-byte"):
        decode_attn_plan(1, 1, 1, 24, 64)
    with pytest.raises(ValueError, match="shared memory"):
        decode_attn_plan(1, 1, 400, 128, 64)


# ---------------------------------------------------------------------------
# split-and-merge emulation
# ---------------------------------------------------------------------------

def _dense_split_emulation(q, kc, ks, vc, vs, lens, sm_scale, plan):
    """The kernel's arithmetic in plain torch: each live split's f32 max,
    denominator and accumulator over its tokens, merged in split order in
    one online pass (one live split writes directly). Returns (out, the
    tokens read per row, splits skipped as wholly past the length)."""
    B, Hkv, G, d = q.shape
    S, T = kc.shape[1], plan.tokens_per_split
    out = torch.zeros((B, Hkv, G, d))
    read, skipped = [set() for _ in range(B)], 0
    for b in range(B):
        L = min(max(int(lens[b]), 0), S)
        parts = []
        for z in range(plan.splits):
            if z * T >= L:
                skipped += 1
                continue
            toks = torch.arange(z * T, min(L, (z + 1) * T))
            read[b].update(toks.tolist())
            k = kc[b, toks].float() * ks[b, toks][..., None]
            v = vc[b, toks].float() * vs[b, toks][..., None]
            s = torch.einsum("hgd,thd->hgt", q[b].float(), k) * sm_scale
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("hgt,thd->hgd", p, v)))
        if len(parts) == 1:
            m, den, acc = parts[0]
        elif parts:                                   # one online pass, in split order
            mx = torch.full((Hkv, G), -1e30)
            den, acc = torch.zeros((Hkv, G)), torch.zeros((Hkv, G, d))
            for m, l, a in parts:
                mn = torch.maximum(mx, m)
                keep, w = torch.exp(mx - mn), torch.exp(m - mn)
                den = den * keep + l * w
                acc = acc * keep[..., None] + a * w[..., None]
                mx = mn
        else:
            continue
        out[b] = acc / torch.clamp(den, min=1e-30)[..., None]
    return out, read, skipped


# (sms, S): T = 16 (the H100's SMs, a narrow batch) and T = 64 (a plan for
# 4 SMs), both at an S that is not a multiple of T
@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("sms,S", [(SMS, 200), (4, 200)])
def test_decode_attn_split_merge_emulation(sms, S, G):
    B, Hkv, d = 6, 2, 64
    H = G * Hkv
    plan = decode_attn_plan(B, Hkv, G, d, S, sms)
    T = plan.tokens_per_split
    assert S % T and plan.splits > 2
    lengths = [0, 1, T - 1, T, T + 1, S]
    rng = np.random.default_rng(30 + G + T)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kc, ks = jops.quantize_kv(jnp.asarray(rng.standard_normal((B, S, Hkv, d)), jnp.float32))
    vc, vs = jops.quantize_kv(jnp.asarray(rng.standard_normal((B, S, Hkv, d)), jnp.float32))
    lens = np.asarray(lengths, np.int32)
    out_jax = np.asarray(jops.decode_attention(jnp.asarray(q), kc, ks, vc, vs,
                                               jnp.asarray(lens), out_dtype=jnp.float32))

    t = [torch.from_numpy(np.array(a)) for a in (q, kc, ks, vc, vs, lens)]
    qg = t[0].reshape(B, Hkv, G, d)
    emu, read, skipped = _dense_split_emulation(qg, *t[1:], d ** -0.5, plan)
    plain = decode_attn_plain(qg, *t[1:], d ** -0.5).reshape(B, H, d).numpy()
    emu = emu.reshape(B, H, d).numpy()
    assert float(np.max(np.abs(emu - out_jax))) <= 1e-5
    assert float(np.max(np.abs(emu - plain))) <= 1e-5
    # no token at or past a length was read; the live splits are exactly
    # those that start before it; the idle row is exactly 0
    assert all(r == set(range(n)) for r, n in zip(read, lengths))
    assert skipped == B * plan.splits - sum(math.ceil(n / T) for n in lengths)
    assert np.all(emu[0] == 0.0)


# ---------------------------------------------------------------------------
# the build hash
# ---------------------------------------------------------------------------

def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """A library is named by the hash of its source and of the headers it
    includes: an edit to attend_split.cuh renames both attention libraries
    and not qmm's, which does not include it; an edit to one kernel's
    source renames that library alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build._CSRC, csrc)
    monkeypatch.setattr(build, "_CSRC", csrc)
    names = ("decode_attn", "paged_attn", "qmm")
    before = {n: build.library_path(n) for n in names}
    assert before == {n: build.library_path(n) for n in names}
    header = csrc / "attend_split.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert after["decode_attn"] != before["decode_attn"]
    assert after["paged_attn"] != before["paged_attn"]
    assert after["qmm"] == before["qmm"]
    src = csrc / "decode_attn.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {n: build.library_path(n) for n in names}
    assert again["decode_attn"] != after["decode_attn"]
    assert again["paged_attn"] == after["paged_attn"] and again["qmm"] == after["qmm"]
