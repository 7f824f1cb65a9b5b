"""The split plans of the paged-attention kernel (``paged_attn_plan``) and
the row softmax (``softmax_plan``), held on the CPU: their invariants, and
a plain-torch emulation of each kernel's split-and-merge (partials per
split, merged in split order) at the plans' boundaries, against the
kernels' plain versions and the JAX kernels (Pallas interpret mode)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels.fasst import (H100_SMS, fasst_softmax_plain,  # noqa: E402
                                       softmax_plan)
from repro_torch.kernels.paged_attn import (SMEM_LIMIT, TARGET_TOKENS,  # noqa: E402
                                            paged_attn_plain, paged_attn_plan)

# (B, Hkv, G, d, ps, maxp): the served shape first, then the shapes of
# test_torch_kernels.py's paged-attention tests, and a single long chain
PAGED_SHAPES = [(8, 16, 1, 64, 16, 16), (2, 2, 4, 64, 16, 4), (2, 1, 4, 128, 16, 4),
                (2, 16, 1, 64, 16, 4), (2, 2, 5, 64, 16, 4), (4, 2, 4, 64, 8, 4),
                (3, 2, 2, 64, 8, 2), (1, 2, 4, 64, 16, 64), (64, 16, 1, 64, 16, 16),
                (2, 2, 4, 64, 128, 2)]


@pytest.mark.parametrize("kv_bytes", [1, 2])
@pytest.mark.parametrize("B,Hkv,G,d,ps,maxp", PAGED_SHAPES)
def test_paged_attn_plan_invariants(B, Hkv, G, d, ps, maxp, kv_bytes):
    plan = paged_attn_plan(B, Hkv, G, d, ps, maxp, kv_bytes=kv_bytes)
    assert plan.grid == (B, Hkv, plan.splits)
    assert plan.tokens_per_split == plan.pages_per_split * ps
    # the splits tile the chain's pages [0, maxp) in whole pages, none empty
    bounds = [(z * plan.pages_per_split, min(maxp, (z + 1) * plan.pages_per_split))
              for z in range(plan.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == maxp
    assert all(a < b for a, b in bounds)
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    # one split's K, V and scales fit one batch of copies into shared memory
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.tokens_per_split <= max(TARGET_TOKENS, ps)
    # at least two blocks per SM wherever the chain has pages enough
    if B * Hkv * maxp >= 2 * H100_SMS:
        assert B * Hkv * plan.splits >= 2 * H100_SMS
    else:
        assert plan.splits == maxp
    if (B, Hkv, G, d, ps, maxp) == PAGED_SHAPES[0]:
        assert B * Hkv * plan.splits >= 2 * 132
    one = plan.splits == 1
    assert plan.workspace_elems == (0 if one else B * Hkv * plan.splits * G * (d + 2))
    assert plan.counters == (0 if one else B * Hkv)


def test_paged_attn_plan_refuses_what_the_kernel_cannot_copy():
    with pytest.raises(ValueError, match="16-byte"):
        paged_attn_plan(1, 1, 1, 24, 16, 4, kv_bytes=1)
    with pytest.raises(ValueError, match="shared memory"):
        paged_attn_plan(1, 1, 8, 128, 256, 4, kv_bytes=2)


SOFTMAX_SHAPES = [(8, 256204), (1, 256204), (264, 256204), (300, 5000), (8, 4096),
                  (8, 64), (33, 100), (4, 5000), (1, 4097), (128, 128), (2, 20000)]


@pytest.mark.parametrize("M,C", SOFTMAX_SHAPES)
def test_softmax_plan_invariants(M, C):
    plan = softmax_plan(M, C)
    assert plan.chunk & (plan.chunk - 1) == 0 and plan.chunk >= 16
    assert plan.seg % plan.chunk == 0
    # the segments tile [0, C) in whole chunks, none empty
    assert (plan.nseg - 1) * plan.seg < C <= plan.nseg * plan.seg
    if M >= 2 * H100_SMS or C <= plan.chunk:
        assert plan.nseg == 1
    if C <= 4096:
        assert plan.nseg == 1
    if plan.nseg > 1 and C >= 16 * 2 * H100_SMS:
        assert M * plan.nseg >= 2 * H100_SMS
    if (M, C) in ((8, 256204), (1, 256204)):
        assert M * plan.nseg >= 264


# ---------------------------------------------------------------------------
# paged attention: split-and-merge emulation
# ---------------------------------------------------------------------------

def _paged_split_emulation(q, kc, ks, vc, vs, tables, lens, sm_scale, plan):
    """The kernel's arithmetic in plain torch: each live split's f32 max,
    denominator and accumulator over its tokens, merged in split order in
    one online pass (one live split writes directly). Returns (out, pages
    read, splits skipped as wholly past the length)."""
    B, Hkv, G, d = q.shape
    ps, maxp = kc.shape[1], tables.shape[1]
    T = plan.tokens_per_split
    out = torch.zeros((B, Hkv, G, d))
    read, skipped = set(), 0
    for b in range(B):
        L = min(max(int(lens[b]), 0), maxp * ps)
        parts = []
        for z in range(plan.splits):
            if z * T >= L:
                skipped += 1
                continue
            toks = torch.arange(z * T, min(L, (z + 1) * T))
            pages, slots = tables[b, toks // ps].long(), toks % ps
            read.update(pages.tolist())
            k, v = kc[pages, slots].float(), vc[pages, slots].float()
            if ks is not None:
                k = k * ks[pages, slots][..., None]
                v = v * vs[pages, slots][..., None]
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


def _jax_pool(rng, P, ps, Hkv, d, kind):
    k = jnp.asarray(rng.standard_normal((P, ps, Hkv, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((P, ps, Hkv, d)), jnp.float32)
    if kind == "bf16":
        return k.astype(jnp.bfloat16), None, v.astype(jnp.bfloat16), None
    if kind == "int8":
        kc, ks = jops.quantize_kv(k)
        vc, vs = jops.quantize_kv(v)
        return kc, ks, vc, vs
    ks = jnp.maximum(jnp.max(jnp.abs(k), -1), 1e-6) / 448.0
    vs = jnp.maximum(jnp.max(jnp.abs(v), -1), 1e-6) / 448.0
    return (k / ks[..., None]).astype(jnp.float8_e4m3fn), ks, \
        (v / vs[..., None]).astype(jnp.float8_e4m3fn), vs


# (B, H, Hkv, d, ps, maxp, lengths, sms): lengths 0, 1, ps, ps + 1 and the
# full chain, one page a split; then splits of several pages (T = 64) with
# lengths on both sides of each split's edge; then a GQA group over a
# chain of 16 one-page splits, most of them past the length
PAGED_CASES = [
    (5, 4, 2, 64, 8, 8, [0, 1, 8, 9, 64], H100_SMS),
    (8, 4, 4, 64, 16, 16, [0, 1, 16, 17, 63, 64, 65, 256], 16),
    (2, 8, 2, 128, 16, 16, [40, 3], H100_SMS),
]


@pytest.mark.parametrize("kind", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("case", range(len(PAGED_CASES)))
def test_paged_attn_split_merge_emulation(case, kind):
    B, H, Hkv, d, ps, maxp, lengths, sms = PAGED_CASES[case]
    G = H // Hkv
    rng = np.random.default_rng(10 + case)
    P = B * maxp + 1
    kc, ks, vc, vs = _jax_pool(rng, P, ps, Hkv, d, kind)
    perm = 1 + rng.permutation(P - 1)                 # disjoint chains, page 0 = trash
    tables = jnp.asarray(perm[:B * maxp].reshape(B, maxp).astype(np.int32))
    lens = jnp.asarray(lengths, jnp.int32)
    q = jnp.asarray(rng.standard_normal((B, H, d)), jnp.float32)
    out_jax = np.asarray(jops.paged_decode_attention(
        q, kc, vc, tables, lens, k_scales=ks, v_scales=vs, out_dtype=jnp.float32))

    t = jax_to_torch
    plan = paged_attn_plan(B, Hkv, G, d, ps, maxp, sms,
                           kv_bytes=2 if kind == "bf16" else 1)
    tks, tvs = (t(ks), t(vs)) if ks is not None else (None, None)
    qg = t(q).reshape(B, Hkv, G, d)
    emu, read, skipped = _paged_split_emulation(qg, t(kc), tks, t(vc), tvs, t(tables),
                                                t(lens), d ** -0.5, plan)
    plain = paged_attn_plain(qg, t(kc), tks, t(vc), tvs, t(tables), t(lens), d ** -0.5)
    emu = emu.reshape(B, H, d).numpy()
    assert float(np.max(np.abs(emu - plain.reshape(B, H, d).numpy()))) <= 1e-6
    assert float(np.max(np.abs(emu - out_jax))) <= 1e-6
    # the plan's boundaries were crossed: several splits, some wholly past
    # a length, and no page outside a live chain read (never the trash page)
    T = plan.tokens_per_split
    assert plan.splits > 1 and skipped > 0
    assert 0 not in read
    live = sum(math.ceil(min(n, maxp * ps) / T) for n in lengths)
    assert skipped == B * plan.splits - live
    assert np.all(emu[np.asarray(lengths) == 0] == 0)


# ---------------------------------------------------------------------------
# row softmax: split-and-merge emulation
# ---------------------------------------------------------------------------

def _softmax_split_emulation(x, scale, valid_cols, plan):
    """Pass 1 per segment (max, rescaled sum over its valid columns; a
    segment wholly past ``valid_cols`` gives (-inf, 0)), the row's
    partials merged in segment order, then pass 2."""
    M, C = x.shape
    valid = C if valid_cols < 0 else min(valid_cols, C)
    xs = x.float() * scale
    ms, ss = [], []
    for z in range(plan.nseg):
        a, b = z * plan.seg, min((z + 1) * plan.seg, valid)
        if a >= b:
            ms.append(torch.full((M,), float("-inf")))
            ss.append(torch.zeros(M))
            continue
        m = xs[:, a:b].amax(-1)
        ms.append(m)
        ss.append(torch.exp(xs[:, a:b] - m[:, None]).sum(-1))
    m_row = torch.stack(ms, -1).amax(-1)
    s_row = torch.zeros(M)
    for m, s in zip(ms, ss):
        s_row = s_row + torch.where(m > float("-inf"), s * torch.exp(m - m_row), 0.0)
    cols = torch.arange(C)
    return torch.where(cols < valid, torch.exp(xs - m_row[:, None]) / s_row[:, None], 0.0)


# (M, C, valid_cols): many narrow segments with valid_cols at 1, on a
# segment edge, inside a segment (later segments wholly past it), past C,
# and all; then the vocabulary rows at the served plans
SOFTMAX_CASES = [(2, 20000, v) for v in (1, 2560, 5000, 20007, -1)] + [
    (1, 256204, -1), (1, 256204, 1), (8, 256204, 100000)]


@pytest.mark.parametrize("M,C,valid_cols", SOFTMAX_CASES)
def test_softmax_split_merge_emulation(M, C, valid_cols):
    plan = softmax_plan(M, C)
    assert plan.nseg > 1
    rng = np.random.default_rng(20)
    x = (rng.standard_normal((M, C)) * 5).astype(np.float32)
    emu = _softmax_split_emulation(torch.from_numpy(x), 0.7, valid_cols, plan).numpy()
    plain = fasst_softmax_plain(torch.from_numpy(x), scale=0.7, valid_cols=valid_cols)
    y_jax = np.asarray(jops.fasst_softmax(jnp.asarray(x), scale=0.7,
                                          valid_cols=valid_cols))
    assert float(np.max(np.abs(emu - plain.numpy()))) <= 1e-6
    assert float(np.max(np.abs(emu - y_jax))) <= 1e-6
    vc = C if valid_cols < 0 else min(valid_cols, C)
    assert np.all(emu[:, vc:] == 0.0)
    if vc == 1:
        assert np.all(emu[:, 0] == 1.0)
    past = sum(z * plan.seg >= vc for z in range(plan.nseg))
    assert past == plan.nseg - math.ceil(vc / plan.seg)
