"""Kernel parity on the CPU: each wrapper of the port (which runs the
kernel's plain PyTorch version on CPU tensors) against the JAX kernel
through its ``ops`` wrapper (Pallas interpret mode) and against the JAX
oracle in ``kernels/ref.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch  # noqa: E402

from repro.core import QTensor as JQTensor  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fasst import MODES as J_MODES  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fasst import MODES  # noqa: E402


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-9))


def _qmm_case(m, k, n, fmt, block, seed=0):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((k, n)), jnp.float32) * 0.05
    x = np.asarray(rng.standard_normal((m, k)), np.float32)
    qt = JQTensor.quantize(w, fmt, block_size=block)
    y_jax = np.asarray(jops.qmm(jnp.asarray(x), qt, compute_dtype=jnp.float32))
    y_ref = np.asarray(jref.qmm_ref(jnp.asarray(x), qt.data, qt.block_scales(), fmt))
    y = ops.qmm(torch.from_numpy(x), jax_to_torch(qt), compute_dtype=torch.float32)
    assert y.dtype == torch.float32 and tuple(y.shape) == (m, n)
    return _rel(y.numpy(), y_jax), _rel(y.numpy(), y_ref)


@pytest.mark.parametrize("fmt", ["int4", "fp4", "nf4", "int8", "fp8"])
@pytest.mark.parametrize("m,k,n,block", [
    (8, 128, 64, 32),
    (48, 256, 128, 64),
    (1, 64, 96, 16),       # decode-like single row
    (130, 512, 256, 128),  # M not tile-aligned
])
def test_qmm_matches_jax_kernel_and_oracle(fmt, m, k, n, block):
    # same bf16 rounding points as the TPU kernel: only the f32
    # summation order differs from JAX's kernel
    vs_jax, vs_ref = _qmm_case(m, k, n, fmt, block)
    assert vs_jax <= 1e-5
    assert vs_ref < 6e-3          # the JAX kernel test's bound


def _pages(B, Hkv, d, P, ps, maxp, seed=0):
    rng = np.random.default_rng(seed)
    k = jnp.asarray(rng.standard_normal((P, ps, Hkv, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((P, ps, Hkv, d)), jnp.float32)
    perm = 1 + rng.permutation(P - 1)          # disjoint chains, page 0 = trash
    tables = jnp.asarray(perm[:B * maxp].reshape(B, maxp).astype(np.int32))
    return rng, k, v, tables


def _t(a):
    return jax_to_torch(a)


def _paged_case(B, H, Hkv, d, P, ps, maxp, lengths, kind="int8", seed=0):
    rng, k, v, tables = _pages(B, Hkv, d, P, ps, maxp, seed)
    q = jnp.asarray(rng.standard_normal((B, H, d)), jnp.float32)
    lens = jnp.asarray(lengths, jnp.int32)
    G = H // Hkv
    if kind == "bf16":
        kc, vc = k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
        ks = vs = None
    elif kind == "int8":
        kc, ks = jops.quantize_kv(k)
        vc, vs = jops.quantize_kv(v)
    else:                                      # fp8 e4m3 codes + scales
        ks = jnp.maximum(jnp.max(jnp.abs(k), -1), 1e-6) / 448.0
        vs = jnp.maximum(jnp.max(jnp.abs(v), -1), 1e-6) / 448.0
        kc = (k / ks[..., None]).astype(jnp.float8_e4m3fn)
        vc = (v / vs[..., None]).astype(jnp.float8_e4m3fn)
    scaled = ks is not None
    out_jax = jops.paged_decode_attention(
        q, kc, vc, tables, lens, k_scales=ks, v_scales=vs, out_dtype=jnp.float32)
    t = jnp.transpose
    out_ref = jref.paged_attn_ref(
        q.reshape(B, Hkv, G, d), t(kc, (0, 2, 1, 3)),
        t(ks, (0, 2, 1)) if scaled else None, t(vc, (0, 2, 1, 3)),
        t(vs, (0, 2, 1)) if scaled else None, tables, lens,
        d ** -0.5).reshape(B, H, d)
    out = ops.paged_decode_attention(
        _t(q), _t(kc), _t(vc), _t(tables), _t(lens),
        k_scales=_t(ks) if scaled else None, v_scales=_t(vs) if scaled else None,
        out_dtype=torch.float32).numpy()
    return (float(np.max(np.abs(out - np.asarray(out_jax)))),
            float(np.max(np.abs(out - np.asarray(out_ref)))))


@pytest.mark.parametrize("H,Hkv,d", [(8, 2, 64), (4, 1, 128), (16, 16, 64),
                                     (10, 2, 64)])
def test_paged_attn_gqa_configs(H, Hkv, d):
    assert max(_paged_case(2, H, Hkv, d, 17, 16, 4, [64, 33])) < 1e-5


@pytest.mark.parametrize("kind", ["int8", "bf16", "fp8"])
def test_paged_attn_ragged_lengths_and_page_types(kind):
    """Ragged chains (incl. a 1-token chain) for every page storage type."""
    assert max(_paged_case(4, 8, 2, 64, 33, 8, 4, [32, 1, 17, 29], kind)) < 1e-5


def test_paged_attn_zero_length_row_is_zero():
    rng, k, v, tables = _pages(2, 2, 64, 9, 8, 2)
    q = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32))
    kb, vb = _t(k.astype(jnp.bfloat16)), _t(v.astype(jnp.bfloat16))
    out = ops.paged_decode_attention(q, kb, vb, _t(tables),
                                     torch.tensor([0, 5], dtype=torch.int32),
                                     out_dtype=torch.float32)
    assert torch.all(out[0] == 0) and torch.isfinite(out[1]).all()


def test_paged_attn_trash_page_is_masked_out():
    """Out-of-chain entries point at page 0; its contents must be
    unobservable, bit for bit."""
    B, H, Hkv, d, P, ps = 1, 4, 2, 64, 5, 8
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((B, H, d)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((P, ps, Hkv, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((P, ps, Hkv, d)), jnp.float32)
    lens = torch.tensor([ps], dtype=torch.int32)
    tbl = torch.tensor([[1, 0, 0, 0]], dtype=torch.int32)

    def run(kk, vv):
        kc, ks = jops.quantize_kv(kk)
        vc, vs = jops.quantize_kv(vv)
        return ops.paged_decode_attention(q, _t(kc), _t(vc), tbl, lens,
                                          k_scales=_t(ks), v_scales=_t(vs),
                                          out_dtype=torch.float32)

    base = run(k, v)
    poisoned = run(k.at[0].set(1e3), v.at[0].set(-1e3))
    assert torch.equal(base, poisoned)


def test_fasst_modes_mirror_reference():
    assert MODES == J_MODES


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fasst_matches_jax_kernel_and_oracle(mode, dtype):
    rng = np.random.default_rng(0)
    xj = jnp.asarray(rng.standard_normal((37, 100)) * 3, dtype)
    y_jax = np.asarray(jops.fasst(xj, mode).astype(jnp.float32))
    y_ref = np.asarray(jref.fasst_act_ref(xj, mode).astype(jnp.float32))
    y = ops.fasst(_t(xj), mode)
    assert y.dtype == getattr(torch, dtype)
    y = y.to(torch.float32).numpy()
    # bf16 output: one bf16 rounding step of |y| <= ~9 is below 2e-2
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert float(np.max(np.abs(y - y_jax))) <= tol
    assert float(np.max(np.abs(y - y_ref))) <= tol
