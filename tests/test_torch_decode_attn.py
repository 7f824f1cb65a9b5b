"""Kernel parity on the CPU for the dense int8 flash-decode and the fused
row softmax: the port's wrappers (which run the kernels' plain PyTorch
versions on CPU tensors) against the JAX kernels through their ``ops``
wrappers (Pallas interpret mode) and the JAX oracles in ``kernels/ref.py``,
on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn_call, decode_attn_plain  # noqa: E402
from repro_torch.kernels.fasst import fasst_softmax_call, fasst_softmax_plain  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _decode_case(B, H, Hkv, d, S, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, d)).astype(np.float32)
    kc, ks = jops.quantize_kv(jnp.asarray(k))
    vc, vs = jops.quantize_kv(jnp.asarray(v))
    lens = np.asarray(lengths, np.int32)
    out_jax = np.asarray(jops.decode_attention(
        jnp.asarray(q), kc, ks, vc, vs, jnp.asarray(lens), out_dtype=jnp.float32))
    G = H // Hkv
    t = jnp.transpose
    out_ref = np.asarray(jref.decode_attn_ref(
        jnp.asarray(q).reshape(B, Hkv, G, d), t(kc, (0, 2, 1, 3)), t(ks, (0, 2, 1)),
        t(vc, (0, 2, 1, 3)), t(vs, (0, 2, 1)), jnp.asarray(lens),
        d ** -0.5)).reshape(B, H, d)
    tq, tkc, tks, tvc, tvs = (_t(a) for a in (q, kc, ks, vc, vs))
    out = ops.decode_attention(tq, tkc, tks, tvc, tvs, _t(lens),
                               out_dtype=torch.float32)
    plain = decode_attn_plain(tq.reshape(B, Hkv, G, d), tkc, tks, tvc, tvs,
                              _t(lens), d ** -0.5).reshape(B, H, d)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, H, d)
    assert torch.equal(out, plain)
    return out.numpy(), out_jax, out_ref


@pytest.mark.parametrize("H,Hkv,d", [(8, 2, 64), (4, 1, 128), (16, 16, 64),
                                     (10, 2, 64)])
def test_decode_attention_gqa_configs(H, Hkv, d):
    out, out_jax, out_ref = _decode_case(2, H, Hkv, d, 256, [256, 100])
    assert np.max(np.abs(out - out_jax)) < 1e-5
    assert np.max(np.abs(out - out_ref)) < 1e-5


def test_decode_attention_ragged_lengths():
    out, out_jax, out_ref = _decode_case(4, 8, 2, 64, 384, [384, 1, 17, 200], seed=1)
    assert np.max(np.abs(out - out_jax)) < 1e-5
    assert np.max(np.abs(out - out_ref)) < 1e-5


def test_decode_attention_zero_length_row_is_exactly_zero():
    out, out_jax, _ = _decode_case(3, 4, 2, 64, 32, [0, 5, 32], seed=2)
    assert np.all(out[0] == 0.0) and np.all(np.asarray(out_jax)[0] == 0.0)
    assert np.max(np.abs(out - out_jax)) < 1e-5


def test_decode_attention_never_reads_past_length():
    """Positions at or past lengths[b] have probability exactly 0: their
    contents cannot change one output bit."""
    rng = np.random.default_rng(3)
    B, H, Hkv, d, S = 2, 4, 2, 64, 16
    q = torch.from_numpy(rng.standard_normal((B, H, d)).astype(np.float32))
    kc, ks = ops.quantize_kv(torch.from_numpy(
        rng.standard_normal((B, S, Hkv, d)).astype(np.float32)))
    vc, vs = ops.quantize_kv(torch.from_numpy(
        rng.standard_normal((B, S, Hkv, d)).astype(np.float32)))
    lens = torch.tensor([9, 3], dtype=torch.int32)
    base = ops.decode_attention(q, kc, ks, vc, vs, lens, out_dtype=torch.float32)
    for b, n in enumerate(lens.tolist()):
        kc[b, n:], vc[b, n:], ks[b, n:], vs[b, n:] = 127, -127, 1e3, 1e3
    poisoned = ops.decode_attention(q, kc, ks, vc, vs, lens, out_dtype=torch.float32)
    assert torch.equal(base, poisoned)


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(4)
    kv = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    kv[0, 1] = 0.0                                  # all-zero rows take scale 1
    # the engines run the quantizer compiled (absmax times 1/127 in f32)
    jc, js = jax.jit(jops.quantize_kv)(jnp.asarray(kv))
    tc, ts = ops.quantize_kv(torch.from_numpy(kv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_kv_equals_compiled_reference_on_wide_scales():
    """The int8 KV quantizer's scales and codes equal jax.jit(quantize_kv_ref)
    byte for byte on rows whose magnitudes span three decades: the scale
    is absmax times the f32 reciprocal of 127, as the compiled reference
    computes it (a division gives 42 of these 1024 scales one ulp apart)."""
    rng = np.random.default_rng(0)
    kv = (rng.standard_normal((64, 16, 64))
          * rng.uniform(0.01, 10, (64, 16, 1))).astype(np.float32)
    jc, js = jax.jit(jref.quantize_kv_ref)(jnp.asarray(kv))
    tc, ts = ops.quantize_kv(torch.from_numpy(kv))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert tc.numpy().tobytes() == np.asarray(jc).tobytes()


@pytest.mark.parametrize("rows,cols", [(8, 64), (33, 100), (1, 128)])
def test_fasst_softmax_matches_jax(rows, cols):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((rows, cols)) * 5).astype(np.float32)
    y_jax = np.asarray(jops.fasst_softmax(jnp.asarray(x), scale=0.7))
    y_ref = np.asarray(jref.fasst_softmax_ref(jnp.asarray(x), scale=0.7))
    y = ops.fasst_softmax(torch.from_numpy(x), scale=0.7)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_jax, atol=1e-6, rtol=0)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("valid_cols", [8, 31, 40, -1])
def test_fasst_softmax_masked_padding(valid_cols):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    y_jax = np.asarray(jops.fasst_softmax(jnp.asarray(x), valid_cols=valid_cols))
    y = ops.fasst_softmax(torch.from_numpy(x), valid_cols=valid_cols).numpy()
    np.testing.assert_allclose(y, y_jax, atol=1e-6, rtol=0)
    vc = 32 if valid_cols < 0 else min(valid_cols, 32)
    assert np.all(y[:, vc:] == 0.0)
    np.testing.assert_allclose(y.sum(-1), 1.0, atol=1e-5)


def test_fasst_softmax_bf16_output_within_one_ulp():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((16, 96)) * 3).astype(np.float32)
    y_jax = np.asarray(jops.fasst_softmax(jnp.asarray(x), scale=0.5,
                                          out_dtype=jnp.bfloat16).astype(jnp.float32))
    y = ops.fasst_softmax(torch.from_numpy(x), scale=0.5, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    y = y.float().numpy()
    # one bf16 ulp of a value in [2^-k, 2^-k+1) is 2^-k-7 <= |y| 2^-7
    assert np.all(np.abs(y - y_jax) <= np.abs(y_jax) * 2.0 ** -7 + 1e-30)


def test_fasst_softmax_rows_longer_than_a_chunk():
    """A vocabulary-wide row, beyond one Triton chunk, over leading axes."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((2, 1, 20000)) * 4).astype(np.float32))
    y = ops.fasst_softmax(x, scale=0.7)
    assert y.shape == x.shape
    torch.testing.assert_close(y, torch.softmax(x * 0.7, dim=-1), atol=1e-6, rtol=0)


def test_kernel_calls_refuse_cpu_tensors():
    """The launchers never take the plain route themselves."""
    q = torch.zeros(1, 1, 1, 64)
    codes = torch.zeros(1, 4, 1, 64, dtype=torch.int8)
    scales = torch.ones(1, 4, 1)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn_call(q, codes, scales, codes, scales,
                         torch.ones(1, dtype=torch.int32), sm_scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        fasst_softmax_call(torch.zeros(2, 8))
    assert fasst_softmax_plain(torch.zeros(2, 8)).shape == (2, 8)
