"""Model parity at smoke size (f32 compute, int4 weights, int8 KV): the
port's encoder, prefill, and dense and paged decode steps against the
JAX package's on the same converted parameters, with the kernel routes
on in both (the port's wrappers run their plain versions on CPU tensors).

Tolerance 1e-4: both sides sum f32 products in different orders; the
bf16 rounding inside qmm is identical."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch  # noqa: E402

from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.core import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core.spec import ALIASES  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.serving.paged_cache import paged_insert as j_paged_insert  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.serving.paged_cache import paged_insert  # noqa: E402

TOL = 1e-4
JCFG = reduce_config(REGISTRY["nllb600m"])
CFG = t_reduce_config(get_config("nllb600m"))
JCTX = JCtx(compute_dtype=jnp.float32, matmul_impl="pallas",
            paged_attn_impl="kernel", use_fasst_kernel=True)
CTX = Ctx(compute_dtype=torch.float32, matmul_impl="kernel",
          paged_attn_impl="kernel", use_fasst_kernel=True)


@pytest.fixture(scope="module")
def params():
    raw = jed.encdec_init(jax.random.PRNGKey(0), JCFG)
    jp = j_quantize_tree(raw, ALIASES["int4"].policy())
    return jp, jax_to_torch(jp)


def _inputs(B=2, Se=9, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(16, JCFG.vocab_size, (B, Se)).astype(np.int32)
    tgt = np.zeros((B, 2), np.int32)
    tgt[:, 0] = [8, 3][:B]
    tgt[:, 1] = rng.integers(16, JCFG.vocab_size, B)
    return src, tgt


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


def test_config_mirrors_reference():
    assert CFG.__dict__.keys() == JCFG.__dict__.keys()
    assert all(getattr(CFG, k) == getattr(JCFG, k) for k in CFG.__dict__
               if k not in ("moe", "ssm"))


def test_encoder_output(params):
    jp, tp = params
    src, _ = _inputs()
    j = jed.encdec_encode(JCTX, jp, JCFG, jnp.asarray(src))
    t = ted.encdec_encode(CTX, tp, CFG, torch.from_numpy(src))
    _close(t.numpy(), j)


def _prefill_both(params, src, tgt, lengths, kv="int8", max_len=None):
    jp, tp = params
    B, Sd = tgt.shape
    max_len = max_len or Sd
    jc = jed.encdec_init_cache(JCFG, B, max_len, src.shape[1], kv)
    jc, jl = jed.encdec_prefill(JCTX, jp, JCFG, jc, jnp.asarray(tgt),
                                jnp.asarray(src), lengths=jnp.asarray(lengths))
    tc = ted.encdec_init_cache(CFG, B, max_len, src.shape[1], kv, device="cpu")
    tc, tl = ted.encdec_prefill(CTX, tp, CFG, tc, torch.from_numpy(tgt),
                                torch.from_numpy(src),
                                torch.tensor(lengths, dtype=torch.int32))
    return jc, jl, tc, tl


def test_prefill_logits_and_int8_mini_cache(params):
    src, tgt = _inputs()
    jc, jl, tc, tl = _prefill_both(params, src, tgt, [2, 1])
    _close(tl.numpy(), jl)
    for key in ("k_codes", "v_codes", "cross_k_codes", "cross_v_codes"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]), key)
    for key in ("k_scales", "v_scales", "cross_k_scales", "cross_v_scales",
                "pos", "len", "cross_len"):
        _close(tc[key].numpy(), jc[key], 1e-6)


def test_three_paged_decode_steps(params):
    """Prefill into a paged int8 pool, then three decode steps (the
    kernel route: write-then-attend) fed the same tokens on both sides."""
    jp, tp = params
    src, tgt = _inputs(seed=1)
    lengths = [2, 1]
    jm, jl, tm, tl = _prefill_both(params, src, tgt, lengths)
    slots, ps, maxp = 3, 4, 3
    jcache = jed.encdec_init_paged_cache(JCFG, slots, maxp, 10, ps, "int8",
                                         enc_len=JCFG.enc_len)
    tcache = ted.encdec_init_paged_cache(CFG, slots, maxp, 10, ps, "int8",
                                         enc_len=CFG.enc_len, device="cpu")
    rows = np.array([[3, 4, 5], [7, 8, 0]], np.int32)
    slot_ids = np.array([2, 0], np.int32)
    jcache = j_paged_insert(jcache, jm, jnp.asarray(slot_ids), jnp.asarray(rows),
                            jnp.asarray(lengths, jnp.int32))
    paged_insert(tcache, tm, torch.from_numpy(slot_ids), torch.from_numpy(rows),
                 torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_array_equal(tcache["k_codes"].numpy(),
                                  np.asarray(jcache["k_codes"]))
    tok = np.zeros((slots, 1), np.int32)
    tok[slot_ids, 0] = np.argmax(np.asarray(jl)[[0, 1], [1, 0]], -1)
    for _ in range(3):
        jcache, jlog = jed.encdec_paged_decode_step(JCTX, jp, JCFG,
                                                    jnp.asarray(tok), jcache)
        tcache, tlog = ted.encdec_paged_decode_step(CTX, tp, CFG,
                                                    torch.from_numpy(tok), tcache)
        _close(tlog.numpy(), jlog)
        np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
        tok = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)[:, None]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_three_dense_decode_steps(params, kv):
    """Prefill into a dense cache with room to grow, then three dense
    decode steps fed the same tokens on both sides; the second and third
    carry an ``active`` mask with slot 1 frozen."""
    jp, tp = params
    src, tgt = _inputs(seed=3)
    jc, jl, tc, tl = _prefill_both(params, src, tgt, [2, 1], kv, max_len=6)
    tok = np.argmax(np.asarray(jl)[[0, 1], [1, 0]], -1).astype(np.int32)[:, None]
    for step in range(3):
        if step:
            jc = dict(jc, active=jnp.asarray([1, 0], jnp.int32))
            tc = dict(tc, active=torch.tensor([1, 0], dtype=torch.int32))
        jc, jlog = jed.encdec_decode_step(JCTX, jp, JCFG, jnp.asarray(tok), jc)
        tc, tlog = ted.encdec_decode_step(CTX, tp, CFG, torch.from_numpy(tok), tc)
        _close(tlog.numpy(), jlog)
        for key in ("pos", "len") + (("k_codes", "v_codes") if kv == "int8" else ()):
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]), key)
        for key in ("k_scales", "v_scales") if kv == "int8" else ("k", "v"):
            _close(tc[key].float().numpy(), np.asarray(jc[key]).astype(np.float32))
        tok = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)[:, None]
    assert np.asarray(jc["len"]).tolist() == [5, 2]


def test_gather_route_tracks_kernel_route(params):
    """The "torch" bundle (gather path, dequantize matmuls) stays within the
    reference engine's int8 bound of the kernel route on one decode step."""
    _, tp = params
    src, tgt = _inputs(seed=2)
    _, _, tm, _ = _prefill_both(params, src, tgt, [2, 2])
    cache = ted.encdec_init_paged_cache(CFG, 2, 2, 5, 4, "int8",
                                        enc_len=CFG.enc_len, device="cpu")
    paged_insert(cache, tm, torch.tensor([0, 1]), torch.tensor([[1, 2], [3, 4]]),
                 torch.tensor([2, 2], dtype=torch.int32))
    tok = torch.tensor([[20], [30]], dtype=torch.int32)
    clone = {k: v.clone() for k, v in cache.items()}
    _, lk = ted.encdec_paged_decode_step(CTX, tp, CFG, tok, cache)
    ctx_t = Ctx(compute_dtype=torch.float32)
    _, lt = ted.encdec_paged_decode_step(ctx_t, tp, CFG, tok, clone)
    assert float((lk - lt).abs().max()) < 0.3
    assert torch.equal(lk[:, -1].argmax(-1), lt[:, -1].argmax(-1))


def test_dense_cache_helpers_match_reference():
    from repro.models import transformer as jtf
    rng = np.random.default_rng(4)
    t = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    # the engines run the quantizer compiled (absmax times 1/127 in f32)
    jc, js = jax.jit(jtf._quantize_token_kv)(jnp.asarray(t))
    tc, ts = ttf._quantize_token_kv(torch.from_numpy(t))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close(ttf._dense_kv(tc, ts).float().numpy(),
           np.asarray(jtf._dense_kv(jc, js).astype(jnp.float32)), 0)
    pos = np.full((2, 6), -1, np.int32)
    lens = np.array([1, 3], np.int32)
    jcache = {"pos": jnp.asarray(pos), "len": jnp.asarray(lens),
              "active": jnp.asarray([1, 0], jnp.int32)}
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    positions = lens[:, None]
    jn = jtf._commit_decode_position(dict(jcache), jcache, jnp.asarray(positions))
    tn = ttf._commit_decode_position(dict(tcache), tcache, torch.from_numpy(positions))
    for k in ("pos", "len"):
        np.testing.assert_array_equal(tn[k].numpy(), np.asarray(jn[k]))
