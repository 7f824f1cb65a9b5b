"""fp8 KV caches of the port: dense and paged, self and cross, against the
JAX package and against each other (smoke nllb600m, f32, JAX-initialised
weights).

An fp8 cache keeps the int8 layout with float8 e4m3 storage: ``k`` / ``v``
codes and ``k_scales`` / ``v_scales``, no ``k_codes``. Tolerances: the
per-token fp8 quantizer is byte-equal to the reference's (its cast
rounded once, ``exact_fp8_reference``); a decode step against an fp8
cache stays within fp8's error of the bf16 cache (reading the codes as
unscaled K/V would not); greedy streams equal the JAX dense engine's and
the port's own dense streams token for token; moving pages (prefill
insertion, preemption and resume) keeps the pool float8 and the streams
unchanged. The JAX engine is built once.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import exact_fp8_reference, jax_to_torch, same_bytes  # noqa: E402

import repro.models.transformer as jtf  # noqa: E402
from repro.configs import REGISTRY, reduce_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro.serving import impl_routes as j_impl_routes  # noqa: E402
from repro_torch.data import SyntheticTranslation  # noqa: E402
from repro_torch.models.encdec import _kv_layout  # noqa: E402
from repro_torch.models.transformer import _fp8_token_kv  # noqa: E402
from repro_torch.serving import SamplingParams, deploy, impl_routes  # noqa: E402
from repro_torch.serving.paged_cache import init_paged_kv, paged_insert  # noqa: E402

F8 = torch.float8_e4m3fn
CFG = reduce_config(REGISTRY["nllb600m"])
KW = dict(smoke=True, slots=3, max_len=16, page_size=4, horizon=4)
GEN = 6


def prompts():
    rng = np.random.default_rng(2)
    return [{"src_tokens": rng.integers(16, 256, (1, 6)).astype(np.int32),
             "tgt_in": np.full((1, 1), c, np.int32)} for c in (8, 1, 7)]


@pytest.fixture(scope="module")
def raw_params():
    return j_build_model(CFG).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def torch_params(raw_params):
    return jax_to_torch(raw_params)


@pytest.fixture(scope="module")
def reference(raw_params):
    """The JAX dense engine's streams for the "fp8" alias (fp8 weights and
    KV, bf16 activations)."""
    with exact_fp8_reference():
        pipe = j_deploy("nllb600m", "fp8", params=raw_params, **KW, **j_impl_routes("xla"))
        outs = pipe.generate([{k: jnp.asarray(v) for k, v in p.items()} for p in prompts()],
                             JSamplingParams(max_new_tokens=GEN))
    return [list(o.token_ids) for o in outs]


def port_pipe(torch_params, spec, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # fp8e2e is uncalibrated here
        return deploy("nllb600m", spec, params=torch_params, device="cpu",
                      **dict(KW, **kw))


def test_fp8_token_kv_byte_equal():
    rng = np.random.default_rng(0)
    t = (rng.standard_normal((2, 5, 2, 16)) * np.exp(rng.standard_normal((2, 5, 2, 1)))
         ).astype(np.float32)
    t[0, 1] = 0.0                                 # all-zero heads: scale 1
    with exact_fp8_reference():
        jc, js = jax.jit(jtf._fp8_token_kv)(jnp.asarray(t))
    tc, ts = _fp8_token_kv(torch.from_numpy(t))
    assert tc.dtype == F8
    assert same_bytes(jc, tc) and same_bytes(js, ts)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fp8_cache_layout(torch_params, paged):
    """float8 self and cross K/V with f32 scales and no codes keys; the
    layout test reads it as fp8, and its bytes equal an int8 cache's."""
    pipe = port_pipe(torch_params, "fp8", paged=paged)
    cache = pipe.engine.cache
    assert _kv_layout(cache) == "fp8"
    assert not any(k.endswith("_codes") for k in cache)
    for k in ("k", "v", "cross_k", "cross_v"):
        assert cache[k].dtype == F8, k
        assert cache[f"{k}_scales"].dtype == torch.float32
    int8 = port_pipe(torch_params, "w8kv8", paged=paged)
    assert _kv_layout(int8.engine.cache) == "int8"
    assert pipe.engine.kv_cache_bytes == int8.engine.kv_cache_bytes


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fp8_cache_decodes_scaled(torch_params, paged):
    """A decode step against the fp8 cache stays within fp8's error of the
    same step against a bf16 cache (codes read as unscaled K/V would
    not)."""
    logits = {}
    for kv in ("fp8", "bf16"):
        pipe = port_pipe(torch_params, "int8", kv_dtype=kv, paged=paged, slots=1, horizon=1)
        eng = pipe.engine
        eng.submit(prompts()[0], SamplingParams(max_new_tokens=3))
        eng.step()
        cache = dict(eng.cache)
        _, lg = pipe.model.decode_step(pipe.ctx, pipe.params, eng.cur, cache)
        logits[kv] = lg[0, -1]
    err = (logits["fp8"] - logits["bf16"]).abs().max().item()
    assert 0 < err < 0.05 * logits["bf16"].abs().max().item()


@pytest.mark.parametrize("route", ["dense", "paged", "paged-kernels"])
def test_fp8_streams_equal_reference(torch_params, reference, route):
    """The "fp8" alias: dense and gathered paged engines of the port equal
    the JAX dense engine token for token, and so does the kernel route
    (write-then-attend on fp8 pages) here, where no stream parts."""
    bundle = "kernels" if route == "paged-kernels" else "torch"
    pipe = port_pipe(torch_params, "fp8", paged=route != "dense", **impl_routes(bundle))
    outs = pipe.generate(prompts(), SamplingParams(max_new_tokens=GEN))
    assert [o.token_ids for o in outs] == reference


def test_fp8_dense_paged_same_tokens(torch_params):
    """The reference's gate: fp8e2e's paged engine reproduces its dense
    engine's streams."""
    ds = SyntheticTranslation(CFG.vocab_size, CFG.enc_len, seed=0)
    src = ds.sample(2)["src_tokens"]
    streams = {}
    for paged in (False, True):
        pipe = port_pipe(torch_params, "fp8e2e", paged=paged, slots=2, horizon=1)
        outs = pipe.translate(src, "ita", SamplingParams(max_new_tokens=6))
        streams[paged] = [o.token_ids for o in outs]
    assert streams[False] == streams[True]


def test_fp8_pages_survive_preemption(torch_params):
    """A pool short of pages preempts and resumes by prefill replay: the
    streams equal an uncontended run, and the pool stays float8."""
    sp = SamplingParams(max_new_tokens=10)
    free = port_pipe(torch_params, "fp8e2e", paged=True, slots=2)
    want = [o.token_ids for o in free.generate(prompts(), sp)]
    tight = port_pipe(torch_params, "fp8e2e", paged=True, slots=2, num_pages=5)
    tight.engine.preempt_limit = 16
    outs = tight.generate(prompts(), sp)
    assert tight.engine.metrics().preemptions > 0
    assert [o.token_ids for o in outs] == want
    assert tight.engine.cache["k"].dtype == F8
    tight.engine.allocator.check()
    assert tight.engine.allocator.pages_in_use == 0


def test_paged_insert_moves_fp8_bytes():
    """paged_insert scatters a dense fp8 prefill cache into page chains
    and splices the cross leaves, byte for byte."""
    g = torch.Generator().manual_seed(0)
    L, n, S, Hkv, hd, ps = 2, 2, 6, 2, 8, 4
    cache = init_paged_kv(L, 8, ps, Hkv, hd, "fp8", device="cpu")
    cache.update(cross_k=torch.zeros((L, 3, 5, Hkv, hd), dtype=F8),
                 cross_k_scales=torch.zeros((L, 3, 5, Hkv)),
                 cross_len=torch.zeros(3, dtype=torch.int32),
                 block_tables=torch.zeros((3, 2), dtype=torch.int32),
                 len=torch.zeros(3, dtype=torch.int32), active=torch.zeros(3, dtype=torch.int32))
    mini = {"k": torch.randn((L, n, S, Hkv, hd), generator=g).to(F8),
            "k_scales": torch.rand((L, n, S, Hkv), generator=g),
            "v": torch.randn((L, n, S, Hkv, hd), generator=g).to(F8),
            "v_scales": torch.rand((L, n, S, Hkv), generator=g),
            "cross_k": torch.randn((L, n, 4, Hkv, hd), generator=g).to(F8),
            "cross_k_scales": torch.rand((L, n, 4, Hkv), generator=g),
            "cross_len": torch.tensor([4, 4], dtype=torch.int32)}
    rows = torch.tensor([[3, 5], [1, 2]], dtype=torch.int32)
    lengths = torch.tensor([6, 3], dtype=torch.int32)
    paged_insert(cache, mini, torch.tensor([2, 0]), rows, lengths)
    assert cache["k"].dtype == F8 and cache["cross_k"].dtype == F8
    for b, slot in ((0, 2), (1, 0)):
        for t in range(int(lengths[b])):
            page, off = int(rows[b, t // ps]), t % ps
            for key in ("k", "v"):
                assert torch.equal(cache[key][:, page, off].view(torch.uint8),
                                   mini[key][:, b, t].view(torch.uint8))
            assert torch.equal(cache["k_scales"][:, page, off], mini["k_scales"][:, b, t])
        assert torch.equal(cache["cross_k"][:, slot, :4].view(torch.uint8),
                           mini["cross_k"][:, b].view(torch.uint8))
