"""Tensor-parallel serving on gloo CPU ranks against one device.

The reference's ``test_tensor_parallel_streams_match_single_device``
grid, on the port: ``deploy(mesh=tp_mesh(K))`` on each of K spawned
ranks (``cluster.launch_ranks``, gloo, a ``file://`` store under
``tmp_path``), the reduced nllb600m on the reference's initial weights,
dense and paged, horizon 1 and 16, greedy and seeded sampled (temperature
0.8, top-k 8, seed 7) at tp2, and tp4 at paged horizon 16.

* int8: every rank's streams and finish reasons equal the JAX
  single-device engine's (its default route, as the reference's test
  builds it);
* int4 (the qmm route; paged horizon 16 and dense horizon 1) and nf4
  (decoded double-quantized scales; paged horizon 16): equal the port's
  single-device engine (which the serving tests hold against the JAX
  engines);
* every rank serves the same streams; one prefill through a rank's own
  local model is within 1e-5 of the single device's largest logit;
* ``compressed_psum`` over the two ranks is byte-equal to the reference's
  under ``jax.vmap`` with a named axis.

One spawn of 2 ranks and one of 4 serve the whole grid.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch, jax_tree_to_numpy  # noqa: E402
from torch_tp_ranks import common, grids, prefill_logits, tp_grid  # noqa: E402

from repro.configs import REGISTRY, reduce_config as j_reduce_config  # noqa: E402
from repro.data import SyntheticTranslation  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim.compression import compressed_psum as j_compressed_psum  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro_torch.cluster import launch_ranks  # noqa: E402
from repro_torch.serving import deploy  # noqa: E402

INT8 = [("int8", paged, k) for paged in (False, True) for k in (1, 16)]
QMM = [("int4", True, 16), ("int4", False, 1), ("nf4", True, 16)]
TP4 = [("int8", True, 16)]


def _src():
    cfg = j_reduce_config(REGISTRY["nllb600m"])
    ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=0,
                              languages=("hin", "eng", "ita"))
    return np.asarray(ds.sample(3)["src_tokens"])


def _grads():
    """Two ranks' gradient trees: ragged sizes, an all-zero block, a
    None leaf, magnitudes over four decades."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(2):
        g = (rng.standard_normal(1000) * rng.uniform(0.001, 10, 1000)).astype(np.float32)
        g[256:512] = 0.0
        out.append({"w": g.reshape(8, 125),
                    "b": rng.standard_normal((3, 7)).astype(np.float32), "none": None})
    return out


@pytest.fixture(scope="module")
def raw():
    return j_build_model(j_reduce_config(REGISTRY["nllb600m"])).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def ranks(raw, tmp_path_factory):
    """Both spawns: tp2 over the whole grid and the compressed all-reduce,
    tp4 at paged horizon 16."""
    params, src, tmp = jax_tree_to_numpy(raw), _src(), str(tmp_path_factory.mktemp("tp"))
    tp2 = launch_ranks(tp_grid, 2, device="cpu", tmpdir=tmp,
                       args=(params, INT8 + QMM, src, _grads()))
    tp4 = launch_ranks(tp_grid, 4, device="cpu", tmpdir=tmp, args=(params, TP4, src, None))
    return {2: tp2, 4: tp4}


@pytest.fixture(scope="module")
def jax_grids():
    """The JAX single-device engine's grids: its paged engine at horizon
    16, built as the reference's test builds it (the reference's own
    invariant makes every layout and horizon serve these streams)."""
    kw = dict(common(True, 16), ctx=JCtx(compute_dtype=jnp.float32))
    kw.pop("smoke")
    pipe = j_deploy(j_reduce_config(REGISTRY["nllb600m"]), "int8", params=None,
                    init_seed=0, **kw)
    src = jnp.asarray(_src())
    return ([(list(o.token_ids), o.finish_reason)
             for o in pipe.translate(src, "ita", JSamplingParams(max_new_tokens=8))],
            [(list(o.token_ids), o.finish_reason)
             for o in pipe.translate(src, "hin", JSamplingParams(
                 max_new_tokens=8, temperature=0.8, top_k=8, seed=7))])


@pytest.fixture(scope="module")
def single(raw):
    """The port's single-device engines of the qmm specs, and one prefill's
    logits of the int8 engine."""
    params, src = jax_to_torch(raw), _src()
    out = {}
    for spec, paged, k in QMM:
        out[spec, paged, k] = grids(deploy("nllb600m", spec, params=params, device="cpu",
                                           **common(paged, k)), src)
    pipe = deploy("nllb600m", "int8", params=params, device="cpu", **common(False, 1))
    out["logits"] = prefill_logits(pipe, src, 7)
    return out


@pytest.mark.parametrize("case", INT8, ids=lambda c: f"{'paged' if c[1] else 'dense'}-h{c[2]}")
def test_tp2_int8_streams_equal_jax_single_device(case, ranks, jax_grids):
    for rank in ranks[2]:
        assert rank["grids"][case] == jax_grids, case
    assert all(r == "length" for g in jax_grids for _, r in g)


def test_tp4_paged_h16_streams_equal_jax_single_device(ranks, jax_grids):
    assert len(ranks[4]) == 4
    for rank in ranks[4]:
        assert rank["grids"][TP4[0]] == jax_grids
        assert rank["shard_heads"] == 1          # 4 heads over 4 ranks


@pytest.mark.parametrize("case", QMM, ids=lambda c: f"{c[0]}-{'paged' if c[1] else 'dense'}")
def test_tp2_qmm_specs_equal_port_single_device(case, ranks, single):
    for rank in ranks[2]:
        assert rank["grids"][case] == single[case], case


@pytest.mark.parametrize("tp", [2, 4])
def test_ranks_agree_and_name_their_backend(tp, ranks):
    first = ranks[tp][0]
    assert "over gloo" in first["mesh"] and "model" in first["mesh"]
    for other in ranks[tp][1:]:
        assert other["grids"] == first["grids"]
    for rank in ranks[tp]:
        keeps_shard, shard, whole = rank["weight_bytes"]
        assert keeps_shard and shard < whole


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_local_prefill_logits_match_one_device(tp, ranks, single):
    """The first case's engine (int8 dense at tp2, int8 paged at tp4):
    one prefill through the rank's own model and shard, f32."""
    want = single["logits"]
    for rank in ranks[tp]:
        err = np.abs(rank["logits"] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


def test_compressed_psum_byte_equal_reference(ranks):
    grads = _grads()
    stacked = {k: jnp.stack([jnp.asarray(g[k]) for g in grads]) for k in ("w", "b")}
    want = jax.vmap(lambda t: j_compressed_psum(t, "dp"), axis_name="dp")(stacked)
    for r, rank in enumerate(ranks[2]):
        got = rank["psum"]
        assert got["none"] is None
        for k in ("w", "b"):
            assert got[k].tobytes() == np.asarray(want[k][r]).tobytes(), k
    # the sum is close to the plain f32 sum (int8 grid, ~1e-2 of the absmax)
    plain = grads[0]["w"] + grads[1]["w"]
    assert np.abs(ranks[2][0]["psum"]["w"] - plain).max() <= 0.02 * np.abs(plain).max()
