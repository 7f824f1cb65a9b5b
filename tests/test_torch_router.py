"""The replica router and ``deploy_replicas`` against the reference's (on
the CPU).

The port's ``ReplicaRouter`` and the reference's get the same seeded
submit / step / abort sequences over stub engines (the reference's
``tests/test_cluster.py::_StubEngine`` pattern, grown a queue, slots and
aborts): placements, global ids, remapped outputs, saturation failover
and the cluster-wide ``EngineSaturated`` (its pending and limit totals)
are equal at every operation. ``deploy_replicas("nllb600m", "int8",
replicas=2, smoke=True)`` serves the eval suite's greedy pair grid equal
to a lone deploy and to the reference's engine on the same weights;
merged counters and histograms are the replicas' sums, and
``prometheus()`` carries the merged and the ``{replica="i"}`` sections.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bridge import jax_to_torch  # noqa: E402

from repro.cluster import ReplicaRouter as JReplicaRouter  # noqa: E402
from repro.configs import REGISTRY, reduce_config as j_reduce_config  # noqa: E402
from repro.eval import decode_token_grid as j_decode_token_grid  # noqa: E402
from repro.models import Ctx as JCtx  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import EngineSaturated as JEngineSaturated  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import deploy as j_deploy  # noqa: E402
from repro_torch.cluster import ReplicaRouter, deploy_replicas  # noqa: E402
from repro_torch.eval import assert_serving_equivalence, decode_token_grid  # noqa: E402
from repro_torch.models import Ctx  # noqa: E402
from repro_torch.serving import EngineSaturated, SamplingParams, deploy  # noqa: E402


@dataclasses.dataclass
class _Out:
    request_id: int
    finish_reason: str


class _StubEngine:
    """A ServeEngine stand-in: a bounded queue, ``slots`` active requests,
    one retirement per step, aborts; no model."""

    def __init__(self, saturated_cls, max_pending=None, slots=1):
        self.saturated_cls, self.max_pending, self.slots = saturated_cls, max_pending, slots
        self.queue, self.active, self.finished, self._next = [], [], [], 0

    @property
    def num_pending(self):
        return len(self.queue)

    @property
    def num_active(self):
        return len(self.active)

    def submit(self, request, params=None, on_token=None):
        if self.max_pending is not None and len(self.queue) >= self.max_pending:
            raise self.saturated_cls(len(self.queue), self.max_pending)
        lid, self._next = self._next, self._next + 1
        self.queue.append(lid)
        return lid

    def step(self, horizon=None):
        if self.active:
            self.finished.append(_Out(self.active.pop(0), "length"))
        while self.queue and len(self.active) < self.slots:
            self.active.append(self.queue.pop(0))

    def serve_rounds(self, horizon=None):
        while self.queue or self.active:
            self.step(horizon)
            yield

    def take_finished(self):
        out, self.finished = self.finished, []
        return out

    def abort(self, lid):
        for where in (self.queue, self.active):
            if lid in where:
                where.remove(lid)
                return _Out(lid, "abort")
        return None


def _drive(router_cls, saturated_cls, sp_cls, seed, pendings):
    """A seeded sequence of submits (mixed priorities), steps, aborts and
    one drain; every operation's result, and the placement of every
    live request after it."""
    rng = np.random.default_rng(seed)
    router = router_cls([_StubEngine(saturated_cls, p, slots=1 + i % 2)
                         for i, p in enumerate(pendings)])
    log, gids = [], []
    for _ in range(60):
        op = rng.choice(["submit"] * 7 + ["step"] * 2 + ["abort"])
        if op == "submit":
            sp = sp_cls(max_new_tokens=1, priority=int(rng.integers(0, 4)))
            try:
                gid = router.submit({"tokens": [0]}, sp)
                gids.append(gid)
                log.append(("gid", gid))
            except saturated_cls as e:
                log.append(("saturated", e.pending, e.limit))
        elif op == "step":
            log.append(("step", [(o.request_id, o.finish_reason) for o in router.step()]))
        else:
            gid = int(rng.choice(gids)) if gids and rng.random() < 0.8 else 10_000
            out = router.abort(gid)
            log.append(("abort", None if out is None else (out.request_id, out.finish_reason)))
        log.append(("owner", sorted(router._owner.items()), router.num_pending,
                    router.num_active))
    log.append(("drain", sorted((o.request_id, o.finish_reason)
                                for o in router.run_until_drained())))
    log.append(("empty", router._owner, router._local))
    return log


SEQUENCES = [(0, (1, 2)), (1, (1, 1, 3)), (2, (2, None)), (3, (1, 1, 1, 1))]


@pytest.mark.parametrize("seed,pendings", SEQUENCES)
def test_router_equals_reference_on_stub_sequences(seed, pendings):
    want = _drive(JReplicaRouter, JEngineSaturated, JSamplingParams, seed, pendings)
    got = _drive(ReplicaRouter, EngineSaturated, SamplingParams, seed, pendings)
    assert got == want
    if None not in pendings:              # bounded everywhere: the cluster-wide raise
        assert any(e[0] == "saturated" for e in want)


def test_stub_sequences_cover_failover_and_aborts():
    logs = [_drive(ReplicaRouter, EngineSaturated, SamplingParams, *c) for c in SEQUENCES]
    events = [e for log in logs for e in log]
    assert any(e[0] == "abort" and e[1] is not None for e in events)   # an owner aborted
    assert any(e[0] == "abort" and e[1] is None for e in events)       # unknown / finished
    # a failover: a replica other than the least-loaded one took a request
    assert len({o[1][0] for e in events if e[0] == "owner" for o in e[1]}) >= 3


def test_router_needs_a_replica_and_streams_no_single_request():
    with pytest.raises(ValueError, match="at least one replica"):
        ReplicaRouter([])
    with pytest.raises(NotImplementedError, match="on_token"):
        ReplicaRouter([_StubEngine(EngineSaturated)]).stream_request({"tokens": [1]})


CTX = dict(slots=2, max_len=16, paged=True, page_size=4, horizon=4)
PAIRS = [("hin", "eng"), ("eng", "hin")]


@pytest.fixture(scope="module")
def weights():
    return j_build_model(j_reduce_config(REGISTRY["nllb600m"])).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def cluster(weights):
    params = jax_to_torch(weights)
    kw = dict(CTX, ctx=Ctx(compute_dtype=torch.float32), params=params, device="cpu")
    return (deploy_replicas("nllb600m", "int8", replicas=2, smoke=True, **kw),
            deploy("nllb600m", "int8", smoke=True, **kw))


def test_deploy_replicas_grid_equals_single_engine_and_reference(cluster, weights):
    pipe, single = cluster
    assert isinstance(pipe.engine, ReplicaRouter) and len(pipe.engine.replicas) == 2
    assert pipe.engine.max_len == single.engine.max_len
    assert_serving_equivalence(pipe, single, pair_list=PAIRS, label="dp2 router",
                               n_sent=2, max_new_tokens=6)
    jpipe = j_deploy("nllb600m", "int8", smoke=True, params=weights,
                     ctx=JCtx(compute_dtype=jnp.float32), **CTX)
    want = j_decode_token_grid(jpipe, PAIRS, n_sent=2, max_new_tokens=6)
    assert decode_token_grid(pipe, PAIRS, n_sent=2, max_new_tokens=6) == want
    # both replicas served
    assert all(e.metrics().synced_tokens > 0 for e in pipe.engine.replicas)


def test_merged_metrics_are_the_replica_sums(cluster):
    router = cluster[0].engine
    m = router.metrics()
    per = [e.metrics() for e in router.replicas]
    for field in ("synced_tokens", "decode_syncs", "decode_steps", "kv_cache_bytes",
                  "admission_rejections", "preemptions"):
        assert getattr(m, field) == sum(getattr(p, field) for p in per), field
    merged = router.merged_latency_histograms()
    for name in ("ttft_ms", "tpot_ms"):
        hs = [e.latency_histograms()[name] for e in router.replicas]
        assert merged[name].count == sum(h.count for h in hs) > 0
        assert merged[name].counts == [sum(h.counts[i] for h in hs)
                                       for i in range(merged[name].n_buckets)]
    text = router.prometheus()
    assert "# TYPE repro_cluster_ttft_ms histogram" in text
    for i in range(2):
        assert f'repro_cluster_replica_synced_tokens{{replica="{i}"}}' in text
    assert text.count("# TYPE repro_cluster_replica_synced_tokens counter") == 1


def test_deploy_replicas_refuses_composed_stacks():
    """A composed stack (tp > 1) runs on the replicas x tp ranks of
    ``launch_ranks`` (tests/test_torch_tp_lm.py): outside such a process
    group it raises before any build work; no replica count is refused
    but 0."""
    for replicas in (1, 2):
        with pytest.raises(RuntimeError, match=f"needs a process group of {2 * replicas} "
                                               "ranks"):
            deploy_replicas("nllb600m", "int8", replicas=replicas, tp=2, smoke=True,
                            device="cpu")
    with pytest.raises(ValueError, match="replicas must be"):
        deploy_replicas("nllb600m", "int8", replicas=0, smoke=True, device="cpu")
