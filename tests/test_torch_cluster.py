"""The port's replicated serving cluster on the CPU against the JAX
package's: the same requests through ``ServingCluster`` in both packages,
on one parameter set (the JAX init, converted) — fault-free, a replica
crash, a hang, a lost heartbeat, drain and rejoin, exhausted retries, the
loss of every replica, prefix affinity and seeded chaos over engine and
replica sites at once.

Each run must give the JAX cluster's greedy tokens exactly and the same
control-plane outcome: replica states, failovers by kind, dead letters
and their records, the fault log and the front door's routing counts.
Requests that finish must also match one engine serving them alone.
fp32 smoke engines, so tokens are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jsv
import repro_torch.serving as tsv
from repro.configs.registry import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import lm_tokens
from repro_torch.models.api import build_model
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serving.cluster import DEAD, DOWN, HEALTHY

PCFG = dict(page_size=8, n_pages=24, max_slots=4, max_blocks=6,
            segment_len=4, retain_pages=4)


@pytest.fixture(scope="module")
def engines():
    """One engine per package (tenants a and b, fp32 cache), shared by
    every cluster here: replicas multiply run state, not engines."""
    jcfg = jax_config("qwen2_7b", smoke=True).replace(act_dtype="float32")
    tcfg = get_config("qwen2_7b", smoke=True).replace(act_dtype="float32")
    jm = jax_build(jcfg, policy=JaxPolicy(default="fp32"))
    tm = build_model(tcfg, policy=PrecisionPolicy(default="fp32"),
                     device="cpu")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    lm = tm.empty_params()
    lm.load_state_dict(params_from_jax(params))
    jeng = jsv.PagedServingEngine(
        jm, jsv.PagedCacheConfig(**PCFG), cache_dtype=jnp.float32,
        tenants=[jsv.TenantConfig("a"), jsv.TenantConfig("b")])
    teng = tsv.PagedServingEngine(
        tm, tsv.PagedCacheConfig(**PCFG), cache_dtype=torch.float32,
        tenants=[tsv.TenantConfig("a"), tsv.TenantConfig("b")])
    base_reqs = _mk_reqs(jsv, tcfg.vocab_size)
    jeng.run(base_reqs, jax.tree.map(jnp.asarray, params))
    base = {r.rid: list(r.tokens) for r in base_reqs}
    return {"jax": (jsv, jeng, jax.tree.map(jnp.asarray, params)),
            "torch": (tsv, teng, lm), "vocab": tcfg.vocab_size,
            "base": base}


def _mk_reqs(sv, vocab, n=6, gen=12):
    return [sv.Request(rid=i, prompt=lm_tokens(16, vocab, seed=40 + i),
                       max_new_tokens=gen, tenant="a" if i % 2 else "b")
            for i in range(n)]


def _assert_pools_drained(cl):
    for rep in cl.replicas:
        if rep.fenced:
            continue
        s = rep.run.sched.rm.stats()
        assert s["free_pages"] + s["pinned_pages"] \
            == rep.run.pcfg.allocatable_pages, (rep.name, s)
        assert s["held_pages"] == s["pinned_pages"], (rep.name, s)


STAT_KEYS = ("n_replicas", "rounds", "n_finished", "n_dead_lettered",
             "n_migrated", "n_restarted", "n_drained", "replicas",
             "front_door", "dead_letter_records", "faults")


def _outcome(out, reqs, cl):
    return ({r.rid: (list(r.tokens), type(r.failure).__name__,
                     r.n_retries) for r in reqs},
            {k: out.get(k) for k in STAT_KEYS},
            {rep.name: rep.cause for rep in cl.replicas})


def _drain_rejoin(c, rnd):
    if rnd == 1:
        c.drain("r0")
        assert c._replica("r0").state == DOWN
    if rnd == 2:
        c.rejoin("r0")
        assert c._replica("r0").state == HEALTHY


def _kill_r0(c, rnd):
    if rnd == 2:
        c.kill("r0")


def _kill_all(c, rnd):
    if rnd == 1:
        c.kill("r0")
        c.kill("r1")


# name: (n_replicas, faults(sv) or None, on_round, cluster kwargs(sv))
SCENARIOS = {
    "fault_free": (3, None, None, lambda sv: {}),
    "replica_crash": (3, lambda sv: sv.FaultPlan.at(replica_crash=1),
                      None, lambda sv: {}),
    "replica_hang": (3, lambda sv: sv.FaultPlan.at(replica_hang=2), None,
                     lambda sv: {}),
    "heartbeat_loss": (2, lambda sv: sv.FaultPlan.at(heartbeat_loss=0),
                       None, lambda sv: {"health": sv.HealthPolicy(
                           suspect_after=1, dead_after=4)}),
    "drain_rejoin": (3, None, _drain_rejoin, lambda sv: {}),
    "exhausted_retries": (2, None, _kill_r0, lambda sv: {
        "recovery": sv.RecoveryPolicy(max_retries=0)}),
    "all_lost": (2, None, _kill_all, lambda sv: {}),
    "seeded_chaos_11": (3, lambda sv: sv.FaultPlan.seeded(
        11, rate=0.15, max_fires=2), None, lambda sv: {}),
    "seeded_chaos_5": (2, lambda sv: sv.FaultPlan.seeded(
        5, rate=0.2, max_fires=3), None, lambda sv: {}),
}


def _run(side, engines, name):
    sv, eng, params = engines[side]
    n, faults, hook, kw = SCENARIOS[name]
    cl = sv.ServingCluster(eng, params, n_replicas=n,
                           faults=None if faults is None else faults(sv),
                           **kw(sv))
    reqs = _mk_reqs(sv, engines["vocab"], n=4 if name == "all_lost" else 6)
    out = cl.run(reqs, on_round=hook)
    return out, reqs, cl


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cluster_equals_jax(engines, name):
    out_j, reqs_j, cl_j = _run("jax", engines, name)
    out, reqs, cl = _run("torch", engines, name)
    assert _outcome(out, reqs, cl) == _outcome(out_j, reqs_j, cl_j)
    assert out["n_finished"] + out["n_dead_lettered"] == len(reqs)
    assert all(r.t_done is not None for r in reqs)
    for r in reqs:
        if r.failure is None:
            assert list(r.tokens) == engines["base"][r.rid]
        else:
            assert isinstance(r.failure, (tsv.ReplicaLost,
                                          tsv.RequestFailed))
    if name != "all_lost":
        _assert_pools_drained(cl)
    states = [v["state"] for v in out["replicas"].values()]
    if name in ("fault_free", "heartbeat_loss", "drain_rejoin"):
        assert out["n_dead_lettered"] == 0
        assert all(s == HEALTHY for s in states)
    if name == "fault_free":
        assert sum(1 for v in out["replicas"].values()
                   if v["n_segments"]) >= 2        # the load spread
    if name in ("replica_crash", "replica_hang"):
        assert states.count(DEAD) == 1
    if name == "drain_rejoin":
        assert out["n_drained"] >= 1
        assert all(r.n_retries == 0 for r in reqs)
    if name == "exhausted_retries":
        lost = [r for r in reqs if r.failure is not None]
        assert lost and all(r.failure.replica == "r0"
                            and r.failure.site == "replica_crash"
                            for r in lost)


def test_rejoined_replica_serves_a_second_wave(engines):
    """After drain and rejoin the cluster serves another wave, tokens as
    the JAX cluster's and one engine's."""
    got = {}
    for side in ("jax", "torch"):
        sv, eng, params = engines[side]
        cl = sv.ServingCluster(eng, params, n_replicas=3)
        cl.run(_mk_reqs(sv, engines["vocab"]), on_round=_drain_rejoin)
        assert cl._replica("r0").live
        wave2 = _mk_reqs(sv, engines["vocab"])
        out2 = cl.run(wave2)
        got[side] = ({r.rid: list(r.tokens) for r in wave2},
                     out2["n_finished"], out2["front_door"])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == engines["base"]
    _assert_pools_drained(cl)


@pytest.mark.parametrize("take_down", ["kill", "drain"])
def test_rejoin_keeps_the_replaced_runs_terminal_requests(engines,
                                                          take_down):
    """A replica that finished requests, was taken down and then rejoined
    still counts them: every request ends in exactly one terminal state.
    The JAX cluster's rejoin drops the replaced run's finished list, so
    this case is held to one engine's tokens, not to the JAX cluster."""
    sv, eng, params = engines["torch"]
    cl = sv.ServingCluster(eng, params, n_replicas=3)

    def hook(c, rnd):
        if rnd == 1:
            getattr(c, take_down)("r1")
        elif not c._replica("r1").live and not c._replica("r1").retired:
            c.rejoin("r1")              # as soon as it is out

    reqs = _mk_reqs(sv, engines["vocab"], n=5, gen=2)
    reqs[-1].max_new_tokens = 12        # keeps the run going past it
    out = cl.run(reqs, on_round=hook)
    r1 = cl._replica("r1")
    assert r1.live and len(r1.retired) == 1
    assert r1.retired[0].sched.finished      # the case under test
    rids = [r.rid for r in cl.finished]
    assert sorted(rids) == [r.rid for r in reqs] and not cl.dead_lettered
    assert out["n_finished"] == len(reqs) and out["n_dead_lettered"] == 0
    assert out["replicas"]["r1"]["n_finished"] \
        == len(r1.retired[0].sched.finished)
    for r in reqs:
        assert list(r.tokens) == engines["base"][r.rid][:r.max_new_tokens]
    _assert_pools_drained(cl)


def test_prefix_affinity_routes_to_warm_replica(engines):
    got = {}
    for side in ("jax", "torch"):
        sv, eng, params = engines[side]
        shared = lm_tokens(16, engines["vocab"], seed=99)
        cl = sv.ServingCluster(eng, params, n_replicas=3)
        for rid in ("w", "x"):
            cl.run([sv.Request(rid=rid, prompt=shared.copy(),
                               max_new_tokens=4, tenant="a")])
        got[side] = (cl.front_door.stats(),
                     [list(r.tokens) for r in cl.finished])
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["affinity_hits"] >= 1


def test_from_plan_builds_the_plans_cluster(engines):
    """``ServingCluster.from_plan`` takes the replica count and health
    policy from the plan, as the JAX package's does."""
    sv, eng, params = engines["torch"]
    plan = tsv.ServingPlan.from_dict({
        **eng.plan.to_dict(), "n_replicas": 3,
        "health": {"suspect_after": 1, "dead_after": 5}})
    cl = tsv.ServingCluster.from_plan(eng.model, params, plan)
    assert len(cl.replicas) == 3 and cl.health.dead_after == 5
    assert cl.engine.plan == plan
    reqs = _mk_reqs(sv, engines["vocab"])
    cl.run(reqs)
    assert {r.rid: list(r.tokens) for r in reqs} == engines["base"]
