"""Replicated serving: N engine runs behind a health-checked front door.

MetaML's flow-level resilience story (bad candidate stages are detected
and the flow routes around them) extends one level up in the serving
stack: a single :class:`~repro_torch.serving.engine.PagedServingEngine` run
already survives *intra-engine* faults (serving/recovery.py), but a
replica-level failure — the whole device state gone, the host loop
wedged — needs somewhere else to put the work.  This module provides
that somewhere else:

- A :class:`ServingCluster` holds ONE engine and N
  :class:`~repro_torch.serving.engine.EngineRun` replicas — each with its own
  page pool, block tables, tenant ledgers, and prefix trie — stepped
  round-robin at segment boundaries (single process, one device; the
  replication axis is state, not devices — each run's pool is its own
  allocation on the card).
- A :class:`FrontDoor` routes each arrival with *prefix affinity*: the
  replica whose prefix trie already holds the longest piece of the
  request's prompt wins (``PrefixCache.lookup`` is a pure read, so
  probing every replica is free of side effects); ties fall back to
  least-loaded (most free pages, then fewest resident requests).
- A boundary-progress *health model*: a replica that misses
  ``suspect_after`` consecutive boundary heartbeats is SUSPECT,
  ``dead_after`` is DEAD; an :class:`EngineStalledError` from its
  watchdog is immediately DEAD.  DEAD replicas are permanently fenced —
  never stepped again — which is the cluster's no-double-completion
  guarantee.
- *Failover* reuses the preemption and recovery machinery wholesale
  (serving/resources.py, recovery.py): host swap images
  are device-agnostic (a restore scatters ``swap.host_k`` into freshly
  allocated pages — ``swap.pages`` is never read), so a preempted or
  quarantined request whose image passes its CRC migrates to a
  surviving replica through the ordinary preempted-restore lane, with
  a prefix-trie re-match on the new replica.  Requests without a
  salvageable image restart from scratch (greedy decode is
  deterministic, so the regenerated stream is bit-identical); work
  lost this way costs one retry, and exhausted retries dead-letter
  with a typed :class:`ReplicaLost`.
- Graceful :meth:`ServingCluster.drain` for rolling restarts: stop
  routing to the replica, evacuate every resident request as a
  verified host image, migrate them out, and :meth:`rejoin` later with
  a cold trie that re-warms through prefix-affinity misses.

Replica-level fault sites (``replica_crash``, ``replica_hang``,
``heartbeat_loss`` — :data:`~repro_torch.serving.faults.REPLICA_SITES`) ride
the same seed-driven opportunity-counted FaultPlan as the engine sites:
the cluster probes each live replica once per round, so a chaos run
replays bit-exactly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.serving.engine import EngineRun, PagedServingEngine
from repro_torch.serving.faults import FaultPlan, image_checksum
from repro_torch.serving.observe import Observability
# re-exported for back-compat: HealthPolicy moved to serving/plan.py so a
# ServingPlan can carry the cluster shape without importing this module
from repro_torch.serving.plan import HealthPolicy, ServingPlan
from repro_torch.serving.recovery import (EngineStalledError, RecoveryPolicy,
                                    RequestFailed)
from repro_torch.serving.scheduler import Request

# Replica lifecycle.  HEALTHY/SUSPECT step and accept routes; DRAINING
# is the transient inside drain(); DOWN is drained-and-out (rejoinable);
# DEAD is fenced forever (a rejoin under the same name is a fresh run).
HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
DRAINING = "DRAINING"
DOWN = "DOWN"
DEAD = "DEAD"
_LIVE = (HEALTHY, SUSPECT)


@dataclasses.dataclass(frozen=True)
class ReplicaLost(RequestFailed):
    """Terminal record for a request that died *because its replica
    did*: the failover path ran out of retries or out of surviving
    replicas.  ``site`` carries the replica-level fault site that took
    the replica down; ``replica`` names it."""
    replica: str = "?"

    def record(self) -> dict:
        return {**super().record(), "replica": self.replica}


@dataclasses.dataclass
class Replica:
    """One replica's control-plane state; the data plane is ``run``."""
    name: str
    run: EngineRun
    state: str = HEALTHY
    missed: int = 0                     # consecutive heartbeat misses
    crashed: bool = False               # device state destroyed
    hung: bool = False                  # host loop wedged, state intact
    fenced: bool = False                # salvaged; never stepped again
    cause: str = "heartbeat_loss"       # site that took it down

    @property
    def live(self) -> bool:
        return self.state in _LIVE


class FrontDoor:
    """Prefix-affinity router over the cluster's replicas.

    Routing key, best first: longest trie prefix match for the prompt
    (affinity — the replica that already holds the K/V serves the
    request without re-prefilling it), then most free pages, then
    fewest resident requests, then index (deterministic ties).  Only
    HEALTHY replicas are candidates; SUSPECT ones are a fallback so a
    transiently-flapping cluster keeps admitting; DRAINING/DOWN/DEAD
    never route.  Returns None when nothing can take the request.
    """

    def __init__(self, replicas: list[Replica], obs=None):
        self.replicas = replicas
        obs = obs if obs is not None else Observability.disabled()
        # labeled by the TARGET replica; the historical totals read back
        # through the registry as thin views
        self._c_routed = obs.counter(
            "serving_frontdoor_routed_total",
            "requests routed, by target replica", ("replica",))
        self._c_aff = obs.counter(
            "serving_frontdoor_affinity_hits_total",
            "routes that hit a prefix-affinity match", ("replica",))

    @property
    def routed(self) -> int:
        return int(self._c_routed.total())

    @property
    def affinity_hits(self) -> int:
        return int(self._c_aff.total())

    def _affinity(self, rep: Replica, req: Request) -> int:
        pc = rep.run.sched.prefix_cache
        if pc is None:
            return 0
        return pc.lookup(req.prompt).n_tokens    # pure read

    def route(self, req: Request) -> Replica | None:
        cands = [r for r in self.replicas if r.state == HEALTHY]
        if not cands:
            cands = [r for r in self.replicas if r.state == SUSPECT]
        if not cands:
            return None
        scored = []
        for i, rep in enumerate(self.replicas):
            if rep not in cands:
                continue
            run = rep.run
            busy = len(run.sched.running) + len(run.sched.pending)
            scored.append((-self._affinity(rep, req),
                           -run.sched.allocator.n_free, busy, i, rep))
        scored.sort(key=lambda t: t[:4])
        aff, _free, _busy, _i, best = scored[0]
        self._c_routed.inc(1.0, (best.name,))
        if aff < 0:
            self._c_aff.inc(1.0, (best.name,))
        return best

    def stats(self) -> dict:
        return {"routed": self.routed,
                "affinity_hits": self.affinity_hits,
                "affinity_rate": (self.affinity_hits / self.routed
                                  if self.routed else 0.0)}


class ServingCluster:
    """N replicas of one engine, stepped round-robin, with
    health-checked routing and cross-replica failover.

    One :class:`~repro_torch.serving.faults.FaultPlan` covers the whole
    cluster: engine sites count opportunities inside each replica's
    ``step()`` (in round-robin order) and replica sites are probed here,
    once per live replica per round, in index order — so the combined
    schedule replays bit-exactly for a given request set.
    """

    @classmethod
    def from_plan(cls, model, params, plan: ServingPlan, *,
                  faults: FaultPlan | None = None,
                  recovery: RecoveryPolicy | None = None,
                  obs: Observability | None = None
                  ) -> "ServingCluster":
        """Deploy a :class:`~repro_torch.serving.plan.ServingPlan`: build the
        engine from the plan's cache geometry / prefill mode /
        tenant roster, then the cluster from its shape (``n_replicas``,
        ``health``).  The one-call counterpart of the searched-plan JSON
        the SERVE task emits."""
        engine = PagedServingEngine.from_plan(model, plan, faults=faults,
                                              recovery=recovery)
        return cls(engine, params, n_replicas=plan.n_replicas,
                   faults=faults, recovery=recovery, health=plan.health,
                   obs=obs)

    def __init__(self, engine: PagedServingEngine, params,
                 n_replicas: int = 2, *,
                 faults: FaultPlan | None = None,
                 recovery: RecoveryPolicy | None = None,
                 health: HealthPolicy | None = None,
                 obs: Observability | None = None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.engine = engine
        self.params = params
        self.faults = faults if faults is not None else engine.faults
        self.recovery = recovery
        self.health = health if health is not None else HealthPolicy()
        t0 = time.perf_counter()
        self.clock = lambda: time.perf_counter() - t0
        # one metrics store + tracer for the whole cluster; each replica
        # run gets a for_replica() view that binds its label value
        if obs is None:
            obs = Observability.from_policy(engine.plan.observability)
        self.obs = obs
        self.tracer = obs.tracer
        self._c_failover = obs.counter(
            "serving_failover_total",
            "cross-replica request moves, by kind", ("kind",))
        self._c_health = obs.counter(
            "serving_replica_health_transitions_total",
            "replica state transitions", ("replica", "state"))
        self._c_miss = obs.counter(
            "serving_heartbeat_misses_total",
            "consecutive-miss ticks charged to a replica", ("replica",))
        # durable cluster: one root journal (the plan JSON + cluster-
        # level dead letters) and one subdirectory journal per replica,
        # all under plan.durability.journal_dir; RestartRecovery merges
        # the per-replica streams per request on replay
        self.journal = None
        pol = engine.plan.durability
        if pol.enabled:
            from repro_torch.serving.journal import JournalWriter
            plan = dataclasses.replace(engine.plan,
                                       n_replicas=n_replicas)
            self.journal = JournalWriter.from_policy(pol, plan=plan,
                                                     faults=self.faults)
        self.replicas = [Replica(name=f"r{i}",
                                 run=self._fresh_run(f"r{i}"))
                         for i in range(n_replicas)]
        self.front_door = FrontDoor(self.replicas, obs=obs)
        self.dead: list[Request] = []   # cluster-level dead letters
        self.rounds = 0
        if self.faults is not None:
            # re-attach the taps at cluster scope: replica-level sites
            # fire here (outside any single run), so the trace hook's
            # boundary must be the round counter, not one run's boundary
            self.faults.metrics = obs.counter(
                "serving_fault_fires_total",
                "injected fault fires, by site", ("site",))
            if self.tracer is not None:
                self.faults.trace_hook = (
                    lambda site, k: self.tracer.event(
                        None, "FAULT", self.rounds, self.clock(),
                        site=site, opportunity=k))

    # failover totals as registry thin views
    @property
    def n_migrated(self) -> int:        # failovers via verified image
        return int(self._c_failover.value(("migrated",)))

    @property
    def n_restarted(self) -> int:       # failovers via full restart
        return int(self._c_failover.value(("restarted",)))

    @property
    def n_drained(self) -> int:         # graceful drain migrations
        return int(self._c_failover.value(("drained",)))

    def _fresh_run(self, name: str = "") -> EngineRun:
        journal = None
        pol = self.engine.plan.durability
        if pol.enabled and name:
            from repro_torch.serving.journal import JournalWriter
            # a rejoin reopens the replica's existing subdirectory and
            # appends (the writer repairs any torn tail first)
            journal = JournalWriter.from_policy(pol, subdir=name,
                                                faults=self.faults)
        return EngineRun(self.engine, self.params, faults=self.faults,
                         recovery=self.recovery, clock=self.clock,
                         journal=journal,
                         obs=self.obs.for_replica(name or "r?"))

    def _replica(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica named {name!r}")

    # ----------------------------------------------------------- routing
    def submit(self, req: Request) -> bool:
        """Route one request; False means it dead-lettered unrouted."""
        rep = self.front_door.route(req)
        if rep is None:
            self._cluster_dead_letter(req, "no live replica to route to",
                                      site="no_replica", replica="-")
            return False
        rep.run.submit(req)
        return True

    # ------------------------------------------------------ health model
    def _set_state(self, rep: Replica, state: str) -> None:
        if rep.state != state:
            rep.state = state
            self._c_health.inc(1.0, (rep.name, state))

    def _beat(self, rep: Replica) -> None:
        rep.missed = 0
        if rep.state == SUSPECT:
            self._set_state(rep, HEALTHY)

    def _miss(self, rep: Replica) -> None:
        rep.missed += 1
        self._c_miss.inc(1.0, (rep.name,))
        if rep.missed >= self.health.dead_after:
            self._set_state(rep, DEAD)
        elif rep.missed >= self.health.suspect_after:
            self._set_state(rep, SUSPECT)

    # -------------------------------------------------------- one round
    def step_round(self) -> bool:
        """Step every live replica one boundary, update health, and
        salvage any replica that went DEAD.  Returns True when some
        replica made boundary progress (ran a segment / admitted)."""
        self.rounds += 1
        progress = False
        for rep in self.replicas:
            if not rep.live or rep.fenced:
                continue
            if not (rep.crashed or rep.hung) and self.faults is not None:
                # probe both sites every round a replica is actually
                # stepping — opportunity counts stay replayable
                if self.faults.should_fire("replica_crash"):
                    rep.crashed, rep.cause = True, "replica_crash"
                if self.faults.should_fire("replica_hang") \
                        and not rep.crashed:
                    rep.hung, rep.cause = True, "replica_hang"
            if rep.crashed or rep.hung:
                self._miss(rep)         # not stepping: heartbeats cease
                continue
            try:
                outcome = rep.run.step()
                if outcome == "idle" and rep.run.has_work:
                    # queued work that cannot admit: tick this replica's
                    # own watchdog rather than busy-spin (mirrors the
                    # single-engine run loop)
                    rep.run.note_stall()
            except EngineStalledError:
                self._set_state(rep, DEAD)
                rep.cause = "watchdog"
                continue
            if outcome != "idle":
                progress = True
            if self.faults is not None \
                    and self.faults.should_fire("heartbeat_loss"):
                self._miss(rep)         # dropped beat, stepping intact
            else:
                self._beat(rep)
        for rep in self.replicas:
            if rep.state == DEAD and not rep.fenced:
                self._salvage(rep)
        return progress

    # ---------------------------------------------------------- failover
    def _scrub(self, req: Request) -> None:
        """Strip every per-replica residue off a migrating request: the
        slot, pages, billing, and sharing state all referenced the dead
        replica's pool and mean nothing on the target (its admission
        re-plans them, including the trie re-match)."""
        req.slot = None
        req.pages = None
        req.charged = 0
        req.shared_tokens = 0
        req.shared_pages = 0
        req.cow_src = None
        req.cow_dst = None
        req.restore_blocks = (0, 0)
        req.stalled = False
        req.protected = False

    def _image_intact(self, req: Request) -> bool:
        sw = req.swap
        if sw is None or sw.host_k is None or sw.host_v is None:
            return False
        return sw.checksum is None \
            or sw.checksum == image_checksum(sw.host_k, sw.host_v)

    def _cluster_dead_letter(self, req: Request, reason: str, *,
                             site: str, replica: str) -> None:
        req.swap = None
        req.failure = ReplicaLost(rid=req.rid, tenant=req.tenant,
                                  reason=reason, boundary=self.rounds,
                                  retries=req.n_retries, site=site,
                                  ckpt_tokens=req.ckpt_tokens,
                                  replica=replica)
        req.t_done = self.clock()
        self.dead.append(req)
        if self.journal is not None:
            self.journal.dead_letter(req.failure.record())

    def _salvage(self, rep: Replica) -> None:
        """Fence a DEAD replica and fail its requests over.  Host-side
        state survives the death of device state: queued/quarantined
        requests keep their swap images (CRC-verified here, exactly
        once); running requests lost their pages — and, without an
        image, their generated tokens, costing them a retry."""
        rep.fenced = True
        run = rep.run
        reqs = [run.sched.running[s] for s in sorted(run.sched.running)]
        reqs += run.sched.rm.drain_queued()
        reqs += run.rec.drain_quarantined()
        for req in reqs:
            had_work = bool(req.tokens)
            if req.swap is not None:
                if self._image_intact(req):
                    req.swap.verified = True
                else:
                    req.swap = None     # corrupt/lost: fall through
            self._scrub(req)
            if req.swap is None and had_work:
                # committed work is gone; the restart burns a retry
                req.tokens = []
                req.ckpt_tokens = 0
                req.n_retries += 1
                if req.n_retries > run.policy.max_retries:
                    self._cluster_dead_letter(
                        req, f"retries exhausted after loss of replica "
                             f"{rep.name}", site=rep.cause,
                        replica=rep.name)
                    continue
            elif req.swap is None:
                req.tokens = []
                req.ckpt_tokens = 0
            target = self.front_door.route(req)
            if target is None:
                self._cluster_dead_letter(
                    req, f"no surviving replica after loss of "
                         f"{rep.name}", site=rep.cause, replica=rep.name)
                continue
            target.run.sched.rm.requeue(req)
            kind = "migrated" if req.swap is not None else "restarted"
            self._c_failover.inc(1.0, (kind,))
            if self.tracer is not None:
                self.tracer.event(req.rid, "MIGRATE", self.rounds,
                                  self.clock(), src=rep.name,
                                  dst=target.name, kind=kind,
                                  cause=rep.cause)

    # ------------------------------------------------- rolling restarts
    def drain(self, name: str) -> int:
        """Gracefully take a replica out: stop routing to it, evacuate
        every resident request as a verified host image, migrate them to
        the survivors (no retry cost — nothing was lost), and leave the
        replica DOWN, ready to :meth:`rejoin`.  Returns the number of
        requests moved."""
        rep = self._replica(name)
        if not rep.live:
            raise ValueError(f"cannot drain replica {name!r} in state "
                             f"{rep.state}")
        self._set_state(rep, DRAINING)
        moved = rep.run.evacuate()
        self._set_state(rep, DOWN)
        for req in moved:
            if req.swap is not None and self._image_intact(req):
                req.swap.verified = True
            elif req.swap is not None:
                req.swap = None
                req.tokens = []
                req.ckpt_tokens = 0
            self._scrub(req)
            target = self.front_door.route(req)
            if target is None:
                self._cluster_dead_letter(
                    req, f"no replica to absorb drain of {name}",
                    site="drain", replica=name)
                continue
            target.run.sched.rm.requeue(req)
            self._c_failover.inc(1.0, ("drained",))
            if self.tracer is not None:
                self.tracer.event(req.rid, "MIGRATE", self.rounds,
                                  self.clock(), src=name,
                                  dst=target.name, kind="drained",
                                  cause="drain")
        return len(moved)

    def close_journals(self) -> None:
        """Flush + close every journal writer (root and per-replica).
        A no-op without durability, and after an injected crash (the
        crashed writer is already closed without flushing)."""
        if self.journal is not None:
            self.journal.close()
        for rep in self.replicas:
            if rep.run.journal is not None:
                rep.run.journal.close()

    def rejoin(self, name: str) -> None:
        """Bring a DOWN (or replaced-DEAD) replica back with a fresh
        run: empty pool, cold prefix trie (it re-warms through
        prefix-affinity misses), clean health."""
        rep = self._replica(name)
        if rep.live:
            raise ValueError(f"replica {name!r} is already live")
        if rep.run.journal is not None:
            rep.run.journal.close()
        rep.run = self._fresh_run(rep.name)
        self._set_state(rep, HEALTHY)
        rep.missed = 0
        rep.crashed = rep.hung = rep.fenced = False
        rep.cause = "heartbeat_loss"

    def kill(self, name: str) -> None:
        """Deterministically crash a replica (tests/benches): it goes
        through the same detect → fence → salvage path an injected
        ``replica_crash`` does."""
        rep = self._replica(name)
        rep.crashed, rep.cause = True, "replica_crash"

    # ---------------------------------------------------------- run loop
    def run(self, requests: list[Request],
            on_round: Callable[["ServingCluster", int], None]
            | None = None) -> dict:
        """Serve ``requests`` (honoring arrival offsets) through the
        front door to completion across the replicas.  ``on_round`` runs
        after every round — the hook tests/benches use to kill, drain,
        or rejoin replicas mid-burst."""
        queue = sorted(requests, key=lambda q: q.arrival)
        nxt = 0
        while nxt < len(queue) or any(r.live and r.run.has_work
                                      for r in self.replicas):
            now = self.clock()
            while nxt < len(queue) and queue[nxt].arrival <= now:
                self.submit(queue[nxt])
                nxt += 1
            progress = self.step_round()
            if on_round is not None:
                on_round(self, self.rounds)
            if not progress and nxt < len(queue) \
                    and not any(r.live and r.run.has_work
                                for r in self.replicas):
                wait = queue[nxt].arrival - self.clock()
                if wait > 0:
                    time.sleep(wait)
        out = self.stats()
        pol = self.obs.policy
        if self.obs.enabled and pol is not None and pol.export_dir:
            out["exports"] = self.obs.export(pol.export_dir)
        return out

    # ------------------------------------------------------------- stats
    @property
    def finished(self) -> list[Request]:
        """Completed requests across all replicas (including fenced ones
        — completion before death still counts)."""
        out: list[Request] = []
        for rep in self.replicas:
            out.extend(rep.run.sched.finished)
        return out

    @property
    def dead_lettered(self) -> list[Request]:
        """Dead letters across replicas plus cluster-level ReplicaLost."""
        out: list[Request] = []
        for rep in self.replicas:
            out.extend(rep.run.rec.dead)
        out.extend(self.dead)
        return out

    def stats(self) -> dict[str, Any]:
        dead = self.dead_lettered
        out = {"n_replicas": len(self.replicas),
               "rounds": self.rounds,
               "n_finished": len(self.finished),
               "n_dead_lettered": len(dead),
               "n_migrated": self.n_migrated,
               "n_restarted": self.n_restarted,
               "n_drained": self.n_drained,
               "replicas": {r.name: {"state": r.state,
                                     "missed": r.missed,
                                     "fenced": r.fenced,
                                     "n_finished":
                                         len(r.run.sched.finished),
                                     "n_segments": r.run.n_segments}
                            for r in self.replicas},
               "front_door": self.front_door.stats(),
               "dead_letter_records": [r.failure.record() for r in dead
                                       if r.failure is not None],
               "metrics": self.obs.summary()}
        if self.faults is not None:
            out["faults"] = self.faults.summary()
        return out
