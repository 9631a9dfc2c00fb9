"""SmartConf-routed data-parallel replica serving.

Replicas in one process: :class:`ReplicaRouter` fronts N independent
:class:`~repro_torch.serve.engine.ServeEngine` replicas behind the ONE driver
surface ``OpenLoopDriver`` already speaks (``note_arrival`` / ``submit`` /
``tick`` / ``charge_tick_cost`` plus the summary properties), so every
existing harness — open-loop traffic, chaos, telemetry, the SLO bench —
composes with replication unchanged.

Dispatch is **weighted least-loaded**: a new request goes to the live
replica minimizing ``(pending_tokens + 1) / weight``.  With equal weights
that is plain least-loaded; the weights are where the paper's control loop
enters.  Each replica ``i`` carries a direct PerfConf
``route.replica_weights[i]`` on that replica's TTFT-p99 (hard goal =
``slo.ttft_s``): a replica whose tail latency blows the SLO — a straggler
device, a chaos storm, a noisy co-tenant — has its weight driven down, so
new work drains toward healthy replicas *while the SLO pressure lasts* and
recovers when it clears.  A static split cannot do both sides of that
trade-off, which is exactly the §6 regime-shift argument at replica
granularity.  The sensor is the router's own censored read (max of the
replica's controller TTFT-p99 and its head-of-line wait), so a *stalled*
replica — one that is not even ticking — still shows rising pressure; the
read passes through the router's ``sensor_tap`` (chaos NaN/spike/dropout
injection) and the SmartConf guardrails absorb whatever comes back, with
per-weight last-known-good fallback after repeated insanity.

Replica loss composes with :class:`~repro_torch.distributed.fault_tolerance.
PreemptionHandler`: when a replica's preemption flag trips, the router
runs its drain tick (the engine requeues in-flight work itself), then
**takes** the parked requests off the dead replica (:meth:`ServeEngine.
take_drained` — off its ledger too, so a rejoin cannot double-serve) and
resubmits them to the survivors.  When the flag clears the replica rejoins
the dispatch set and its weight controller resumes from wherever the
error history left it.

Replicas on one card share one params dict; each has its own block store,
queues and controllers.

Virtual-time cost: replicas tick concurrently in a real deployment, so the
merged per-tick stats carry the **max-cost** replica's work fields (what
the driver's :class:`~repro_torch.serve.traffic.TickCostModel` charges — the
slowest replica sets the tick's wall time) while throughput/bookkeeping
fields sum across replicas.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

from repro_torch.core import ControllerModel, GoalSpec, Guardrails, SmartConf
from repro_torch.core.smartconf import ConfRegistry
from .engine import Request, ServeEngine, TICK_STATS_KEYS
from .options import SLOSpec
from .traffic import TickCostModel

__all__ = ["ReplicaRouter"]

# merged-stats policy: these fields describe the tick's *compute cost* and
# come from the max-cost replica (concurrent replicas: the slowest one sets
# the tick's wall time); everything countable sums; the rest is max/any.
_COST_KEYS = ("pad_fraction", "dispatches", "prefill_tokens",
              "prefill_issued_tokens", "decode_slots", "spec_lanes",
              "spec_depth", "accept_rate", "kv_cache_share")
_SUM_KEYS = ("queued", "waiting", "running", "finished", "tokens", "hbm",
             "packed_segments", "decode_tokens", "kv_used_blocks",
             "kv_budget_blocks", "kv_capacity_blocks", "kv_frag_tokens",
             "preemptions", "rejected", "slo_good_tokens", "slo_miss_tokens",
             "prefix_hit_tokens", "prefix_cache_blocks")


class ReplicaRouter:
    """Weighted-least-loaded dispatch over N ServeEngine replicas.

    Parameters
    ----------
    engines:
        The replicas.  Each keeps its own queues, KV store, controllers
        and telemetry; the router never reaches into a tick.
    slo:
        TTFT goal for the per-replica weight controllers.  ``None`` (or
        ``adaptive=False``) freezes every weight at 1.0 — the static
        least-loaded baseline the bench compares against.
    stall:
        Optional chaos hook ``stall(tick) -> replica index | None``: the
        returned replica skips its tick this round (a stalled worker —
        queue builds, TTFT rises, the adaptive weights route around it).
    weights:
        Initial (and, when not adaptive, permanent) per-replica weights.
    """

    def __init__(self, engines: Sequence[ServeEngine], *,
                 clock: Callable[[], float] = time.monotonic,
                 slo: SLOSpec | None = None,
                 adaptive: bool = True,
                 weights: Sequence[float] | None = None,
                 weight_max: float = 8.0,
                 registry: ConfRegistry | None = None,
                 telemetry=None,
                 cost_model: TickCostModel | None = None,
                 stall: Callable[[int], int | None] | None = None) -> None:
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        self.engines = list(engines)
        self.clock = clock
        self.slo = slo
        self.stall = stall
        self.cost_model = cost_model or TickCostModel()
        self.registry = registry or ConfRegistry()
        self.telemetry = telemetry
        self.sensor_tap: Callable[[str, float], float] | None = None
        n = len(self.engines)
        self.weights = [float(w) for w in weights] if weights is not None \
            else [1.0] * n
        if len(self.weights) != n:
            raise ValueError(f"{len(self.weights)} weights for {n} replicas")
        self.adaptive = bool(adaptive and slo is not None)
        self._sc_weights: list[SmartConf | None] = [None] * n
        if self.adaptive:
            rails = Guardrails(perf_lo=0.0, perf_hi=3600.0,
                               max_step=weight_max / 4.0)
            for i in range(n):
                # alpha > 0: more weight -> more traffic -> higher TTFT,
                # so a replica past the (hard) SLO goal sheds weight and a
                # healthy one earns it back.  Continuous in
                # [0.05, weight_max]: a replica never reaches exactly 0
                # (the controller keeps a probe trickle to see recovery).
                self._sc_weights[i] = SmartConf(
                    f"route.replica_weights[{i}]", metric="ttft_p99_s",
                    goal=GoalSpec(float(slo.ttft_s), hard=True),
                    initial=self.weights[i], registry=self.registry,
                    guardrails=rails,
                    model=ControllerModel(alpha=0.5 * float(slo.ttft_s),
                                          lam=0.1, delta=1.3,
                                          conf_min=0.05,
                                          conf_max=float(weight_max),
                                          integer=False))
            if telemetry is not None:
                for sc in self._sc_weights:
                    sc.attach_audit(telemetry.audit)
        self._down: set[int] = set()
        self._parked: list[Request] = []    # drained with no live survivor
        self._route: dict[int, int] = {}    # req_id -> replica (note_arrival)
        self._ticked: list[bool] = [False] * n
        self.ticks_run = 0
        self.reroutes = 0                   # requests moved off dead replicas
        self.stalled_ticks = 0

    # ------------------------------------------------------------ dispatch
    def _live(self) -> list[int]:
        return [i for i in range(len(self.engines)) if i not in self._down]

    @staticmethod
    def _pending_tokens(eng: ServeEngine) -> int:
        """Token-denominated load: everything admitted but not finished."""
        load = 0
        for req in list(eng.waiting) + list(eng.queued):
            load += len(req.prompt) + req.max_new_tokens
        for reqs in (eng.prefilling, eng.running):
            for req in reqs.values():
                load += (len(req.prompt) - req.prefilled
                         + req.max_new_tokens - req.gen_count)
        return load

    def _accepting(self) -> list[int]:
        """Dispatchable replicas: live AND past any post-recovery drain
        (a rejoined engine refuses submissions until its first tick)."""
        return [i for i in self._live() if self.engines[i].accepting]

    def _pick(self) -> int | None:
        ready = self._accepting()
        if not ready:
            return None
        return min(ready, key=lambda i: (self._pending_tokens(self.engines[i])
                                         + 1.0) / max(self.weights[i], 1e-9))

    def note_arrival(self, req: Request) -> None:
        """Route at arrival time (the driver stamps arrivals before
        submitting) so the telemetry span opens on the replica that will
        actually serve the request."""
        i = self._pick()
        if i is None:
            return
        self._route[req.req_id] = i
        self.engines[i].note_arrival(req)

    def submit(self, req: Request):
        i = self._route.pop(req.req_id, None)
        if i is None or i in self._down or not self.engines[i].accepting:
            i = self._pick()
        if i is None:       # every replica down: park until one rejoins
            self._parked.append(req)
            return True
        return self.engines[i].submit(req)

    # ----------------------------------------------------------- sensing
    def _sense(self, name: str, value: float) -> float:
        """The one road a router sensor reading takes to a weight
        controller — through the chaos tap when installed, exactly like
        the engine's ``_sense``."""
        tap = self.sensor_tap
        return tap(name, value) if tap is not None else value

    def _replica_ttft(self, eng: ServeEngine) -> float:
        """Censored TTFT pressure: the controller p99 OR the head-of-line
        wait, whichever is worse.  A stalled replica stops ticking (its
        own sensors freeze), but its queue head keeps aging — this read
        rises anyway, which is what lets the weights route around a
        replica that cannot even report."""
        now = self.clock()
        wait = 0.0
        head = (eng.queued[0] if eng.queued
                else (eng.waiting[0] if eng.waiting else None))
        if head is not None:
            epoch = head.queued_t if head.queued_t is not None \
                else head.submitted_t
            wait = max(0.0, now - epoch)
        return max(eng.ttft_ctrl.p99(), wait)

    def _update_weights(self) -> None:
        if not self.adaptive:
            return
        for i in self._live():
            sc = self._sc_weights[i]
            sc.set_perf(self._sense(f"route.replica{i}.ttft_p99_s",
                                    self._replica_ttft(self.engines[i])))
            self.weights[i] = float(sc.get_conf())

    @property
    def sensor_faults(self) -> int:
        return sum(sc.sensor_faults for sc in self._sc_weights
                   if sc is not None)

    # ------------------------------------------------------------ one tick
    def tick(self) -> dict:
        if self.telemetry is not None:
            self.telemetry.audit.tick = self.ticks_run
        # replica loss first: a freshly-tripped replica drains itself on
        # its own tick, then the router takes the parked work to survivors
        for i, eng in enumerate(self.engines):
            if eng.preemption.triggered and i not in self._down:
                self._down.add(i)
                eng.tick()                       # the engine's drain tick
                moved = eng.take_drained()
                self.reroutes += len(moved)
                self._parked.extend(moved)
            elif not eng.preemption.triggered and i in self._down:
                self._down.discard(i)            # rejoin the dispatch set
        if self._parked and self._accepting():
            parked, self._parked = self._parked, []
            for req in parked:
                self.submit(req)
        self._update_weights()
        skip = self.stall(self.ticks_run) if self.stall is not None else None
        per, self._ticked = [], [False] * len(self.engines)
        for i in self._live():
            if i == skip:
                self.stalled_ticks += 1
                continue
            per.append(self.engines[i].tick())
            self._ticked[i] = True
        self.ticks_run += 1
        return self._merge(per)

    def _merge(self, per: list[dict]) -> dict:
        out = dict.fromkeys(TICK_STATS_KEYS, 0)
        out["tick"] = self.ticks_run - 1
        if not per:
            # every replica down or stalled: an idle router tick
            out["draining"] = bool(self._down)
            out["tp_shards"] = max(e.tp_shards for e in self.engines)
            out["admit_tier_max"] = 0
            return out
        cost = max(per, key=self.cost_model.cost)
        for k in _COST_KEYS:
            out[k] = cost[k]
        for k in _SUM_KEYS:
            out[k] = sum(p[k] for p in per)
        out["kv_over_budget"] = any(p["kv_over_budget"] for p in per)
        out["draining"] = any(p["draining"] for p in per) or bool(self._down)
        out["admit_tier_max"] = max(p["admit_tier_max"] for p in per)
        out["tp_shards"] = max(p["tp_shards"] for p in per)
        return out

    def charge_tick_cost(self, dt: float, *, decoded: bool = False) -> None:
        """Virtual-time feedback fans out to every replica that ticked:
        the merged cost is the tick's wall time for all of them."""
        for i, ticked in enumerate(self._ticked):
            if ticked:
                eng = self.engines[i]
                eng.charge_tick_cost(
                    dt, decoded=decoded and bool(eng.running))

    def note_chaos(self, name: str) -> None:
        for i in self._live():
            self.engines[i].note_chaos(name)
            break

    # --------------------------------------------------- driver summary API
    def _concat(self, attr: str) -> list:
        out = []
        for eng in self.engines:
            v = getattr(eng, attr)
            out.extend(v.values() if isinstance(v, dict) else v)
        return out

    @property
    def waiting(self):
        return self._concat("waiting") + self._parked

    @property
    def queued(self):
        return self._concat("queued")

    @property
    def prefilling(self):
        return self._concat("prefilling")

    @property
    def running(self):
        return self._concat("running")

    @property
    def finished(self):
        return self._concat("finished")

    @property
    def rejected(self) -> int:
        return sum(e.rejected for e in self.engines)

    @property
    def reject_counts(self):
        counts = type(self.engines[0].reject_counts)()
        for eng in self.engines:
            counts.update(eng.reject_counts)
        return counts

    @property
    def preemptions(self) -> int:
        return sum(e.preemptions for e in self.engines)

    @property
    def recompute_tokens(self) -> int:
        return sum(e.recompute_tokens for e in self.engines)

    @property
    def slo_good_requests(self) -> int:
        return sum(e.slo_good_requests for e in self.engines)

    @property
    def slo_miss_requests(self) -> int:
        return sum(e.slo_miss_requests for e in self.engines)

    @property
    def slo_good_tokens(self) -> int:
        return sum(e.slo_good_tokens for e in self.engines)

    @property
    def slo_miss_tokens(self) -> int:
        return sum(e.slo_miss_tokens for e in self.engines)

    @property
    def goodput_tokens(self) -> int:
        return self.slo_good_tokens

    @property
    def admit_tier_max(self) -> int:
        return max(e.admit_tier_max for e in self.engines)

    def close(self) -> None:
        for sc in self._sc_weights:
            if sc is not None:
                sc.close()
        for eng in self.engines:
            eng.close()
