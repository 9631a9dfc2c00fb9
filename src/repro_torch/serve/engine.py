"""Continuous-batching serve engine with SmartConf-governed admission.

The reference engine's main path (paper §6.2, Fig. 6/8): two PerfConfs
share the hard ``hbm_bytes`` constraint —

  * ``serve.max_queue_tokens``  (indirect; deputy = tokens waiting in the
    admission queue);
  * ``serve.kv_block_budget``   (indirect; deputy = live KV blocks) —

both ``super_hard`` on the same metric, so their controllers split the
error via the §5.4 interaction factor (N = 2).  A third, soft PerfConf
``serve.prefill_chunk_tokens`` bounds decode-latency interference from long
prefills by capping how many tokens one tick's packed stream may carry.

Hot path (one ``tick``): controller updates -> admission -> scheduling
(slot + paged KV lease) -> ONE model dispatch -> completion/free.

  * **Unified prefill+decode ticks** (``prefill_mode="auto"`` or
    ``"packed"``) — each tick packs prefill chunks from as many requests
    as fit under the ``serve.prefill_chunk_tokens`` budget PLUS one
    length-1 decode segment per running slot into a single ``[1, width]``
    stream (``step_packed``); a tick with no prefill work runs the decode
    step instead.  Either way one dispatch per tick.
  * **Split ticks** (the reference's oracle modes) — a prefill dispatch,
    then the decode step over every running slot.  ``"bucketed"``
    advances every prefilling slot by one padded chunk of a power-of-two
    width capped by ``serve.prefill_chunk_tokens`` (``prefill_chunk``):
    at most two dispatches a tick.  ``"legacy"`` (alias ``"one_shot"``)
    prefills each admitted request's whole prompt at once (``prefill``)
    into fresh dense caches and merges them into its slot: one dispatch
    per admission plus the decode step.  Legacy needs dense KV; the
    recurrent kinds prefill through their one-shot forms.
  * **Paged KV** (``kv_mode="auto"`` on attention-only archs) — per-layer
    physical block stores ``[capacity, Kv, T, D]`` addressed through
    per-sequence block tables (``serve/paging.py``).
    ``serve.kv_block_budget`` bounds the physical store: a cut below
    occupancy preempts the lowest-priority sequence back to the queue and
    shrinks the store tensors, releasing device memory.
  * **Dense KV** (``kv_mode="auto"`` on archs with recurrent blocks, or
    ``kv_mode="dense"``) — per-slot rings ``[max_batch, n, Kv, D]``
    (``n`` = the window for windowed layers) and per-slot recurrent scan
    state, allocated once.  ``serve.kv_block_budget`` actuates the logical
    ledger (``serve/kv_cache.py``); there is no physical resize.
  * **Deferred host sync** — sampled tokens stay on the device
    (``_gen_buf``); the host reads a sequence back once, when it finishes.

SLO and overload contract (the reference's ``serve/README.md``): with an
``SLOSpec`` a finished request counts toward goodput only if its own TTFT
met ``slo.ttft_s`` and it completed inside its deadline
(``slo_good_tokens``); the ``serve.admit_tier_max`` brownout controller
(``sc_admit``) holds TTFT-p99, read from admission eligibility
(``ttft_ctrl``), under that bound by shedding the highest tiers first; a
browned-out request whose TTFT bound is already blown is rejected
(``RejectReason.BROWNOUT_SHED``).  A triggered ``PreemptionHandler``
drains the engine: every in-flight request goes back to the queue, new
submissions bounce (``RejectReason.DRAINING``) and ticks idle until the
flag clears.  A ``Telemetry`` hub, when passed, records spans, metrics,
the flight recorder and every controller Decision; telemetry never
switches a path.

Where the reference jit-compiles each step with cache donation, the port
runs eagerly and updates the block stores and token buffers **in place**.
The host knows which stream lanes are live, so it builds each step's K/V
write plan (``blocks.paged_write_plan``, or the dense rings' plans) and
uploads it: no step synchronises on a device-side selection.  A step's
only wait is the stream synchronise after a dispatch that samples a
token, so the latency sensors measure device time, not enqueue time.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item, see ``serve/options.py``): the modality frontends, the prefix
cache, speculation, mesh serving.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import (ControllerModel, GoalSpec, Guardrails,
                              LatencySensor, SmartConf, SmartConfIndirect,
                              ThroughputSensor)
from repro_torch.core.sensors import HBMAccountant
from repro_torch.core.smartconf import ConfRegistry
from repro_torch.core.telemetry import Telemetry, Tracer
from repro_torch.distributed.fault_tolerance import PreemptionHandler
from repro_torch.kernels.decode_attention import padded_cache_len
from repro_torch.models import blocks, zoo
from repro_torch.models.bridge import tree_leaves
from repro_torch.models.transformer import resolve_device
from .kv_cache import QUEUE_TOKEN_BYTES, KVBlockPool
from .options import ServeOptions, SLOSpec
from .paging import PagedKVAllocator

__all__ = ["Admission", "Request", "RejectReason", "SLOSpec", "ServeEngine",
           "ServeOptions", "TICK_STATS_KEYS"]

_MIN_BUCKET = 16

# rejections in one tick at or past this count dump the flight recorder
_REJECT_STORM_PER_TICK = 3

# The TickStats schema, key for key and in order the reference's: every
# dict `tick()` returns has exactly these keys.  Keys of features the port
# does not serve yet (prefix cache, speculation, mesh) report their idle
# value (0 / 1).
TICK_STATS_KEYS: tuple[str, ...] = (
    "tick",
    "queued", "waiting", "running", "finished", "hbm", "tokens",
    "pad_fraction", "packed_segments", "dispatches",
    "prefill_tokens", "prefill_issued_tokens", "decode_tokens",
    "kv_used_blocks", "kv_budget_blocks", "kv_capacity_blocks",
    "kv_over_budget", "kv_frag_tokens",
    "preemptions", "admit_tier_max", "rejected", "draining",
    "slo_good_tokens", "slo_miss_tokens",
    "prefix_hit_tokens", "prefix_cache_blocks", "kv_cache_share",
    "spec_depth", "accept_rate", "spec_lanes", "decode_slots",
    "tp_shards",
)


class RejectReason(str, enum.Enum):
    """Why the engine refused (or gave up on) a request."""

    EMPTY_PROMPT = "empty_prompt"          # nothing to prefill
    PROMPT_TOO_LONG = "prompt_too_long"    # prompt+new tokens exceed cache_len
    KV_FOOTPRINT = "kv_footprint"          # KV need exceeds the block budget
    DEADLINE_EXPIRED = "deadline_expired"  # deadline passed while waiting
    BROWNOUT_SHED = "brownout_shed"        # browned out past the TTFT SLO
    DRAINING = "draining"                  # worker preemption in progress

    def __str__(self) -> str:              # counters key on the short name
        return self.value


@dataclasses.dataclass(frozen=True)
class Admission:
    """Typed result of :meth:`ServeEngine.submit`: ``accepted`` (also the
    truth value), the typed ``reason`` when refused, and the KV blocks the
    request will need resident."""

    accepted: bool
    reason: RejectReason | None = None
    footprint_blocks: int = 0

    def __bool__(self) -> bool:
        return self.accepted


def _bucket(n: int) -> int:
    """Smallest power-of-two >= n (floored at _MIN_BUCKET): the packed
    stream's width, so a saturated engine reuses one shape."""
    return max(_MIN_BUCKET, 1 << (max(1, n) - 1).bit_length())


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int
    tier: int = 0               # priority tier; 0 = highest, preempted last
    deadline_s: float | None = None  # completion deadline (from submit)
    prompt_bytes: int = 0
    submitted_t: float = 0.0
    queued_t: float | None = None    # first admission past the tier gate
    first_token_t: float | None = None
    done_t: float | None = None
    generated: list = dataclasses.field(default_factory=list)
    slot: int | None = None
    prefilled: int = 0          # prompt tokens already prefilled (chunking)
    prefill_chunks: int = 0     # chunk calls this request's prefill spanned
    gen_count: int = 0          # tokens generated (device-resident until done)
    admit_seq: int = 0          # scheduling order; highest = first preempted
    preempted: int = 0          # times this request was kicked back to queue
    reject_reason: RejectReason | None = None
    slo_ok: bool | None = None  # set at completion: counted toward goodput?
    lease: object | None = None  # KVLease while scheduled


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: dict, *,
                 options: ServeOptions | None = None,
                 registry: ConfRegistry | None = None,
                 preemption: PreemptionHandler | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 telemetry: Telemetry | None = None,
                 device=None, **kwargs) -> None:
        """``device`` defaults to CUDA and must hold ``params``; pass
        ``device="cpu"`` to serve with the kernels' plain versions.
        ``telemetry`` defaults to ``options.telemetry``."""
        if options is None:
            options = ServeOptions(**kwargs)
        elif kwargs:
            raise TypeError(
                "pass configuration via options=ServeOptions(...) OR bare "
                f"kwargs, not both (got {sorted(kwargs)})")
        self.options = opts = options
        self.device = device = resolve_device(device)
        on = {t.device for t in tree_leaves(params)}
        if on != {device}:
            raise ValueError(f"params live on {sorted(map(str, on))}, the "
                             f"engine on {device}")
        if not zoo.supports_chunked_prefill(cfg):
            raise NotImplementedError(
                f"{cfg.name}: a modality frontend serves through the one-shot "
                "prefill with its frontend, ROADMAP Queue 1 item 12 (not "
                "ported yet)")
        for kind in set(cfg.block_pattern):
            blocks._check_ported(kind)
        # auto resolves to packed for every arch the port serves
        mode = "packed" if opts.prefill_mode == "auto" else opts.prefill_mode
        self.prefill_impl = mode
        self.fused_prefill = mode != "legacy"
        if opts.kv_mode == "paged" and not (zoo.supports_paged_kv(cfg)
                                            and self.fused_prefill):
            raise ValueError(
                f"{cfg.name}: paged KV requires an attention-only block "
                "pattern and chunked prefill (prefill_mode != 'legacy')")
        # auto: paged where every block is attention and prefill is
        # chunked, dense rings and recurrent state otherwise (the
        # reference's resolution)
        self.paged = opts.kv_mode == "paged" or (
            opts.kv_mode == "auto" and self.fused_prefill
            and zoo.supports_paged_kv(cfg))
        max_batch = opts.max_batch
        hbm_budget_bytes = opts.hbm_budget_bytes
        block_tokens = opts.block_tokens
        enable_smartconf = opts.enable_smartconf
        slo = opts.slo
        if telemetry is None:
            telemetry = opts.telemetry

        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        # sized as the reference sizes it, so blocks_per_seq matches too
        self.cache_len = cache_len = padded_cache_len(opts.cache_len)
        self.clock = clock
        # the packed stream's width cap: the live serve.prefill_chunk_tokens
        # value caps how many real tokens ride in it each tick
        self.packed_width = cache_len

        self.accountant = HBMAccountant(budget_bytes=hbm_budget_bytes)
        self.accountant.set("weights", sum(t.numel() * t.element_size()
                                           for t in tree_leaves(params)))

        self.blocks_per_seq = -(-cache_len // block_tokens)
        if self.paged:
            # under an HBM goal the store starts at one sequence's worth and
            # grows on demand inside the accountant's headroom, so the
            # ledger (= physical store bytes) never front-runs the budget
            full = max_batch * self.blocks_per_seq
            tight = enable_smartconf and hbm_budget_bytes
            self.pool = PagedKVAllocator(
                cfg, block_tokens=block_tokens,
                max_blocks_per_seq=self.blocks_per_seq,
                capacity_blocks=self.blocks_per_seq if tight else full,
                budget_blocks=full, accountant=self.accountant)
        else:
            self.pool = KVBlockPool(cfg, block_tokens=block_tokens,
                                    max_blocks=2**30,
                                    accountant=self.accountant)
        self.registry = registry or ConfRegistry()
        # block-level sliding-window eviction: only when EVERY attention
        # layer is windowed (a single global layer needs the whole history)
        kinds = {k.split("+")[0] for k in cfg.block_pattern}
        self._window_evict = (self.paged and opts.window_evict
                              and kinds <= {"swa", "local"}
                              and bool(cfg.window))

        # engine state
        self.waiting: collections.deque[Request] = collections.deque()
        self.queued: collections.deque[Request] = collections.deque()
        self.queued_tokens = 0
        self.prefilling: dict[int, Request] = {}
        self.running: dict[int, Request] = {}
        self.finished: list[Request] = []
        self.rejected = 0
        self.shed: list[Request] = []   # typed-rejected requests, in order
        self.reject_counts: collections.Counter = collections.Counter()
        self.preemptions = 0
        self.recompute_tokens = 0       # prefilled work thrown away by
        #                                 preemption (bounded-recompute gauge)
        self._admit_counter = 0
        self._free_slots = collections.deque(range(max_batch))
        self.prefill_calls = 0
        self._prefill_shapes: set[int] = set()
        # every model call (unified step or decode step) counts one
        # dispatch; the engine keeps each tick to exactly one
        self.model_dispatches = 0
        self._tick_dispatches = 0
        self._decode_dispatched = False
        # prefill padding telemetry (the serve.prefill_chunk_tokens deputy)
        self.prefill_issued_tokens = 0
        self.prefill_live_tokens = 0
        self._tick_issued = 0
        self._tick_live = 0
        self._tick_packed_segments = 0
        self._tick_decode = 0
        self._tick_decode_slots = 0

        # device-resident hot state; the host keeps positions and counters
        if self.paged:
            self.caches = zoo.init_paged_cache(cfg, self.pool.capacity,
                                               block_tokens, device)
            self._bt_np = np.full((max_batch, self.blocks_per_seq), -1,
                                  np.int32)
            self._bt_dev = self._dev(self._bt_np)
            self._bt_dirty = False
        else:
            # no ring margin: speculation, which needs one, is not ported
            self.caches = zoo.init_cache(cfg, max_batch, cache_len, device)
        self.slot_pos = np.full((max_batch,), -1, np.int64)
        self._slot_tok = torch.zeros(max_batch, dtype=torch.int32,
                                     device=device)
        # generated-token ring, one row per slot; the extra last column
        # takes the writes the reference drops (index == cache_len)
        self._gen_buf = torch.zeros((max_batch, cache_len + 1),
                                    dtype=torch.int32, device=device)
        self._rows = torch.arange(max_batch, device=device)

        # sensors share the injected clock so tests can be deterministic.
        # tick_latency spans the whole tick; decode_latency only the model
        # span of ticks that advanced a decoding slot, device wait included.
        # Under an SLO the latency windows shrink to slo.window so the
        # brownout controller reads the current load regime
        slo_window = slo.window if slo is not None else 512
        self.tick_latency = LatencySensor(clock=clock)
        self.decode_latency = LatencySensor(window=slo_window, clock=clock)
        self.ttft = LatencySensor(window=slo_window, clock=clock)
        # controller-facing TTFT, measured from admission eligibility (the
        # tick the request first cleared the tier gate), not from submit():
        # the brownout gate's own parking delay must never feed back into
        # the signal that opens and closes the gate.  Client TTFT
        # (self.ttft) still decides goodput
        self.ttft_ctrl = LatencySensor(window=slo_window, clock=clock)
        self.throughput = ThroughputSensor(window_seconds=5.0, clock=clock)

        # SLO / multi-tenant overload state: tiered admission with
        # brownout, per-request deadlines, goodput-under-SLO accounting
        self.slo = slo
        self.num_tiers = max(1, int(opts.num_tiers))
        self.admit_tier_max = (self.num_tiers - 1
                               if opts.admit_tier_max is None
                               else int(opts.admit_tier_max))
        self.slo_good_requests = 0
        self.slo_miss_requests = 0
        self.slo_good_tokens = 0
        self.slo_miss_tokens = 0
        # chaos hook: every sensor reading the controllers consume passes
        # through the tap (the SmartConf guardrails must absorb it)
        self.sensor_tap = opts.sensor_tap
        # worker preemption: on trigger the engine drains instead of
        # crashing (see _drain_for_preemption)
        self.preemption = preemption if preemption is not None \
            else PreemptionHandler()
        self._draining = False
        self._closed = False
        self.tp_shards = 1         # mesh serving is not ported

        # SmartConf PerfConfs
        self.enable_smartconf = enable_smartconf
        self.max_queue_tokens = 4 * cache_len
        self.prefill_chunk = cache_len
        self.sc_queue = None
        self.sc_kv = None
        self.sc_chunk = None
        self.sc_admit = None
        # the decode-latency goal: latency_goal_s, else the SLO's decode_s
        decode_goal = opts.latency_goal_s if opts.latency_goal_s is not None \
            else (slo.decode_s if slo is not None else None)
        # sensor-sanity guardrails: a dropped-out or corrupted sensor must
        # never reach Eq. 2 — after 3 consecutive insane readings the knob
        # pins to its last-known-good value
        byte_rails = Guardrails(perf_lo=0.0, perf_hi=1e15)
        lat_rails = Guardrails(perf_lo=0.0, perf_hi=3600.0)
        if enable_smartconf and hbm_budget_bytes:
            goal = GoalSpec(float(hbm_budget_bytes), hard=True,
                            super_hard=True)
            self.sc_queue = SmartConfIndirect(
                "serve.max_queue_tokens", metric="hbm_bytes", goal=goal,
                initial=0.0, registry=self.registry, guardrails=byte_rails,
                model=ControllerModel(alpha=float(QUEUE_TOKEN_BYTES),
                                      lam=0.05, delta=1.15, conf_min=0.0,
                                      conf_max=1e9))
            self.sc_kv = SmartConfIndirect(
                "serve.kv_block_budget", metric="hbm_bytes", goal=goal,
                initial=1.0, registry=self.registry,
                guardrails=dataclasses.replace(byte_rails),
                model=ControllerModel(alpha=float(max(1, self.pool.block_bytes)),
                                      lam=0.05, delta=1.15, conf_min=1.0,
                                      conf_max=1e9))
            if decode_goal is not None:
                # alpha: prefill seconds per token, start 1e-4; the slew
                # clamp bounds one actuation to a quarter of the knob range
                self.sc_chunk = SmartConf(
                    "serve.prefill_chunk_tokens", metric="decode_p99_s",
                    goal=GoalSpec(decode_goal, hard=False),
                    initial=float(cache_len), registry=self.registry,
                    guardrails=dataclasses.replace(
                        lat_rails, max_step=max(float(block_tokens),
                                                cache_len / 4.0)),
                    model=ControllerModel(alpha=1e-4, lam=0.1, delta=1.3,
                                          conf_min=float(block_tokens),
                                          conf_max=float(cache_len)))
        if enable_smartconf and slo is not None and opts.admit_tier_max is None:
            # brownout controller: admit_tier_max is a direct PerfConf on
            # TTFT-p99 with a hard goal; overload sheds the lowest tiers
            # first (conf drops), calm traffic re-opens them.  alpha: one
            # more tier is modelled to add half the SLO bound to p99
            self.sc_admit = SmartConf(
                "serve.admit_tier_max", metric="ttft_p99_s",
                goal=GoalSpec(float(slo.ttft_s), hard=True),
                initial=float(self.num_tiers - 1), registry=self.registry,
                guardrails=dataclasses.replace(lat_rails),
                model=ControllerModel(alpha=0.5 * float(slo.ttft_s),
                                      lam=0.1, delta=1.3, conf_min=0.0,
                                      conf_max=float(self.num_tiers - 1)))

        # telemetry: off unless a hub is passed, and then the hot path pays
        # one `is not None` test per instrumentation point
        self.ticks_run = 0
        self._tel = telemetry if (telemetry is not None
                                  and telemetry.enabled) else None
        self._tick_readings: dict[str, tuple[float, float]] = {}
        if self._tel is not None:
            # pre-create the hot-path instruments
            m = self._tel.metrics
            self._tel_h_tick = m.histogram("serve.tick_latency_s")
            self._tel_h_decode = m.histogram("serve.decode_latency_s")
            self._tel_h_ttft = m.histogram("serve.ttft_s")
            self._tel_c_ticks = m.counter("serve.ticks")
            self._tel_c_tokens = m.counter("serve.tokens")
            for reason in RejectReason:
                m.counter(f"serve.reject.{reason}")
            self._tick_rejects0 = 0
            self._tel_faults_seen = 0
            self._tel_fallback_seen: set[str] = set()
            for sc in self.controllers():
                sc.attach_audit(self._tel.audit)

    # ------------------------------------------------------------------ API
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the engine's device (a copy)."""
        return torch.tensor(a, device=self.device)

    def _sync(self) -> None:
        """Wait for the device: the latency sensors time device work."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _reject(self, req: Request, reason: RejectReason) -> RejectReason:
        """Typed rejection: the request is recorded (``shed``), counted,
        and stamped with the reason — never an exception mid-tick."""
        req.reject_reason = reason
        req.done_t = self.clock()
        self.rejected += 1
        self.reject_counts[str(reason)] += 1
        self.shed.append(req)
        if self._tel is not None:
            self._tel.metrics.counter(f"serve.reject.{reason}").inc()
            self._tel.tracer.async_end(
                "request", req.req_id, args={"rejected": str(reason)})
        return reason

    def submit(self, req: Request) -> Admission:
        """Validate + enqueue; returns a typed :class:`Admission` receipt.
        A draining engine, an empty prompt, a prompt that cannot fit the
        cache, or a footprint no block budget could hold is rejected here,
        at the door."""
        req.prompt_bytes = len(req.prompt) * QUEUE_TOKEN_BYTES
        req.submitted_t = self.clock()
        fp = self._footprint_blocks(req)
        if self._draining or self.preemption.triggered:
            return Admission(False, self._reject(req, RejectReason.DRAINING),
                             footprint_blocks=fp)
        if len(req.prompt) == 0:
            return Admission(False,
                             self._reject(req, RejectReason.EMPTY_PROMPT),
                             footprint_blocks=fp)
        if len(req.prompt) + req.max_new_tokens > self.cache_len:
            return Admission(False,
                             self._reject(req, RejectReason.PROMPT_TOO_LONG),
                             footprint_blocks=fp)
        if fp > self._kv_budget_ceiling():
            return Admission(False,
                             self._reject(req, RejectReason.KV_FOOTPRINT),
                             footprint_blocks=fp)
        self.waiting.append(req)
        return Admission(True, None, footprint_blocks=fp)

    def _footprint_blocks(self, req: Request) -> int:
        """KV blocks the request needs resident while running."""
        need = min(len(req.prompt) + req.max_new_tokens, self.cache_len)
        return -(-need // self.pool.block_tokens)

    def _kv_budget_ceiling(self) -> int:
        """Largest block budget a request could ever see: the live budget
        for static engines, the structural store ceiling when SmartConf owns
        (and may later raise) the budget."""
        if self.sc_kv is not None:
            return self.max_batch * self.blocks_per_seq
        return self.pool.max_blocks

    def hbm_bytes(self) -> int:
        return self.accountant.total()

    @property
    def model_programs(self) -> int:
        """Distinct model call shapes so far: one per prefill call shape
        (packed stream width, bucketed chunk width or legacy prompt
        length), plus the decode step once a decode tick ran (the
        reference compiles one program per shape)."""
        return len(self._prefill_shapes) + (1 if self._decode_dispatched
                                            else 0)

    # ------------------------------------------------------------- one tick
    def tick(self) -> dict:
        t0 = self.clock()
        self._tick_issued = self._tick_live = 0
        self._tick_packed_segments = 0
        self._tick_dispatches = 0
        self._tick_decode = 0
        self._tick_decode_slots = 0
        tel = self._tel
        if tel is not None:
            tel.audit.tick = self.ticks_run
            tel.tracer.begin_tick(self.ticks_run)
            self._tick_readings = {}
            self._tick_rejects0 = self.rejected
        if self.preemption.triggered:
            # worker preemption: drain once (requeue every in-flight
            # request), then idle; the queue survives for a handoff
            if not self._draining:
                self._drain_for_preemption()
            self.tick_latency.record(self.clock() - t0)
            stats = self._stats(0)
            self.ticks_run += 1
            if tel is not None:
                tel.tracer.phase("drain")
                self._tel_finish_tick(stats, self.clock() - t0)
            return stats
        self._draining = False          # preemption cleared: resume serving
        if tel is not None:
            tel.tracer.phase("control")
        self._update_controllers()
        self._shed_expired()
        if tel is not None:
            tel.tracer.phase("admit")
        self._admit()
        if tel is not None:
            tel.tracer.phase("schedule")
        self._schedule()
        if self.prefill_impl == "packed":
            n_tokens = self._tick_unified()
        else:
            if tel is not None:
                tel.tracer.phase("pack")
            if self.prefilling:        # bucketed; legacy prefilled at once
                self._prefill_tick_bucketed()
            if tel is not None:
                tel.tracer.phase("dispatch")
            n_tokens = self._decode_tick()
        if tel is not None:
            tel.tracer.phase("finish")
        self._finish()
        if self._window_evict:
            self._trim_windows()
        self.tick_latency.record(self.clock() - t0)
        stats = self._stats(n_tokens)
        self.ticks_run += 1
        if tel is not None:
            self._tel_finish_tick(stats, self.clock() - t0)
        return stats

    def _stats(self, n_tokens: int) -> dict:
        # keys and their order are TICK_STATS_KEYS
        return {
            "tick": self.ticks_run,
            "queued": len(self.queued),
            "waiting": len(self.waiting),
            "running": len(self.running) + len(self.prefilling),
            "finished": len(self.finished), "hbm": self.hbm_bytes(),
            "tokens": n_tokens,
            "pad_fraction": (1.0 - self._tick_live / self._tick_issued
                             if self._tick_issued else 0.0),
            "packed_segments": self._tick_packed_segments,
            "dispatches": self._tick_dispatches,
            "prefill_tokens": self._tick_live,
            "prefill_issued_tokens": self._tick_issued,
            "decode_tokens": self._tick_decode,
            "kv_used_blocks": self.pool.used_blocks,
            "kv_budget_blocks": self.pool.max_blocks,
            "kv_capacity_blocks": getattr(self.pool, "capacity",
                                          self.pool.max_blocks),
            "kv_over_budget": self.pool.over_budget,
            "kv_frag_tokens": self.pool.frag_tokens,
            "preemptions": self.preemptions,
            "admit_tier_max": self.admit_tier_max,
            "rejected": self.rejected,
            "draining": self._draining,
            "slo_good_tokens": self.slo_good_tokens,
            "slo_miss_tokens": self.slo_miss_tokens,
            "prefix_hit_tokens": 0,
            "prefix_cache_blocks": 0,
            "kv_cache_share": 0.0,
            "spec_depth": 0,
            "accept_rate": 0.0,
            "spec_lanes": 0,
            "decode_slots": self._tick_decode_slots,
            "tp_shards": 1,
        }

    def run(self, ticks: int) -> list[dict]:
        return [self.tick() for _ in range(ticks)]

    def controllers(self) -> list:
        """The live SmartConf controllers, in the reference's order."""
        return [sc for sc in (self.sc_queue, self.sc_kv, self.sc_chunk,
                              self.sc_admit) if sc is not None]

    # ----------------------------------------------------------- telemetry
    def _tel_finish_tick(self, stats: dict, wall_dt: float) -> None:
        """Per-tick telemetry epilogue (only reached when enabled): close
        the tick span, fold the stats into the metrics, snapshot the
        sensor readings into the flight-recorder ring, and dump the ring
        on any guardrail fault, fallback engagement, or rejection storm."""
        tel = self._tel
        tick = stats["tick"]
        tel.tracer.end_tick(args={
            "tokens": stats["tokens"], "queued": stats["queued"],
            "running": stats["running"], "rejected": stats["rejected"],
            "admit_tier_max": stats["admit_tier_max"],
            "draining": stats["draining"]})
        self._tel_c_ticks.inc()
        self._tel_c_tokens.inc(stats["tokens"])
        if wall_dt > 0.0:
            # wall span of the tick body; under a VirtualClock this is 0
            # and the open-loop driver charges the virtual cost through
            # charge_tick_cost instead
            self._tel_h_tick.record(wall_dt)
        m = tel.metrics
        m.gauge("serve.hbm_bytes").set(float(stats["hbm"]))
        m.gauge("serve.admit_tier_max").set(float(stats["admit_tier_max"]))
        m.gauge("serve.kv_used_blocks").set(float(stats["kv_used_blocks"]))
        m.gauge("serve.queued_tokens").set(float(self.queued_tokens))
        tel.flight.record(tick, dict(self._tick_readings))
        faults = 0
        for sc in self.controllers():
            faults += sc.sensor_faults
            if sc.sensor_failed:
                if sc.conf_name not in self._tel_fallback_seen:
                    self._tel_fallback_seen.add(sc.conf_name)
                    tel.flight.dump(f"fallback:{sc.conf_name}", tick)
            else:
                self._tel_fallback_seen.discard(sc.conf_name)
        if faults > self._tel_faults_seen:
            self._tel_faults_seen = faults
            tel.flight.dump("guardrail_fault", tick)
        if self.rejected - self._tick_rejects0 >= _REJECT_STORM_PER_TICK:
            tel.flight.dump("rejection_storm", tick)

    def note_chaos(self, name: str) -> None:
        """Chaos-injection stamp (called by ChaosMonkey): an instant on the
        chaos track, a counter, and a flight-recorder dump."""
        if self._tel is None:
            return
        tel = self._tel
        tel.tracer.instant(f"chaos:{name}", tid=Tracer.TID_CHAOS,
                           args={"tick": self.ticks_run})
        tel.metrics.counter(f"chaos.{name.split(':', 1)[0]}").inc()
        tel.flight.dump(f"chaos:{name.split(':', 1)[0]}", self.ticks_run)

    def note_arrival(self, req: Request) -> None:
        """Driver-side arrival stamp: an instant on the driver track plus
        the open end of the request's async lifetime span (closed at
        finish or rejection)."""
        if self._tel is None:
            return
        trc = self._tel.tracer
        trc.instant("arrival", tid=Tracer.TID_DRIVER,
                    args={"req": req.req_id, "tier": req.tier})
        trc.async_begin("request", req.req_id,
                        args={"tier": req.tier,
                              "prompt_len": int(len(req.prompt)),
                              "deadline_s": req.deadline_s})

    def charge_tick_cost(self, dt: float, *, decoded: bool = False) -> None:
        """Virtual-time cost feedback from the open-loop driver: the clock
        is frozen within a tick, so the driver charges the modelled tick
        cost into the latency sensors (and telemetry histograms) after the
        fact."""
        self.tick_latency.record(dt)
        if decoded:
            self.decode_latency.record(dt)
        if self._tel is not None:
            self._tel_h_tick.record(dt)
            if decoded:
                self._tel_h_decode.record(dt)

    # ------------------------------------------------------------ internals
    def _sense(self, name: str, value: float) -> float:
        """Controller-facing sensor read — the one road a reading takes to
        a controller: through the chaos tap when one is installed, and
        recorded raw and tapped into the flight recorder's tick snapshot."""
        tap = self.sensor_tap
        out = tap(name, value) if tap is not None else value
        if self._tel is not None:
            self._tick_readings[name] = (value, out)
        return out

    def _update_controllers(self) -> None:
        if not self.enable_smartconf:
            return
        if self.sc_queue is not None:
            hbm = self._sense("hbm_bytes", float(self.hbm_bytes()))
            self.sc_queue.set_perf(
                hbm, self._sense("queued_tokens", float(self.queued_tokens)))
            self.max_queue_tokens = max(0, int(self.sc_queue.get_conf()))
            self.sc_kv.set_perf(
                hbm,
                self._sense("kv_used_blocks", float(self.pool.used_blocks)))
            self.pool.set_budget(max(1, int(self.sc_kv.get_conf())))
            if self.paged and self.pool.over_budget:
                # the budget bit below occupancy: make the cut physical
                self._enforce_kv_budget()
            if self.sc_chunk is not None:
                self.sc_chunk.set_perf(
                    self._sense("decode_p99_s", self.decode_latency.p99()))
                self.prefill_chunk = max(1, int(self.sc_chunk.get_conf()))
        if self.sc_admit is not None:
            # censored per-tick observation: the head-of-line request's
            # eventual TTFT is at least its current wait; an empty queue
            # contributes zero.  Without it the sensor freezes when the
            # gate closes and the brownout latches shut
            now = self.clock()
            if self.queued:
                head = self.queued[0]
                epoch = head.queued_t if head.queued_t is not None \
                    else head.submitted_t
                self.ttft_ctrl.record(max(0.0, now - epoch))
            else:
                self.ttft_ctrl.record(0.0)
            self.sc_admit.set_perf(
                self._sense("ttft_p99_s", self.ttft_ctrl.p99()))
            self.admit_tier_max = int(self.sc_admit.get_conf())

    def _stamp_first_token(self, req: Request, now: float) -> None:
        """One TTFT sample per request, at the first compute response
        (preempted requests keep their original stamp): the client TTFT
        (from submit; decides goodput) and the controller-facing one (from
        admission eligibility; feeds sc_admit)."""
        if req.first_token_t is not None:
            return
        req.first_token_t = now
        self.ttft.record(now - req.submitted_t)
        epoch = req.queued_t if req.queued_t is not None else req.submitted_t
        self.ttft_ctrl.record(now - epoch)
        if self._tel is not None:
            self._tel_h_ttft.record(now - req.submitted_t)

    def _shed_expired(self) -> None:
        """Deadline-expired requests still waiting in line are shed with a
        typed reason."""
        now = self.clock()

        def expired(req: Request) -> bool:
            return (req.deadline_s is not None
                    and now - req.submitted_t > req.deadline_s)

        if any(expired(r) for r in self.waiting):
            keep: collections.deque[Request] = collections.deque()
            for req in self.waiting:
                if expired(req):
                    self._reject(req, RejectReason.DEADLINE_EXPIRED)
                else:
                    keep.append(req)
            self.waiting = keep
        if any(expired(r) for r in self.queued):
            keep = collections.deque()
            for req in self.queued:
                if expired(req):
                    self.queued_tokens -= len(req.prompt)
                    self.accountant.credit("queue", req.prompt_bytes)
                    self._reject(req, RejectReason.DEADLINE_EXPIRED)
                else:
                    keep.append(req)
            self.queued = keep

    def _admit(self) -> None:
        """FIFO admission into the token queue under
        ``serve.max_queue_tokens``, gated by the brownout tier: requests
        above ``admit_tier_max`` wait while their TTFT SLO is still
        winnable, without blocking eligible tiers behind them, and are
        shed with a typed reason once it is blown."""
        # the gate applies to the admitted queue too: when it drops, queued
        # requests above it (not prefilling yet, so no KV to drop) go back
        # to the front of the waiting line in admission order
        if any(r.tier > self.admit_tier_max for r in self.queued):
            keep: collections.deque[Request] = collections.deque()
            back: list[Request] = []
            for req in self.queued:
                if req.tier > self.admit_tier_max:
                    self.queued_tokens -= len(req.prompt)
                    self.accountant.credit("queue", req.prompt_bytes)
                    back.append(req)
                else:
                    keep.append(req)
            self.queued = keep
            self.waiting.extendleft(reversed(back))
        browned: collections.deque[Request] = collections.deque()
        now = self.clock()
        while self.waiting:
            req = self.waiting.popleft()
            if req.tier > self.admit_tier_max:
                if (self.slo is not None
                        and now - req.submitted_t > self.slo.ttft_s):
                    self._reject(req, RejectReason.BROWNOUT_SHED)
                else:
                    browned.append(req)     # shed lowest tiers first: wait
                continue
            if self.queued_tokens + len(req.prompt) > self.max_queue_tokens:
                browned.append(req)         # queue full: FIFO order holds
                break
            if req.queued_t is None:
                req.queued_t = now          # the ttft_ctrl epoch (once)
            self.queued.append(req)
            self.queued_tokens += len(req.prompt)
            self.accountant.charge("queue", req.prompt_bytes)
        browned.extend(self.waiting)
        self.waiting = browned

    def _schedule(self) -> None:
        while self.queued and self._free_slots:
            req = self.queued[0]
            need = min(len(req.prompt) + req.max_new_tokens, self.cache_len)
            if self._footprint_blocks(req) > self.pool.max_blocks:
                # the budget (possibly cut mid-run) can NEVER hold it: park
                # it with a typed reason instead of a preempt-readmit loop
                self.queued.popleft()
                self.queued_tokens -= len(req.prompt)
                self.accountant.credit("queue", req.prompt_bytes)
                self._reject(req, RejectReason.KV_FOOTPRINT)
                continue
            lease = self._lease_for(need)
            if lease is None:
                break  # KV budget exhausted; stay queued
            self.queued.popleft()
            self.queued_tokens -= len(req.prompt)
            self.accountant.credit("queue", req.prompt_bytes)
            req.slot = self._free_slots.popleft()
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            req.lease = lease
            req.prefilled = 0
            if self.paged:
                self._bt_np[req.slot] = lease.table_row()
                self._bt_dirty = True
            if self.fused_prefill:
                self.prefilling[req.slot] = req
            else:
                self._do_prefill_legacy(req)
                self.running[req.slot] = req

    def _lease_for(self, need: int):
        """Acquire the request's KV lease (no prefix cache yet: nothing is
        shared, so no copy-on-write pairs arise).  Returns the lease, or
        None when the budget cannot hold the request."""
        if not self.paged:
            return self.pool.lease(need)
        T = self.pool.block_tokens
        fresh = -(-need // T)
        if self.pool.free_blocks < fresh:
            # store smaller than demand (start-small under an HBM goal, or
            # shrunk by an earlier cut): grow it first so a free-list miss
            # is never miscounted as an allocation failure
            self._grow_store_for(fresh * T)
        lease = self.pool.lease(need)
        if lease is None:
            return None
        pairs = lease.writable(0, need)
        if pairs is None:          # copy-on-write targets unavailable
            lease.release()
            return None
        if pairs:
            self._apply_cow(pairs)
        return lease

    def _apply_cow(self, pairs: list[tuple[int, int]]) -> None:
        """Materialize copy-on-write before this tick's writes touch the
        lease: each shared source block is copied into its private
        replacement, in every layer's store."""
        src = self._dev(np.asarray([p[0] for p in pairs], np.int64))
        dst = self._dev(np.asarray([p[1] for p in pairs], np.int64))
        zoo.copy_paged_blocks(self.caches, src, dst)

    # --------------------------------------------- paged KV: physical budget
    def _bt(self) -> torch.Tensor:
        """Device block-table operand, refreshed lazily after table edits."""
        if self._bt_dirty:
            self._bt_dev = self._dev(self._bt_np)
            self._bt_dirty = False
        return self._bt_dev

    def set_kv_budget(self, blocks: int) -> None:
        """Manual ``serve.kv_block_budget`` actuation (benchmarks / ops).
        Paged: preempts past occupancy and physically resizes the block
        store.  Dense: moves the ledger's budget only."""
        self.pool.set_budget(blocks)
        if self.paged:
            self._enforce_kv_budget()

    def _enforce_kv_budget(self) -> None:
        while self.pool.over_budget and (self.running or self.prefilling):
            self._preempt_lowest_priority()
        bps = self.blocks_per_seq
        target = min(-(-max(1, self.pool.max_blocks) // bps) * bps,
                     self.max_batch * bps)
        target = max(target, bps, self.pool.used_blocks)
        if target < self.pool.capacity:
            keep = self._dev(self.pool.compact(target).astype(np.int64))
            # new, smaller tensors; the old ones are freed with the old tree
            self.caches = zoo.map_paged_caches(
                self.caches, lambda a, ax: a.index_select(ax, keep))
            for reqs in (self.prefilling, self.running):
                for slot, req in reqs.items():
                    self._bt_np[slot] = req.lease.table_row()
            self._bt_dirty = True

    def _grow_store_for(self, tokens: int) -> bool:
        need = -(-tokens // self.pool.block_tokens)
        full = self.max_batch * self.blocks_per_seq
        if (self.pool.used_blocks + need > self.pool.max_blocks
                or need > self.blocks_per_seq):
            return False   # genuinely over budget, not just store-limited
        bps = self.blocks_per_seq
        target = min(-(-(self.pool.used_blocks + need) // bps) * bps, full)
        if target <= self.pool.capacity:
            return False   # store large enough; ensure failed on budget
        head = self.accountant.headroom()
        if head is not None and (
                (target - self.pool.capacity) * self.pool.block_bytes > head):
            return False   # growing the store would blow the hard HBM goal
        added = self.pool.grow(target)

        def pad(a, ax):
            shape = list(a.shape)
            shape[ax] = added
            return torch.cat([a, a.new_zeros(shape)], dim=ax)

        self.caches = zoo.map_paged_caches(self.caches, pad)
        return True

    def _preempt_lowest_priority(self) -> None:
        """Kick the lowest-priority sequence back to the queue — highest
        tier number first, newest-admitted within a tier (recompute on
        readmission, paper §4.2)."""
        cands = list(self.prefilling.items()) + list(self.running.items())
        if not cands:
            return
        slot, req = max(cands, key=lambda sr: (sr[1].tier, sr[1].admit_seq))
        self._requeue_slot(slot, req)
        self.preemptions += 1
        if self._tel is not None:
            self._tel.tracer.instant(
                "preempt", args={"req": req.req_id, "tier": req.tier,
                                 "tick": self.ticks_run})
            self._tel.metrics.counter("serve.preemptions").inc()

    def _requeue_slot(self, slot: int, req: Request) -> None:
        """Undo a slot's in-flight work back to the queue head (state reset
        to prefilled=0: recompute on readmission, counted)."""
        self.prefilling.pop(slot, None)
        self.running.pop(slot, None)
        if req.lease is not None:
            req.lease.release()
            req.lease = None
        self._free_slots.append(slot)
        self.slot_pos[slot] = -1
        if self.paged:
            self._bt_np[slot] = -1
            self._bt_dirty = True
        req.slot = None
        self.recompute_tokens += req.prefilled + req.gen_count
        req.prefilled = 0
        req.gen_count = 0
        req.generated = []
        req.preempted += 1
        self.queued.appendleft(req)
        self.queued_tokens += len(req.prompt)
        self.accountant.charge("queue", req.prompt_bytes)

    # ------------------------------------------------- worker preemption
    def _drain_for_preemption(self) -> None:
        """The answer to ``PreemptionHandler.trigger``: every in-flight
        request is requeued (newest first, so the queue keeps admission
        order), new submissions bounce with a typed reason, and ticks idle
        until the signal clears."""
        in_flight = sorted(
            list(self.prefilling.items()) + list(self.running.items()),
            key=lambda sr: sr[1].admit_seq, reverse=True)
        for slot, req in in_flight:
            self._requeue_slot(slot, req)
            self.preemptions += 1
        self._draining = True
        if self._tel is not None:
            self._tel.tracer.instant(
                "worker_preemption_drain",
                args={"requeued": len(in_flight), "tick": self.ticks_run})
            self._tel.metrics.counter("serve.preemptions").inc(
                len(in_flight))

    def drained_requests(self) -> list[Request]:
        """Requests parked by a drain (queued + waiting, admission order):
        what a replacement worker resubmits."""
        return list(self.queued) + list(self.waiting)

    @property
    def accepting(self) -> bool:
        """Whether ``submit`` would pass the drain gate right now: False
        from the preemption trigger until the first tick after the flag
        clears.  The replica router dispatches only to accepting
        engines."""
        return not (self._draining or self.preemption.triggered)

    def take_drained(self) -> list[Request]:
        """Hand off every parked request: the returned requests leave this
        engine's queues and its memory ledger, so a later rejoin of this
        engine cannot serve them twice."""
        out = self.drained_requests()
        self.queued.clear()
        self.waiting.clear()
        self.queued_tokens = 0
        self.accountant.set("queue", 0)
        return out

    # --------------------------------------------------------- model calls
    def _record_prefill_pad(self, issued: int, live: int, segments: int):
        self.prefill_issued_tokens += issued
        self.prefill_live_tokens += live
        self._tick_issued += issued
        self._tick_live += live
        self._tick_packed_segments += segments

    @property
    def pad_fraction(self) -> float:
        """Cumulative padded-but-dead fraction of all prefill lanes issued."""
        if self.prefill_issued_tokens == 0:
            return 0.0
        return 1.0 - self.prefill_live_tokens / self.prefill_issued_tokens

    def _upload(self, plan):
        """A write plan (a tuple of index tensors, or one per ring length)
        made on the host, copied to the engine's device."""
        if isinstance(plan, dict):
            return {n: self._upload(p) for n, p in plan.items()}
        return tuple(t.to(self.device) for t in plan)

    def _packed_plan(self, slot_id, pos, start, seg_len):
        """The packed step's K/V write plan, selected on the host (no
        device synchronise) and uploaded."""
        slot_id, pos = torch.from_numpy(slot_id), torch.from_numpy(pos)
        if self.paged:
            return self._upload(blocks.paged_write_plan(
                slot_id, pos, torch.from_numpy(self._bt_np),
                self.pool.block_tokens))
        return self._upload(zoo.dense_packed_plans(
            self.caches, slot_id, pos, torch.from_numpy(start),
            torch.from_numpy(seg_len)))

    def _step_plan(self, pos: np.ndarray, active: np.ndarray):
        """The decode step's K/V write plan for the ``active`` rows, made
        on the host and uploaded."""
        pos_t, act = torch.from_numpy(pos), torch.from_numpy(active)
        if self.paged:
            return self._upload(blocks.paged_write_plan(
                torch.arange(self.max_batch, dtype=torch.int32), pos_t,
                torch.from_numpy(self._bt_np), self.pool.block_tokens,
                valid=act))
        return self._upload(zoo.dense_step_plans(self.caches, pos_t, act))

    def _tick_unified(self) -> int:
        """ONE ``step_packed`` dispatch advances the whole engine: prefill
        chunks from as many prefilling requests as fit under the live
        ``serve.prefill_chunk_tokens`` budget PLUS one length-1 decode
        segment per running slot, in admission order.  Decode tokens are
        mandatory riders and count against the budget; prefill keeps a
        floor of one token per tick.  A tick with no prefill work runs the
        decode step instead (still one dispatch).  Returns the number of
        tokens generated this tick."""
        if not self.prefilling:
            if self._tel is not None:
                self._tel.tracer.phase("dispatch")
            return self._decode_tick()
        if self._tel is not None:
            self._tel.tracer.phase("pack")
        n_dec = len(self.running)
        budget = max(1, min(int(self.prefill_chunk), self.packed_width))
        demand = sum(len(r.prompt) - r.prefilled
                     for r in self.prefilling.values())
        pre_budget = min(max(1, budget - n_dec), demand)
        width = min(_bucket(pre_budget + n_dec), self.packed_width)
        width = max(width, pre_budget + n_dec)   # never truncate the stream
        tokens = np.zeros((1, width), np.int32)
        slot_id = np.full((width,), -1, np.int32)
        posw = np.zeros((width,), np.int32)
        start = np.zeros((self.max_batch,), np.int32)
        seg_len = np.zeros((self.max_batch,), np.int32)
        is_dec = np.zeros((width,), bool)
        sample = np.zeros((self.max_batch,), bool)
        gidx = np.full((self.max_batch,), self.cache_len, np.int64)
        done = np.zeros((self.max_batch,), bool)
        cursor = 0
        packed: list[tuple[int, Request, int]] = []
        for slot, req in sorted(self.prefilling.items(),
                                key=lambda sr: sr[1].admit_seq):
            if cursor >= pre_budget:
                break   # later arrivals re-pack from `prefilled` next tick
            n = min(len(req.prompt) - req.prefilled, pre_budget - cursor)
            tokens[0, cursor:cursor + n] = \
                req.prompt[req.prefilled:req.prefilled + n]
            slot_id[cursor:cursor + n] = slot
            posw[cursor:cursor + n] = np.arange(req.prefilled,
                                                req.prefilled + n)
            start[slot] = req.prefilled
            seg_len[slot] = n
            if req.prefilled + n >= len(req.prompt):
                done[slot] = sample[slot] = True
                gidx[slot] = 0               # first token -> gen ring head
            packed.append((slot, req, n))
            cursor += n
        pre_cursor = cursor
        decoders: list[tuple[int, Request]] = []
        for slot, req in sorted(self.running.items(),
                                key=lambda sr: sr[1].admit_seq):
            # the decode token itself lives on the device (_slot_tok); the
            # stream carries a placeholder the step fills in
            slot_id[cursor] = slot
            posw[cursor] = int(self.slot_pos[slot])
            is_dec[cursor] = True
            start[slot] = int(self.slot_pos[slot])
            seg_len[slot] = 1
            sample[slot] = True
            gidx[slot] = min(req.gen_count, self.cache_len)  # ==len => trash
            decoders.append((slot, req))
            cursor += 1
        plan = self._packed_plan(slot_id, posw, start, seg_len)
        t_disp = self.clock()
        if self._tel is not None:
            self._tel.tracer.phase("dispatch")
        self._step_unified(self._dev(tokens), self._dev(slot_id),
                           self._dev(posw), self._dev(start),
                           self._dev(seg_len), self._dev(is_dec),
                           self._dev(sample), self._dev(gidx), plan)
        self.model_dispatches += 1
        self._tick_dispatches += 1
        self._prefill_shapes.add(width)
        if packed:
            self.prefill_calls += 1
            # the prefill-knob deputy counts prefill lanes only
            self._record_prefill_pad(width - n_dec, pre_cursor, len(packed))
        self._tick_packed_segments += n_dec
        if n_dec or done.any():
            # a sampled token is a completion boundary: wait for the device
            # (no host transfer) so TTFT/decode latency reflect compute
            self._sync()
        if self._tel is not None:
            self._tel.tracer.phase("sample")
        if n_dec:
            dt = self.clock() - t_disp
            self.decode_latency.record(dt)
            if self._tel is not None and dt > 0.0:
                self._tel_h_decode.record(dt)
        now = self.clock()
        for slot, req, n in packed:
            req.prefilled += n
            req.prefill_chunks += 1
            if done[slot]:
                req.gen_count = 1            # first token is on the device
                self._stamp_first_token(req, now)
                self.slot_pos[slot] = len(req.prompt)
                self.running[slot] = self.prefilling.pop(slot)
        for slot, req in decoders:
            self.slot_pos[slot] += 1
            req.gen_count += 1
        self._tick_decode = n_dec
        self._tick_decode_slots = n_dec
        n_tokens = n_dec + int(done.sum())
        if n_tokens:
            self.throughput.record(n_tokens)
        return n_tokens

    def _step_unified(self, tokens, slot_id, pos, start, seg_len, is_dec,
                      sample, gidx, plan) -> None:
        # decode segments carry placeholder tokens: fill them from the
        # device-resident token ring (the deferred-host-sync invariant)
        safe = slot_id.clamp(0, self.max_batch - 1)
        tokens = torch.where(is_dec[None, :], self._slot_tok[safe][None, :],
                             tokens)
        logits = zoo.step_packed(self.cfg, self.params, self.caches, tokens,
                                 slot_id, pos, start, seg_len,
                                 self._bt() if self.paged else None,
                                 plan=plan)
        nxt = logits.argmax(dim=-1).to(torch.int32)
        # sample every segment that completed a row this tick
        self._slot_tok = torch.where(sample, nxt, self._slot_tok)
        self._gen_buf[self._rows, gidx] = nxt

    # ----------------------------------------------- split ticks: prefill
    def _chunk_plan(self, start: np.ndarray, lengths: np.ndarray,
                    width: int):
        """The padded chunk's K/V write plan over its flattened
        ``[max_batch * width]`` lanes, made on the host and uploaded."""
        t = np.arange(width, dtype=np.int32)[None, :]
        return self._upload(zoo.chunk_plan(
            self.caches, torch.from_numpy(start[:, None] + t),
            torch.from_numpy(t < lengths[:, None]),
            torch.from_numpy(self._bt_np) if self.paged else None))

    def _prefill_tick_bucketed(self) -> None:
        """Advance every prefilling slot by one chunk in a single padded
        call.  The chunk width is the power-of-two bucket covering the
        largest chunk this tick (each chunk capped by the live
        ``serve.prefill_chunk_tokens``), so mixed prompt lengths reuse a
        few shapes; the other slots ride as inactive rows."""
        cap = max(1, int(self.prefill_chunk))
        width = _bucket(max(min(len(r.prompt) - r.prefilled, cap)
                            for r in self.prefilling.values()))
        tokens = np.zeros((self.max_batch, width), np.int32)
        start = np.zeros((self.max_batch,), np.int32)
        lengths = np.zeros((self.max_batch,), np.int32)
        done = np.zeros((self.max_batch,), bool)
        for slot, req in self.prefilling.items():
            n = min(len(req.prompt) - req.prefilled, cap, width)
            tokens[slot, :n] = req.prompt[req.prefilled:req.prefilled + n]
            start[slot] = req.prefilled
            lengths[slot] = n
            done[slot] = req.prefilled + n >= len(req.prompt)
        plan = self._chunk_plan(start, lengths, width)
        self._step_prefill_chunk(self._dev(tokens), self._dev(start),
                                 self._dev(lengths), self._dev(done), plan)
        self.prefill_calls += 1
        self.model_dispatches += 1
        self._tick_dispatches += 1
        self._prefill_shapes.add(width)
        self._record_prefill_pad(width * len(self.prefilling),
                                 int(lengths.sum()), int((lengths > 0).sum()))
        if done.any():
            # a first token is a completion boundary: wait for the device
            # (no host transfer) so TTFT reflects compute
            self._sync()
        now = self.clock()
        for slot in list(self.prefilling):
            req = self.prefilling[slot]
            req.prefilled += int(lengths[slot])
            req.prefill_chunks += 1
            if done[slot]:
                req.gen_count = 1            # first token is on the device
                self._stamp_first_token(req, now)
                self.slot_pos[slot] = len(req.prompt)
                self.running[slot] = self.prefilling.pop(slot)

    def _step_prefill_chunk(self, tokens, start, lengths, done,
                            plan) -> None:
        logits = zoo.prefill_chunk(self.cfg, self.params, self.caches,
                                   tokens, start, lengths,
                                   self._bt() if self.paged else None,
                                   plan=plan)
        first = logits.argmax(dim=-1).to(torch.int32)
        self._slot_tok = torch.where(done, first, self._slot_tok)
        # a first token lands at its gen ring's head, the other rows'
        # writes in the trash column
        self._gen_buf[self._rows, torch.where(done, 0, self.cache_len)] = \
            first

    def _do_prefill_legacy(self, req: Request) -> None:
        """Exact whole-prompt prefill of one admitted request (the one-shot
        oracle): ``prefill`` into fresh one-row dense caches, merged into
        the request's slot in place (every leaf of the row, so an earlier
        occupant's ring entries go too); the first token stays on the
        device."""
        logits, one = zoo.prefill(self.cfg, self.params,
                                  {"tokens": self._dev(req.prompt[None, :]
                                                       .astype(np.int32))},
                                  cache_len=self.cache_len)
        zoo.merge_slot(self.caches, one, req.slot)
        del one
        self.prefill_calls += 1
        self.model_dispatches += 1
        self._tick_dispatches += 1
        self._prefill_shapes.add(len(req.prompt))
        self._record_prefill_pad(len(req.prompt), len(req.prompt), 1)
        first = logits[0].argmax().to(torch.int32)
        self._slot_tok[req.slot] = first
        self._gen_buf[req.slot, 0] = first
        req.gen_count = 1
        req.prefilled = len(req.prompt)
        req.prefill_chunks = 1
        self._sync()
        self._stamp_first_token(req, self.clock())
        self.slot_pos[req.slot] = len(req.prompt)

    # ------------------------------------------------------------ decode
    def _decode_tick(self) -> int:
        if not self.running:
            return 0
        active = np.zeros((self.max_batch,), bool)
        gidx = np.full((self.max_batch,), self.cache_len, np.int64)
        for slot, req in self.running.items():
            active[slot] = True
            gidx[slot] = min(req.gen_count, self.cache_len)  # ==len => trash
        pos = np.maximum(self.slot_pos, 0).astype(np.int32)
        plan = self._step_plan(pos, active)
        active_d, pos_d, gidx_d = (self._dev(active), self._dev(pos),
                                   self._dev(gidx))
        # the decode-only latency sensor wraps just the dispatch + device
        # wait: the sc_chunk controller sees decode compute, not host work
        t_disp = self.clock()
        with self.decode_latency.measure():
            logits = zoo.decode_step(self.cfg, self.params, self.caches,
                                     self._slot_tok, pos_d,
                                     self._bt() if self.paged else None,
                                     active=active_d, plan=plan)
            nxt = logits.argmax(dim=-1).to(torch.int32)
            self._slot_tok = torch.where(active_d, nxt, self._slot_tok)
            self._gen_buf[self._rows, gidx_d] = nxt
            self._sync()
        if self._tel is not None:
            dt = self.clock() - t_disp
            if dt > 0.0:
                self._tel_h_decode.record(dt)
        self.model_dispatches += 1
        self._tick_dispatches += 1
        self._decode_dispatched = True
        n = 0
        for slot, req in self.running.items():
            self.slot_pos[slot] += 1
            req.gen_count += 1
            n += 1
        self._tick_decode = n
        self._tick_decode_slots = n
        self.throughput.record(n)
        return n

    def _finish(self) -> None:
        done = [(s, r) for s, r in self.running.items()
                if r.gen_count >= r.max_new_tokens]
        if not done:
            return
        # completion boundary: the only device->host token read in the loop
        gen = self._gen_buf.cpu().numpy()
        for slot, req in done:
            req.done_t = self.clock()
            # the prefill tick also decodes, so gen_count can overshoot
            # max_new_tokens by one — cap the readback at the request
            req.generated = [int(t) for t in
                             gen[slot, :min(req.gen_count,
                                            req.max_new_tokens)]]
            req.slo_ok = self._meets_slo(req)
            if req.slo_ok:
                self.slo_good_requests += 1
                self.slo_good_tokens += len(req.generated)
            else:
                self.slo_miss_requests += 1
                self.slo_miss_tokens += len(req.generated)
            if self._tel is not None:
                self._tel.tracer.async_end(
                    "request", req.req_id,
                    args={"slo_ok": bool(req.slo_ok),
                          "tokens": len(req.generated)})
            self.finished.append(req)
            del self.running[slot]
            self._free_slots.append(slot)
            if req.lease is not None:
                req.lease.release()
                req.lease = None
            self.slot_pos[slot] = -1
            if self.paged:
                self._bt_np[slot] = -1
                self._bt_dirty = True

    def _trim_windows(self) -> None:
        """Block-level sliding-window eviction (all-window archs only):
        blocks wholly below every live position's attention window return
        to the pool and their table entries go to -1, which every paged
        kernel skips.  The keep point is conservative by up to one block."""
        w = int(self.cfg.window)
        T = self.pool.block_tokens
        changed = False
        for reqs in (self.prefilling, self.running):
            for slot, req in reqs.items():
                if req.lease is None:
                    continue
                cur = (int(self.slot_pos[slot])
                       if self.slot_pos[slot] >= 0 else req.prefilled)
                first_keep = max(0, cur - w) // T
                if req.lease.trim_front(first_keep):
                    self._bt_np[slot] = req.lease.table_row()
                    changed = True
        if changed:
            self._bt_dirty = True

    def _meets_slo(self, req: Request) -> bool:
        """Goodput-under-SLO membership: the request's own TTFT met the SLO
        bound and it completed inside its deadline."""
        if (req.deadline_s is not None and req.done_t is not None
                and req.done_t - req.submitted_t > req.deadline_s):
            return False
        if (self.slo is not None and req.first_token_t is not None
                and req.first_token_t - req.submitted_t > self.slo.ttft_s):
            return False
        return True

    @property
    def goodput_tokens(self) -> int:
        """Generated tokens of finished requests that met their SLO."""
        return self.slo_good_tokens

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for sc in self.controllers():
            sc.close()
