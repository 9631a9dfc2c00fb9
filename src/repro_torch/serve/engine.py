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

Prefix cache (``prefix_cache=True``, paged KV only): a radix tree over
refcounted blocks (``serve/prefix_cache.py``) remembers the full-block
prefixes of finished prompts.  A request whose prompt shares a cached
prefix adopts those blocks into its lease and prefills only the uncovered
suffix; a match that ends mid-block copies that block first
(copy-on-write).  The tree's share of the block budget is the
``serve.kv_cache_share`` knob (``sc_cache``, on the windowed prefix hit
rate), and a budget cut evicts cached prefixes before it preempts work.

Self-speculative decode (``spec_depth > 0``, packed mode only): each
running slot's decode segment grows from one lane to ``1 + d``, the
device-resident pending token followed by ``d`` drafts of a deterministic
n-gram drafter (``serve/speculation.py``), verified by per-offset argmax
in the same dispatch (``step_spec``); a slot emits the accepted drafts
plus the model's own next token, which is what that many ticks without
drafts would emit.  The draft depth is the ``serve.spec_depth`` knob
(``sc_spec``, on the windowed accept rate), subordinate to the
decode-latency goal.  Dense windowed rings are widened by
``spec_depth_max`` so a rejected draft never overwrites a live key.

Where the reference jit-compiles each step with cache donation, the port
runs eagerly and updates the block stores and token buffers **in place**.
The host knows which stream lanes are live, so it builds each step's K/V
write plan (``blocks.paged_write_plan``, or the dense rings' plans) and
uploads it: no step synchronises on a device-side selection.  A step's
only wait is the stream synchronise after a dispatch that samples a
token (under speculation, the read of the accepted counts and tokens),
so the latency sensors measure device time, not enqueue time.

The modality frontends (internvl2-1b's vision prefix, whisper-tiny's
encoder-decoder) have no chunked prefill, as in the reference: ``auto``
resolves to the one-shot ``legacy`` path on dense KV with the reference's
``RuntimeWarning`` (``serve.prefill_chunk_tokens`` cannot actuate there),
and an explicit ``packed`` or ``bucketed`` raises its ``ValueError``.
Their one-shot prefill takes zero patches or frames, and a vision slot's
ring holds ``num_patches`` positions before the prompt's; the admission
check and the footprint count them, the schedule's lease does not (the
reference's ledger).

Mesh serving (``ServeOptions(mesh="DxM")``): the engine is one rank of a
``(data, model)`` mesh of processes (``launch/mesh.py``), every rank
running this scheduler over the same requests.  Attention heads and the
caches' Kv dim shard over ``model`` (``serve/block_store.py``), the
per-shard kernels' outputs all-gathered back
(``distributed/collectives.py``); MoE experts shard over ``model`` too;
everything else is whole on every rank, so every rank samples the same
tokens.  Each clock reading is the MAX over the ranks
(``collectives.agreed_clock``), so every host decision — controllers,
gates, the SLO accounting — is the same on every rank and no rank skips
a collective the others enter.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import time
import warnings
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
from repro_torch.distributed.collectives import agreed_clock
from repro_torch.distributed.fault_tolerance import PreemptionHandler
from repro_torch.distributed.sharding import SERVE_TP_RULES, use_mesh
from repro_torch.kernels.decode_attention import padded_cache_len
from repro_torch.models import blocks, zoo
from repro_torch.models import moe as moe_lib
from repro_torch.models.bridge import tree_leaves
from repro_torch.models.transformer import resolve_device
from .block_store import CacheShardingPlan, build_serve_mesh
from .kv_cache import QUEUE_TOKEN_BYTES, KVBlockPool
from .options import ServeOptions, SLOSpec
from .paging import PagedKVAllocator
from .prefix_cache import PrefixCache
from .speculation import NGramDrafter

__all__ = ["Admission", "Request", "RejectReason", "SLOSpec", "ServeEngine",
           "ServeOptions", "TICK_STATS_KEYS"]

_MIN_BUCKET = 16

# rejections in one tick at or past this count dump the flight recorder
_REJECT_STORM_PER_TICK = 3

# The TickStats schema, key for key and in order the reference's: every
# dict `tick()` returns has exactly these keys.
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
    truth value), the typed ``reason`` when refused, the prompt tokens the
    prefix cache could serve right now (advisory: the grant happens when
    the request is scheduled), and the KV blocks the request will need
    resident."""

    accepted: bool
    reason: RejectReason | None = None
    prefix_hit_tokens: int = 0
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
    lease: object | None = None  # KVLease/DenseKVLease while scheduled
    prefix_hit: int = 0         # prompt tokens served from the radix cache


def _one_shot_reason(cfg: ArchConfig) -> str:
    """Why this arch cannot leave the one-shot prefill path (the
    reference's words): a modality frontend, whose unpadded prefix has no
    chunk form (every block kind the port builds is chunkable)."""
    if cfg.encoder_decoder:
        return "the encoder-decoder frontend"
    return "the vision-prefix frontend"


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
        for kind in set(cfg.block_pattern):
            blocks._check_ported(kind)
        mode = opts.prefill_mode
        if (mode in ("packed", "bucketed")
                and not zoo.supports_chunked_prefill(cfg)):
            raise ValueError(
                f"{cfg.name}: {_one_shot_reason(cfg)} cannot serve "
                f"{mode} (chunked) prefill; only prefill_mode='legacy' "
                "(one-shot) is available for this family")
        if mode == "auto":
            if zoo.supports_chunked_prefill(cfg):
                mode = "packed"
            else:
                # the reference says it loudly: the
                # serve.prefill_chunk_tokens knob will NOT actuate here
                warnings.warn(
                    f"{cfg.name}: {_one_shot_reason(cfg)} keeps the one-shot "
                    "legacy prefill path; serve.prefill_chunk_tokens will "
                    "not actuate for this engine", RuntimeWarning,
                    stacklevel=2)
                mode = "legacy"
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

        # --------------------------------- mesh serving (TP packed ticks)
        # one process per (data, model) position: attention heads and the
        # caches' Kv dim shard over `model`, MoE experts too; everything
        # else is whole on every rank.  Every rank takes every host
        # decision alike, so each clock reading is agreed (the MAX over
        # the ranks) before any sensor, controller or gate sees it
        self.mesh = None
        if opts.mesh is not None:
            self.mesh = build_serve_mesh(
                opts.mesh, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                prefill_impl=self.prefill_impl)
        self.tp_shards = (int(self.mesh.shape["model"])
                          if self.mesh is not None else 1)
        if self.mesh is not None:
            clock = agreed_clock(clock, self.mesh)

        self.cfg = cfg
        # this rank's experts only under a mesh; the ledger below counts
        # the whole model, as the reference's does
        self.params = moe_lib.place_experts(params, cfg, self.mesh,
                                            max_batch)
        self.max_batch = max_batch
        # the vision prefix's positions ahead of each prompt in its ring
        self._npatch = cfg.num_patches if cfg.frontend == "vision" else 0
        # sized as the reference sizes it, so blocks_per_seq matches too
        self.cache_len = cache_len = padded_cache_len(opts.cache_len)
        self.clock = clock
        # the packed stream's width cap: the live serve.prefill_chunk_tokens
        # value caps how many real tokens ride in it each tick
        self.packed_width = cache_len

        # self-speculative decode rides the packed stream: each running
        # slot's segment is [pending token, drafts...] and the one dispatch
        # that prefills chunks verifies every draft position
        spec_depth = int(opts.spec_depth)
        if spec_depth > 0 and self.prefill_impl != "packed":
            raise ValueError(
                f"{cfg.name}: speculative decode rides the packed stream; "
                f"prefill_impl={self.prefill_impl!r} cannot serve it")
        self.spec_depth_max = max(1, int(opts.spec_depth_max))
        self.spec_enabled = spec_depth > 0
        self.spec_depth = (min(spec_depth, self.spec_depth_max)
                           if self.spec_enabled else 0)
        self._spec_len_max = self.spec_depth_max + 1   # 1 pending + k drafts
        self._drafter = NGramDrafter() if self.spec_enabled else None
        self.spec_proposed = 0          # drafted tokens verified, lifetime
        self.spec_accepted = 0          # drafted tokens accepted, lifetime
        self._tick_spec_proposed = 0
        self._tick_spec_accepted = 0
        self._tick_spec_lanes = 0       # draft verify lanes issued
        # windowed accept rate, the sc_spec sensor: (accepted, proposed)
        self._accept_window: collections.deque[tuple[int, int]] = \
            collections.deque(maxlen=slo.window if slo is not None else 64)

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

        # radix prefix cache: needs the refcounted paged allocator (leases
        # and copy-on-write)
        if opts.prefix_cache and not self.paged:
            raise ValueError(
                f"{cfg.name}: prefix_cache requires paged KV "
                "(kv_mode='paged' on an attention-only arch)")
        self._prefix_cache = (PrefixCache(self.pool) if opts.prefix_cache
                              else None)
        if self._prefix_cache is not None:
            self.pool.remap_hook = self._prefix_cache.remap
        self.kv_cache_share = float(opts.kv_cache_share)
        self.prefix_hit_tokens_total = 0   # reclaimed prefill tokens
        self.cow_copied_blocks = 0
        self._tick_prefix_hit = 0
        # windowed token-weighted hit rate, the sc_cache sensor
        self._hit_window: collections.deque[tuple[int, int]] = \
            collections.deque(maxlen=slo.window if slo is not None else 64)
        # block-level sliding-window eviction: only when EVERY attention
        # layer is windowed (a single global layer needs the whole history)
        # and the prefix cache is off (trimmed blocks cannot be shared)
        kinds = {k.split("+")[0] for k in cfg.block_pattern}
        self._window_evict = (self.paged and opts.window_evict
                              and self._prefix_cache is None
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
            # windowed rings need headroom for in-flight draft K/V: a
            # rejected draft's entries must age out of the window before
            # they can alias a live position
            self.caches = zoo.init_cache(
                cfg, max_batch, cache_len, device,
                ring_margin=self.spec_depth_max if self.spec_enabled else 0)
        if self.mesh is not None:
            # this rank's Kv head chunk of every K/V plane; the resizes
            # move whole blocks and keep it
            self.caches = CacheShardingPlan(
                self.mesh, paged=self.paged).place(self.caches)
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

        # SmartConf PerfConfs
        self.enable_smartconf = enable_smartconf
        self.max_queue_tokens = 4 * cache_len
        self.prefill_chunk = cache_len
        self.sc_queue = None
        self.sc_kv = None
        self.sc_chunk = None
        self.sc_admit = None
        self.sc_cache = None
        self.sc_spec = None
        # the decode-latency goal: latency_goal_s, else the SLO's decode_s.
        # sc_chunk targets it; the sc_spec knob is subordinate to it (a
        # blown decode p99 shrinks the draft depth whatever Eq. 2 wants)
        self._decode_goal = decode_goal = (
            opts.latency_goal_s if opts.latency_goal_s is not None
            else (slo.decode_s if slo is not None else None))
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
        if enable_smartconf and self._prefix_cache is not None:
            # cache-share controller: serve.kv_cache_share is a direct
            # PerfConf on the windowed token-weighted prefix hit rate with
            # a lower-direction goal (the rate should stay above it); a
            # larger share retains more prefixes (alpha > 0).  The sensor is
            # a rate in [0, 1]; one actuation moves at most a tenth of the
            # span; the share stays in [0.05, 0.9]
            self.sc_cache = SmartConf(
                "serve.kv_cache_share", metric="prefix_hit_rate",
                goal=GoalSpec(float(opts.prefix_hit_rate_goal),
                              direction="lower"),
                initial=self.kv_cache_share, registry=self.registry,
                guardrails=Guardrails(perf_lo=0.0, perf_hi=1.0,
                                      max_step=0.1),
                model=ControllerModel(alpha=1.0, lam=0.05, delta=1.2,
                                      conf_min=0.05, conf_max=0.9,
                                      integer=False))
        if enable_smartconf and self.spec_enabled and opts.spec_adaptive:
            # draft-depth controller: serve.spec_depth is a direct PerfConf
            # on the windowed accept rate with a lower-direction soft goal.
            # alpha < 0: a deeper draft drops the accept rate.  The sensor
            # is a rate in [0, 1]; one actuation moves at most 2 steps; the
            # depth is an integer in [1, spec_depth_max] (0, spec off, is
            # an operator's choice, never a controller state)
            self.sc_spec = SmartConf(
                "serve.spec_depth", metric="accept_rate",
                goal=GoalSpec(float(opts.accept_rate_goal),
                              direction="lower"),
                initial=float(self.spec_depth), registry=self.registry,
                guardrails=Guardrails(perf_lo=0.0, perf_hi=1.0,
                                      max_step=2.0),
                model=ControllerModel(alpha=-0.08, lam=0.1, delta=1.3,
                                      conf_min=1.0,
                                      conf_max=float(self.spec_depth_max)))

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
            self._tel_c_spec_prop = m.counter("serve.spec.proposed")
            self._tel_c_spec_acc = m.counter("serve.spec.accepted")
            self._tel_h_spec = m.histogram("serve.spec.accepted_len")
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
        """Validate + enqueue; returns a typed :class:`Admission` receipt
        (with the prefix cache on, the prompt tokens a hit would cover
        right now).  A draining engine, an empty prompt, a prompt that
        cannot fit the cache, or a footprint no block budget could hold is
        rejected here, at the door."""
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
        if (self._npatch + len(req.prompt) + req.max_new_tokens
                > self.cache_len):
            return Admission(False,
                             self._reject(req, RejectReason.PROMPT_TOO_LONG),
                             footprint_blocks=fp)
        if fp > self._kv_budget_ceiling():
            return Admission(False,
                             self._reject(req, RejectReason.KV_FOOTPRINT),
                             footprint_blocks=fp)
        hit = (self._prefix_cache.probe(req.prompt)
               if self._prefix_cache is not None else 0)
        self.waiting.append(req)
        return Admission(True, None, prefix_hit_tokens=hit,
                         footprint_blocks=fp)

    def _footprint_blocks(self, req: Request) -> int:
        """KV blocks the request needs resident while running, the vision
        prefix's patch positions included."""
        need = min(self._npatch + len(req.prompt) + req.max_new_tokens,
                   self.cache_len)
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

    def kv_shard_bytes(self) -> int:
        """Per-rank bytes of the resident KV cache tree — the mesh-aware
        HBM gauge.  Without a mesh this is the whole tree; with one, this
        rank's slice, so for a paged store (K/V planes only)
        ``kv_shard_bytes() * tp_shards`` is the single-device total."""
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self.caches))

    # ------------------------------------------------------------- one tick
    def tick(self) -> dict:
        if self.mesh is None:
            return self._tick()
        # the serving mesh is active for the whole tick: the attention and
        # MoE wrappers read current_mesh(); serving's overlay, as the
        # reference's engine (heads and experts on model, nothing else)
        with use_mesh(self.mesh, SERVE_TP_RULES, fsdp=False):
            return self._tick()

    def _tick(self) -> dict:
        t0 = self.clock()
        self._tick_issued = self._tick_live = 0
        self._tick_packed_segments = 0
        self._tick_dispatches = 0
        self._tick_decode = 0
        self._tick_decode_slots = 0
        self._tick_prefix_hit = 0
        self._tick_spec_proposed = self._tick_spec_accepted = 0
        self._tick_spec_lanes = 0
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
        if self.spec_enabled:
            n_tokens = self._tick_spec()
        elif self.prefill_impl == "packed":
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
            "prefix_hit_tokens": self._tick_prefix_hit,
            "prefix_cache_blocks": (self._prefix_cache.blocks_held
                                    if self._prefix_cache is not None
                                    else 0),
            "kv_cache_share": self.kv_cache_share,
            "spec_depth": self.spec_depth,
            "accept_rate": (self._tick_spec_accepted
                            / self._tick_spec_proposed
                            if self._tick_spec_proposed else 0.0),
            "spec_lanes": self._tick_spec_lanes,
            "decode_slots": self._tick_decode_slots,
            # mesh-serving sensor: model-axis shards behind this tick
            "tp_shards": self.tp_shards,
        }

    def run(self, ticks: int) -> list[dict]:
        return [self.tick() for _ in range(ticks)]

    def controllers(self) -> list:
        """The live SmartConf controllers, in the reference's order."""
        return [sc for sc in (self.sc_queue, self.sc_kv, self.sc_chunk,
                              self.sc_admit, self.sc_cache, self.sc_spec)
                if sc is not None]

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
        if self.sc_cache is not None and self._hit_window:
            # token-weighted hit rate over the recent admissions (the
            # capacity a share buys is proportional to tokens); no
            # admission yet, no observation, no actuation
            hw = self._hit_window
            rate = sum(h for h, _ in hw) / max(1, sum(p for _, p in hw))
            self.sc_cache.set_perf(self._sense("prefix_hit_rate", rate))
            self.kv_cache_share = float(self.sc_cache.get_conf())
            self._prefix_cache.enforce(
                int(self.kv_cache_share * self.pool.max_blocks))
        if self.sc_spec is not None and self._accept_window:
            # the windowed accept rate drives the depth; no drafts verified
            # yet, no actuation.  The goal is soft and subordinate: when
            # decode p99 blows the engine's goal the depth steps down one,
            # whatever Eq. 2 wants
            aw = self._accept_window
            rate = sum(a for a, _ in aw) / max(1, sum(p for _, p in aw))
            self.sc_spec.set_perf(self._sense("accept_rate", rate))
            depth = int(self.sc_spec.get_conf())
            if (self._decode_goal is not None
                    and self.decode_latency.p99() > self._decode_goal):
                depth = min(depth, max(1, self.spec_depth - 1))
            self.spec_depth = max(1, min(depth, self.spec_depth_max))

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
            # the lease leaves the vision prefix's patches out, as the
            # reference's does (ROADMAP Queue 3)
            need = min(len(req.prompt) + req.max_new_tokens, self.cache_len)
            if self._footprint_blocks(req) > self.pool.max_blocks:
                # the budget (possibly cut mid-run) can NEVER hold it: park
                # it with a typed reason instead of a preempt-readmit loop
                self.queued.popleft()
                self.queued_tokens -= len(req.prompt)
                self.accountant.credit("queue", req.prompt_bytes)
                self._reject(req, RejectReason.KV_FOOTPRINT)
                continue
            lease, hit = self._lease_for(req, need)
            if lease is None:
                break  # KV budget exhausted; stay queued
            self.queued.popleft()
            self.queued_tokens -= len(req.prompt)
            self.accountant.credit("queue", req.prompt_bytes)
            req.slot = self._free_slots.popleft()
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            req.lease = lease
            req.prefix_hit = hit
            req.prefilled = hit      # cached prefix: skip to the suffix
            if hit:
                self.prefix_hit_tokens_total += hit
                self._tick_prefix_hit += hit
            if self._prefix_cache is not None:
                self._hit_window.append((hit, len(req.prompt)))
            if self.paged:
                self._bt_np[req.slot] = lease.table_row()
                self._bt_dirty = True
            if self.fused_prefill:
                self.prefilling[req.slot] = req
            else:
                self._do_prefill_legacy(req)
                self.running[req.slot] = req

    def _lease_for(self, req: Request, need: int):
        """Acquire the request's KV lease, adopting any cached prefix
        (``PagedKVAllocator.lease(shared=...)``) and copying the block a
        mid-block match ends in before the request writes into it.  On an
        allocation failure the coldest cached prefix is evicted and the
        acquisition retried: a cold cache yields before live traffic waits.
        Returns ``(lease, prefix_hit_tokens)``, or ``(None, 0)`` when the
        budget cannot hold the request."""
        cache = self._prefix_cache
        T = self.pool.block_tokens
        while True:
            if cache is not None:
                hit, shared = cache.lookup(req.prompt, self.ticks_run)
            else:
                hit, shared = 0, []
            fresh = -(-need // T) - len(shared)
            if self.paged and self.pool.free_blocks < fresh:
                # store smaller than demand (start-small under an HBM goal,
                # or shrunk by an earlier cut): grow it first so a free-list
                # miss is never miscounted as an allocation failure
                self._grow_store_for(fresh * T)
            lease = self.pool.lease(need, shared=shared or None)
            if lease is not None:
                pairs = lease.writable(hit, need) if hit else []
                if pairs is not None:
                    if pairs:
                        self._apply_cow(pairs)
                    return lease, hit
                lease.release()    # copy-on-write targets unavailable
            if cache is None or cache.evict_lru_leaf() == 0:
                return None, 0

    def _apply_cow(self, pairs: list[tuple[int, int]]) -> None:
        """Materialize copy-on-write before this tick's writes touch the
        lease: each shared source block is copied into its private
        replacement, in every layer's store."""
        src = self._dev(np.asarray([p[0] for p in pairs], np.int64))
        dst = self._dev(np.asarray([p[1] for p in pairs], np.int64))
        zoo.copy_paged_blocks(self.caches, src, dst)
        self.cow_copied_blocks += len(pairs)

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
        # a budget cut lands on the cache first: cold cached prefixes are
        # speculative capacity and yield before any live work is undone
        cache = self._prefix_cache
        while (cache is not None and self.pool.over_budget
               and cache.blocks_held > 0):
            if cache.evict_lru_leaf() == 0:
                break
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
        if self._drafter is not None:
            self._drafter.drop(slot)
        if req.lease is not None:
            # releases only this lease's references: blocks the radix tree
            # still holds stay resident for later hits
            req.lease.release()
            req.lease = None
        self._free_slots.append(slot)
        self.slot_pos[slot] = -1
        if self.paged:
            self._bt_np[slot] = -1
            self._bt_dirty = True
        req.slot = None
        # cache-covered tokens were never computed, so they are not
        # recompute debt; the suffix and the generated tokens are
        self.recompute_tokens += (req.prefilled - req.prefix_hit
                                  + req.gen_count)
        req.prefilled = 0
        req.prefix_hit = 0
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
                self._cache_insert(req)
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

    # --------------------------------- speculative prefill+decode stream
    def _tick_spec(self) -> int:
        """:meth:`_tick_unified` with draft-and-verify decode segments.

        Each running slot's decode rider grows from one lane to ``1 + d``:
        the device-resident pending token followed by ``d`` drafts
        (``NGramDrafter``, deterministic), all verified by per-offset
        argmax in the same dispatch that advances prefill chunks
        (``step_spec``).  Greedy acceptance keeps the longest matching
        draft prefix plus the model's own next token, so a slot emits
        ``accept + 1`` tokens, the tokens of ``accept + 1`` ticks without
        drafts.  Drafts ride the same width budget as prefill; each is
        clamped to the request's remaining tokens and cache, so
        speculation never over-emits or outruns the KV lease.  Decode-only
        ticks take this path too.  The tick's one host read is the
        accepted counts and tokens, which the drafter needs."""
        if not self.prefilling and not self.running:
            return 0
        if self._tel is not None:
            self._tel.tracer.phase("pack")
        L = self._spec_len_max
        k_live = min(self.spec_depth, L - 1)
        # drafts first: the stream width depends on the verify lanes
        drafts: list[tuple[int, Request, np.ndarray]] = []
        spec_tokens = 0
        for slot, req in sorted(self.running.items(),
                                key=lambda sr: sr[1].admit_seq):
            d_cap = min(k_live, req.max_new_tokens - req.gen_count - 1,
                        self.cache_len - 1 - int(self.slot_pos[slot]))
            d = (self._drafter.propose(slot, d_cap) if d_cap > 0
                 else np.zeros(0, np.int32))
            drafts.append((slot, req, d))
            spec_tokens += 1 + len(d)
        n_dec = len(drafts)
        budget = max(1, min(int(self.prefill_chunk), self.packed_width))
        demand = sum(len(r.prompt) - r.prefilled
                     for r in self.prefilling.values())
        pre_budget = min(max(1, budget - n_dec), demand) if demand else 0
        width = min(_bucket(max(1, pre_budget + spec_tokens)),
                    self.packed_width)
        width = max(width, pre_budget + spec_tokens)
        tokens = np.zeros((1, width), np.int32)
        slot_id = np.full((width,), -1, np.int32)
        posw = np.zeros((width,), np.int32)
        start = np.zeros((self.max_batch,), np.int32)
        seg_len = np.zeros((self.max_batch,), np.int32)
        is_dec = np.zeros((width,), bool)
        spec_rows = np.zeros((self.max_batch,), bool)
        sample = np.zeros((self.max_batch,), bool)
        gidx = np.full((self.max_batch,), self.cache_len, np.int64)
        spec_idx = np.zeros((self.max_batch, L), np.int64)
        draft_len = np.zeros((self.max_batch,), np.int32)
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
                # draft_len 0: accept is 0 and the sampled token is the
                # argmax at the segment's last lane, the first token
                spec_idx[slot, :] = cursor + n - 1
            packed.append((slot, req, n))
            cursor += n
        pre_cursor = cursor
        for slot, req, d in drafts:
            seg = 1 + len(d)
            spos = int(self.slot_pos[slot])
            # lane 0 carries a placeholder the step fills from the device
            # token ring; the drafts ride from the host
            if len(d):
                tokens[0, cursor + 1:cursor + seg] = d
            slot_id[cursor:cursor + seg] = slot
            posw[cursor:cursor + seg] = np.arange(spos, spos + seg)
            is_dec[cursor] = True
            start[slot] = spos
            seg_len[slot] = seg
            spec_rows[slot] = sample[slot] = True
            gidx[slot] = min(req.gen_count, self.cache_len)  # ==len => trash
            spec_idx[slot, :] = cursor + np.minimum(np.arange(L), seg - 1)
            draft_len[slot] = len(d)
            cursor += seg
        plan = self._packed_plan(slot_id, posw, start, seg_len)
        t_disp = self.clock()
        if self._tel is not None:
            self._tel.tracer.phase("dispatch")
        accept_d, toks_d = self._step_spec(
            self._dev(tokens), self._dev(slot_id), self._dev(posw),
            self._dev(start), self._dev(seg_len), self._dev(is_dec),
            self._dev(spec_rows), self._dev(sample), self._dev(gidx),
            self._dev(spec_idx), self._dev(draft_len), plan)
        self.model_dispatches += 1
        self._tick_dispatches += 1
        self._prefill_shapes.add(width)
        if packed:
            self.prefill_calls += 1
            self._record_prefill_pad(width - spec_tokens, pre_cursor,
                                     len(packed))
        self._tick_packed_segments += n_dec
        # acceptance decides how far every slot advanced: the one host
        # read of the tick (the accepted tokens feed the drafter)
        accept = accept_d.cpu().numpy()
        tks = toks_d.cpu().numpy()
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
                self._cache_insert(req)
                self._drafter.begin(slot, req)
                self._drafter.extend(slot, tks[slot, :1])
        n_emitted = 0
        for slot, req, d in drafts:
            a = int(accept[slot])
            self._drafter.extend(slot, tks[slot, :a + 1])
            self.slot_pos[slot] += a + 1
            req.gen_count += a + 1
            n_emitted += a + 1
            self._tick_spec_proposed += len(d)
            self._tick_spec_accepted += a
            if self._tel is not None:
                self._tel_h_spec.record(float(a))
        if self._tick_spec_proposed:
            self.spec_proposed += self._tick_spec_proposed
            self.spec_accepted += self._tick_spec_accepted
            self._accept_window.append((self._tick_spec_accepted,
                                        self._tick_spec_proposed))
            if self._tel is not None:
                self._tel_c_spec_prop.inc(self._tick_spec_proposed)
                self._tel_c_spec_acc.inc(self._tick_spec_accepted)
        self._tick_spec_lanes = spec_tokens - n_dec
        self._tick_decode = n_emitted
        self._tick_decode_slots = n_dec
        n_tokens = n_emitted + int(done.sum())
        if n_tokens:
            self.throughput.record(n_tokens)
        return n_tokens

    def _step_spec(self, tokens, slot_id, pos, start, seg_len, is_dec,
                   spec_rows, sample, gidx, spec_idx, draft_len, plan):
        """One ``step_spec`` dispatch; returns ``(accept, toks)`` on the
        device.  Each sampled row's accepted prefix plus the model's own
        next token, ``toks[b, :accept[b]+1]``, lands in its gen ring from
        ``gidx[b]`` (past the ring: the trash column), and the last of them
        becomes the slot's pending token."""
        safe = slot_id.clamp(0, self.max_batch - 1)
        tokens = torch.where(is_dec[None, :], self._slot_tok[safe][None, :],
                             tokens)
        accept, toks = zoo.step_spec(self.cfg, self.params, self.caches,
                                     tokens, slot_id, pos, start, seg_len,
                                     spec_rows, spec_idx, draft_len,
                                     self._bt() if self.paged else None,
                                     plan=plan)
        offs = torch.arange(spec_idx.shape[1], device=self.device)[None, :]
        cols = gidx[:, None] + offs
        write = ((offs <= accept[:, None]) & sample[:, None]
                 & (cols < self.cache_len))
        cols = torch.where(write, cols, self.cache_len)
        self._gen_buf[self._rows[:, None], cols] = toks
        self._slot_tok = torch.where(sample,
                                     toks[self._rows, accept.long()],
                                     self._slot_tok)
        return accept, toks

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
                self._cache_insert(req)

    def _cache_insert(self, req: Request) -> None:
        """Prefill-complete hook: the finished prompt's full-block prefix
        goes into the radix tree (one reference a block; decode and a
        partial tail land strictly beyond the inserted blocks, so tree-held
        KV is never written again), then the tree is held to its
        ``serve.kv_cache_share`` of the block budget."""
        cache = self._prefix_cache
        if cache is None or req.lease is None:
            return
        if cache.insert(req.prompt, req.lease.blocks, self.ticks_run):
            cache.enforce(int(self.kv_cache_share * self.pool.max_blocks))

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
        device.  A frontend gets zero patches or frames, as in the
        reference's serving."""
        cfg = self.cfg
        batch = {"tokens": self._dev(req.prompt[None, :].astype(np.int32))}
        if cfg.frontend == "vision":
            batch["patches"] = torch.zeros(
                (1, cfg.num_patches, cfg.frontend_dim), device=self.device)
        if cfg.encoder_decoder:
            batch["frames"] = torch.zeros((1, cfg.enc_seq, cfg.d_model),
                                          device=self.device)
        logits, one = zoo.prefill(cfg, self.params, batch,
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
        self.slot_pos[req.slot] = len(req.prompt) + self._npatch

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
            if self._drafter is not None:
                self._drafter.drop(slot)
            if req.lease is not None:
                if self.spec_enabled:
                    self._truncate_and_insert(req)
                req.lease.release()
                req.lease = None
            self.slot_pos[slot] = -1
            if self.paged:
                self._bt_np[slot] = -1
                self._bt_dirty = True

    def _truncate_and_insert(self, req: Request) -> None:
        """Speculation's finish: only accepted-token KV stays.  The final
        sampled token was never consumed and a rejected draft tail is junk,
        so both are cut out of the lease before the radix tree may adopt
        its blocks; then the cacheable prefix is extended with the
        request's own output (prompt plus accepted continuation), so a
        repeat of this stream hits past the prompt."""
        valid = len(req.prompt) + max(0, len(req.generated) - 1)
        req.lease.truncate(valid)
        cache = self._prefix_cache
        if cache is not None and req.generated:
            ext = np.concatenate([np.asarray(req.prompt, np.int32),
                                  np.asarray(req.generated[:-1], np.int32)])
            if cache.insert(ext, req.lease.blocks, self.ticks_run):
                cache.enforce(int(self.kv_cache_share * self.pool.max_blocks))

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
