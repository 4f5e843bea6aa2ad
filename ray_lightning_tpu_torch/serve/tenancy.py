"""Multi-tenant SLO-aware scheduling: tenant classes + weighted
fair-share queueing + class-aware admission control (counterpart of
``ray_lightning_tpu/serve/tenancy.py``).

The port's own copy of the JAX package's module (the port imports
nothing of it), unchanged but for this paragraph, the names of the
modules it points to and the imports below. The port's sampling seeds
derive from (engine seed, request seed, step)
(:func:`~ray_lightning_tpu_torch.models.generate.row_seed`) where the
text below says ``fold_in``: the same contract.

The FIFO scheduler treats all traffic as one class: a batch tenant
flooding the queue starves an interactive tenant's TTFT, and overload
sheds whoever arrives last rather than whichever class is over its
share. This module is the scheduling-policy layer a
multi-tenant platform needs, built so that **scheduling stays
ordering-only**: the tenancy layer decides *when* a request is
admitted, never *what tokens* it receives — every request's sample-key
stream is ``fold_in(fold_in(engine_base, req.seed), step)``, a pure
function of no scheduler state, so a request's tokens are identical to
a solo run whatever classes ride the queue next to it (enforced by
``tests/test_torch_tenancy.py``).

- :class:`TenantClass` — one traffic class: a priority **tier**
  (``interactive`` tiers drain before ``batch`` tiers), a fair-share
  **weight** arbitrating within the tier, an optional TTFT-SLO target
  (feeds the per-tenant ``serve_tenant_slo_miss_total_<class>``
  counter), a per-class default deadline, and per-class quotas
  (``max_queue_depth`` sheds at submit, ``max_active_slots`` caps the
  KV slots the class may hold concurrently).
- :class:`TenantScheduler` — drop-in
  :class:`~ray_lightning_tpu_torch.serve.scheduler.FifoScheduler` replacement
  holding one FIFO deque per class, driven by **deficit-weighted
  round-robin inside each tier**: each admission pick serves the first
  class (declaration order — the deterministic tie-break) holding >= 1
  deficit credit, replenishing every non-empty class ``quantum*weight``
  credits when none does, so admission counts converge to the weight
  ratios whenever classes stay backlogged. Interactive tiers drain
  first; **starvation counters** bound how long that priority can hold:
  every interactive pick made while batch work waits credits each
  waiting batch class its weight, and a class crossing
  ``starvation_threshold`` takes the next pick regardless of tier — the
  lowest-weight batch class is served at least once every
  ``ceil(threshold/weight) + 1`` admissions under sustained interactive
  saturation. All tie-breaks are declaration-order/FIFO deterministic,
  so tick-clock traces (and their JSONL event logs) replay
  byte-identically.
- :class:`ClassQueueFull` — a
  :class:`~ray_lightning_tpu_torch.serve.scheduler.QueueFull` subclass raised
  when one *class* is at its own ``max_queue_depth``: the class sheds
  at the door with its name and depth in the occupancy context instead
  of consuming the global queue's headroom (class-aware admission
  control — the global bound still raises plain ``QueueFull``, now
  carrying the per-class depth/oldest-age breakdown).

A configuration holding only the default class is behaviorally
identical to the plain FIFO scheduler — one class's DWRR *is* FIFO, the
global bound and deadline policy are unchanged — which is what lets
``ServeClient(tenant_classes=...)`` arm tenancy without perturbing a
single existing trace (``tests/test_torch_tenancy.py`` holds it against the JAX
scheduler).

Crash replay and fleet failover preserve **class assignment** for free
(the class rides :attr:`Request.tenant` through snapshots and
re-admission); fair-share **state** is reconstructed, not checkpointed:
a rebuilt scheduler restarts its deficit/starvation counters at zero
and re-converges within one replenish round — bounded O(quantum)
transient unfairness, never lost or duplicated work. (The port's
crash replay and fleets wait for their own slices.)
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.serve.request import DEFAULT_TENANT, Request
from ray_lightning_tpu_torch.serve.scheduler import (ACTION_PREFILL,
                                               FifoScheduler, QueueFull,
                                               SchedulerConfig)

__all__ = ["TenantClass", "TenantScheduler", "ClassQueueFull",
           "DEFAULT_TENANT", "TIER_INTERACTIVE", "TIER_BATCH",
           "resolve_tenant_classes"]

TIER_INTERACTIVE = "interactive"
TIER_BATCH = "batch"


class ClassQueueFull(QueueFull):
    """One tenant class is at its own ``max_queue_depth``.

    Class-aware admission control: the class sheds at the door
    (``tenant`` / ``class_queue_depth`` / ``class_oldest_age`` in the
    occupancy context) instead of letting one tenant's backlog consume
    the global queue. A :class:`QueueFull` subclass, so every existing
    shed path (trace replay, fleet next-candidate offering) handles it
    unchanged."""

    def __init__(self, message: str, *, tenant: Optional[str] = None,
                 class_queue_depth: Optional[int] = None,
                 class_oldest_age: Optional[float] = None, **ctx):
        super().__init__(message, tenant=tenant,
                         class_queue_depth=class_queue_depth,
                         class_oldest_age=class_oldest_age, **ctx)


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One traffic class: priority tier + fair-share weight + quotas.

    ``tier``: ``"interactive"`` tiers drain before ``"batch"`` tiers
    (starvation counters bound the priority — see the module
    docstring). ``weight`` arbitrates within a tier: backlogged classes
    converge to admission shares proportional to their weights.

    ``ttft_slo``: optional target (client clock units) — retirements
    whose TTFT exceeds it bump ``serve_tenant_slo_miss_total_<name>``;
    the scheduler itself never reads it (SLOs are observed, admission
    is policy). ``default_deadline``: applied to this class's requests
    submitted without an explicit deadline (offset from arrival,
    overriding the global ``SchedulerConfig.default_deadline``).

    ``max_queue_depth``: per-class admission bound — at quota the class
    sheds :class:`ClassQueueFull` instead of queueing.
    ``max_active_slots``: cap on KV slots the class may hold
    concurrently (decoding + chunk-prefilling); a class at its slot
    quota contributes no admission candidates until a slot retires, so
    a batch class can be fenced off a reserved interactive slot.

    ``adapter``: the class's default LoRA adapter (multi-adapter
    serving, serve/adapters.py) — requests in this class submitted
    without an explicit ``adapter=`` decode under it; an explicit
    per-request adapter always wins. Resolution happens at engine
    admission (the resolved name is stamped onto the request, so
    crash replay and fleet failover re-bind identically).
    """
    name: str
    weight: float = 1.0
    tier: str = TIER_INTERACTIVE
    ttft_slo: Optional[float] = None
    default_deadline: Optional[float] = None
    max_queue_depth: Optional[int] = None
    max_active_slots: Optional[int] = None
    adapter: Optional[str] = None

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"tenant class name must be a non-empty "
                             f"string, got {self.name!r}")
        if self.tier not in (TIER_INTERACTIVE, TIER_BATCH):
            raise ValueError(
                f"tier must be {TIER_INTERACTIVE!r} or {TIER_BATCH!r}, "
                f"got {self.tier!r}")
        if not self.weight > 0.0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.ttft_slo is not None and self.ttft_slo <= 0:
            raise ValueError(f"ttft_slo must be > 0, got {self.ttft_slo}")
        if self.default_deadline is not None and self.default_deadline <= 0:
            raise ValueError(f"default_deadline must be > 0, got "
                             f"{self.default_deadline}")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got "
                             f"{self.max_queue_depth}")
        if self.max_active_slots is not None and self.max_active_slots < 1:
            raise ValueError(f"max_active_slots must be >= 1, got "
                             f"{self.max_active_slots}")
        if self.adapter is not None and (
                not self.adapter or not isinstance(self.adapter, str)):
            raise ValueError(f"adapter must be a non-empty string or "
                             f"None, got {self.adapter!r}")


def resolve_tenant_classes(
        classes: Sequence[TenantClass]) -> "OrderedDict[str, TenantClass]":
    """Validate a class list into the declaration-ordered name map the
    scheduler and the engine share. Appends the default class (plain
    interactive, weight 1 — today's untenanted behavior) when the
    caller didn't declare their own ``"default"``, so requests that
    never name a tenant keep working."""
    if not classes:
        raise ValueError("tenant_classes must name at least one class")
    out: "OrderedDict[str, TenantClass]" = OrderedDict()
    for cls in classes:
        if not isinstance(cls, TenantClass):
            raise ValueError(
                f"tenant_classes entries must be TenantClass, got "
                f"{type(cls).__name__}")
        if cls.name in out:
            raise ValueError(f"duplicate tenant class {cls.name!r}")
        out[cls.name] = cls
    if DEFAULT_TENANT not in out:
        out[DEFAULT_TENANT] = TenantClass(DEFAULT_TENANT)
    return out


class _ClassQueue:
    """One class's live scheduler state: its FIFO deque + the DWRR
    deficit credit (within-tier fair share) + the starvation credit
    (cross-tier no-starvation bound) + shed/admit accounting."""

    __slots__ = ("cls", "index", "queue", "deficit", "starve",
                 "admitted", "shed")

    def __init__(self, cls: TenantClass, index: int):
        self.cls = cls
        self.index = index  # declaration order: THE deterministic tie-break
        self.queue: Deque[Request] = deque()
        self.deficit = 0.0
        self.starve = 0.0
        self.admitted = 0
        self.shed = 0


class TenantScheduler(FifoScheduler):
    """Per-class queues + deficit-weighted round-robin admission.

    Drop-in for :class:`FifoScheduler` (the chunk/decode drain policy,
    the prefill batching threshold, the page-aware admission probe and
    the deadline machinery are all inherited or mirrored exactly):
    only the *order requests leave the waiting side* changes, and with
    a single class it doesn't change at all. Selection is a pure
    function of (per-class queues, deficit/starvation counters,
    per-class active-slot occupancy), committed only when requests are
    actually popped — ``peek_action`` and the admission probe read the
    same plan without mutating it, the ``_drain_verdict`` discipline.
    """

    def __init__(self, classes: Sequence[TenantClass],
                 config: Optional[SchedulerConfig] = None,
                 starvation_threshold: float = 8.0):
        super().__init__(config)
        if starvation_threshold <= 0:
            raise ValueError(f"starvation_threshold must be > 0, got "
                             f"{starvation_threshold}")
        self.starvation_threshold = starvation_threshold
        self.classes = resolve_tenant_classes(classes)
        self._queues: "OrderedDict[str, _ClassQueue]" = OrderedDict(
            (name, _ClassQueue(cls, i))
            for i, (name, cls) in enumerate(self.classes.items()))
        self._tiers: Dict[str, List[_ClassQueue]] = {
            TIER_INTERACTIVE: [cq for cq in self._queues.values()
                               if cq.cls.tier == TIER_INTERACTIVE],
            TIER_BATCH: [cq for cq in self._queues.values()
                         if cq.cls.tier == TIER_BATCH]}
        # the base deque stays empty: every FifoScheduler surface that
        # touched it is overridden below — the inherited pieces
        # (drain_action latch, config validation) are queue-free

    # ---------------------------------------------------------- queries
    def __len__(self) -> int:
        return sum(len(cq.queue) for cq in self._queues.values())

    @property
    def waiting(self) -> List[Request]:
        """Queued requests, class-declaration order then FIFO within
        each class (the failover re-admission order — deterministic;
        token streams are order-independent by the serve key-stream
        contract, so any deterministic order is correct)."""
        return [req for cq in self._queues.values() for req in cq.queue]

    def class_depths(self) -> Dict[str, int]:
        """Per-class queued counts — the shed-context breakdown and the
        fleet router's class-aware load signal."""
        return {name: len(cq.queue) for name, cq in self._queues.items()}

    def class_oldest(self, now: Optional[float]) -> Dict[str, float]:
        """Per-class head age (clock units), classes with measurable
        heads only — the oldest-age breakdown shed context carries."""
        out: Dict[str, float] = {}
        if now is None:
            return out
        for name, cq in self._queues.items():
            if cq.queue and cq.queue[0].arrival_time is not None:
                out[name] = now - cq.queue[0].arrival_time
        return out

    def oldest_age(self, now: Optional[float]) -> Optional[float]:
        ages = self.class_oldest(now)
        return max(ages.values()) if ages else None

    def shed_counts(self) -> Dict[str, int]:
        """Per-class submit-time sheds (quota + global), cumulative."""
        return {name: cq.shed for name, cq in self._queues.items()}

    def admitted_counts(self) -> Dict[str, int]:
        """Per-class admissions popped for prefill, cumulative — what
        the fair-share convergence and no-starvation tests read."""
        return {name: cq.admitted for name, cq in self._queues.items()}

    # ---------------------------------------------------------- mutation
    def submit(self, request: Request,
               now: Optional[float] = None) -> None:
        """Enqueue under class-aware admission control: the request's
        class must exist, its own ``max_queue_depth`` sheds
        :class:`ClassQueueFull` (the class is over ITS share — the
        global queue may have room), and the global bound sheds
        :class:`QueueFull` carrying the per-class breakdown."""
        cq = self._queues.get(request.tenant)
        if cq is None:
            raise ValueError(
                f"unknown tenant {request.tenant!r}: declared classes "
                f"are {list(self._queues)}")
        cls = cq.cls
        if cls.max_queue_depth is not None \
                and len(cq.queue) >= cls.max_queue_depth:
            cq.shed += 1
            raise ClassQueueFull(
                f"tenant {cls.name!r} at max_queue_depth="
                f"{cls.max_queue_depth}", tenant=cls.name,
                class_queue_depth=len(cq.queue),
                class_oldest_age=self.class_oldest(now).get(cls.name),
                queue_depth=len(self), oldest_age=self.oldest_age(now))
        if len(self) >= self.config.max_queue_depth:
            cq.shed += 1
            raise QueueFull(
                f"queue at max_queue_depth={self.config.max_queue_depth}",
                queue_depth=len(self), oldest_age=self.oldest_age(now),
                class_depths=self.class_depths(),
                class_oldest=self.class_oldest(now) or None)
        # per-class deadline policy: the class's own default wins, the
        # global SchedulerConfig default backs it up (one shared copy
        # of the stamping rules — the FIFO path cannot drift from this
        # one)
        self._stamp_admission(
            request, now,
            cls.default_deadline if cls.default_deadline is not None
            else self.config.default_deadline)
        cq.queue.append(request)

    def requeue_front(self, requests: List[Request]) -> None:
        """Seed-deferred requests rejoin their own class's queue head in
        original relative order (their admission credit was already
        spent — a deferral costs the class one quantum of fairness,
        never a token)."""
        for req in reversed(requests):
            self._queues[req.tenant].queue.appendleft(req)

    def expire(self, now: float) -> List[Request]:
        expired: List[Request] = []
        for cq in self._queues.values():
            gone = [r for r in cq.queue
                    if r.deadline is not None and now >= r.deadline]
            if gone:
                dead = {id(r) for r in gone}
                cq.queue = deque(r for r in cq.queue
                                 if id(r) not in dead)
                expired.extend(gone)
        if expired:
            self._reset_idle()
        return expired

    # --------------------------------------------------------- selection
    def _active_by_class(self, engine) -> Dict[str, int]:
        """KV slots each class currently holds (decoding AND
        chunk-prefilling — both are acquired slots), for the
        ``max_active_slots`` quota."""
        counts: Dict[str, int] = {}
        for req in engine.active_requests.values():
            tenant = getattr(req, "tenant", DEFAULT_TENANT)
            counts[tenant] = counts.get(tenant, 0) + 1
        return counts

    def _plan(self, limit: int, active_by_class: Dict[str, int]) \
            -> Tuple[List[Request], Dict[str, float], Dict[str, float],
                     Dict[str, int]]:
        """Fair-share selection order, PURE: the next ``limit`` requests
        the scheduler would admit, plus the deficit/starvation state
        that selection would leave behind. ``peek_action`` and the
        admission-width probe discard the state; :meth:`_take` commits
        it — one copy of the policy, so the lookahead can never drift
        from the pops (the ``_drain_verdict`` discipline). Selection is
        sequential, so the plan is prefix-stable: the first k picks of
        ``_plan(L)`` equal ``_plan(k)`` for any k <= L."""
        deficit = {n: cq.deficit for n, cq in self._queues.items()}
        starve = {n: cq.starve for n, cq in self._queues.items()}
        taken = {n: 0 for n in self._queues}
        picks: List[Request] = []

        def eligible(cq: _ClassQueue) -> bool:
            if taken[cq.cls.name] >= len(cq.queue):
                return False
            cap = cq.cls.max_active_slots
            if cap is not None and (active_by_class.get(cq.cls.name, 0)
                                    + taken[cq.cls.name]) >= cap:
                return False
            return True

        while len(picks) < limit:
            inter = [cq for cq in self._tiers[TIER_INTERACTIVE]
                     if eligible(cq)]
            batch = [cq for cq in self._tiers[TIER_BATCH] if eligible(cq)]
            if not inter and not batch:
                break
            starved = [cq for cq in batch
                       if starve[cq.cls.name] >= self.starvation_threshold]
            if inter and starved:
                # the no-starvation escape hatch: a batch class whose
                # credit crossed the threshold takes this pick even
                # though interactive work waits (highest credit first,
                # declaration order on ties — deterministic)
                chosen = max(starved, key=lambda cq: (starve[cq.cls.name],
                                                      -cq.index))
                starve[chosen.cls.name] = 0.0
            elif inter:
                chosen = self._drr_pick(inter, deficit)
                for cq in batch:
                    # passed over in favor of a higher tier: credit
                    # accrues by weight, so heavier batch classes cross
                    # the threshold sooner
                    starve[cq.cls.name] += cq.cls.weight
            else:
                chosen = self._drr_pick(batch, deficit)
                starve[chosen.cls.name] = 0.0
            picks.append(chosen.queue[taken[chosen.cls.name]])
            taken[chosen.cls.name] += 1
        return picks, deficit, starve, taken

    @staticmethod
    def _drr_pick(cands: List[_ClassQueue],
                  deficit: Dict[str, float]) -> _ClassQueue:
        """One deficit-round-robin pick among ``cands`` (declaration
        order): first class holding a full credit wins; when none does,
        every candidate is replenished ``quantum * weight`` with the
        quantum sized so the lightest candidate reaches one credit —
        shares stay proportional to weights (DRR is quantum-scale
        invariant) and the replenish loop terminates in one round."""
        while True:
            for cq in cands:
                if deficit[cq.cls.name] >= 1.0:
                    deficit[cq.cls.name] -= 1.0
                    return cq
            quantum = 1.0 / min(cq.cls.weight for cq in cands)
            for cq in cands:
                deficit[cq.cls.name] += quantum * cq.cls.weight

    def _take(self, k: int, engine) -> List[Request]:
        """Pop the next ``k`` fair-share picks and COMMIT the
        deficit/starvation state the plan computed."""
        picks, deficit, starve, taken = self._plan(
            k, self._active_by_class(engine))
        for req in picks:
            cq = self._queues[req.tenant]
            head = cq.queue.popleft()
            assert head is req, "tenancy plan desynced from its queues"
            cq.admitted += 1
        for name, cq in self._queues.items():
            cq.deficit = deficit[name]
            cq.starve = starve[name]
        self._reset_idle()
        return picks

    def _reset_idle(self) -> None:
        # an idle class banks no credit: deficits/starvation reset when
        # its queue drains, so a returning burst competes from scratch
        # instead of cashing in hours of phantom backlog
        for cq in self._queues.values():
            if not cq.queue:
                cq.deficit = 0.0
                cq.starve = 0.0

    # ----------------------------------------------------------- policy
    def _admit_width(self, engine) -> int:
        """The FifoScheduler admission-width rule over the fair-share
        plan instead of the FIFO head prefix — same free-slot gate,
        same page-aware probe, same prefill batching threshold, so a
        default-only configuration is decision-for-decision identical
        to the base scheduler."""
        free = engine.free_slots
        chunks = getattr(engine, "chunk_pending", 0)
        total = len(self)
        if not total or free <= 0:
            return 0
        limit = min(total, free)
        cands = self._plan(limit, self._active_by_class(engine))[0]
        if not cands:
            return 0  # every queued class is at its active-slot quota
        probe = getattr(engine, "admissible_prefix", None)
        if probe is not None:
            k = min(len(cands), probe(cands))
        else:
            k = min(len(cands), engine.prefill_batch)
        if k <= 0:
            return 0
        if engine.active_count == 0 and not chunks:
            return k
        need = max(1, math.ceil(
            (1.0 - self.config.prefill_priority)
            * min(engine.prefill_batch, free)))
        return k if total >= need else 0

    def next_action(self, engine) -> Tuple[str, List[Request]]:
        k = self._admit_width(engine)
        if k > 0:
            return ACTION_PREFILL, self._take(k, engine)
        return self.drain_action(engine), []
