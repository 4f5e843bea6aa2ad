"""FIFO admission + prefill/decode/chunk interleaving policy.

The port's own copy of ``ray_lightning_tpu/serve/scheduler.py`` (the
port imports nothing of the JAX package), unchanged but for this
paragraph and the import below. The chunk half of the policy drives
the engine's chunked prefill (``prefill_chunk=``): with rows decoding,
chunk and decode dispatches alternate strictly.

The scheduler owns the *waiting* side of the engine: a bounded FIFO queue
(admission control — a full queue rejects at submit time, it never grows
unboundedly under overload), per-request deadlines (expired requests are
dropped before they ever touch the accelerator), and the real policy
decisions of continuous batching: **when to spend a step on prefill
instead of decode**, and — chunked engines — **how to interleave a long
prompt's chunk dispatches with in-flight decode**.

A prefill pass stalls every in-flight decode for one program dispatch but
fills free slots (raising decode utilization and cutting queue latency);
decoding first drains in-flight requests sooner but leaves slots idle.
``SchedulerConfig.prefill_priority`` moves along exactly that trade:

- ``1.0`` (default): prefill whenever a request waits and a slot is free —
  lowest time-to-first-token, the latency-serving default.
- ``0.0``: batch prefills — wait until enough requests are queued to fill
  a whole prefill batch (or the engine has nothing to decode), amortizing
  the prefill dispatch across more injected rows — highest decode
  throughput under sustained load.
- values in between scale the batching threshold proportionally.

Chunk interleaving is deliberately NOT a knob: while decode rows are
active, chunk and decode dispatches strictly alternate, so an in-flight
request's worst decode stall is ONE chunk-sized dispatch (that bound is
the whole point of chunked prefill — ``decode_stall_p99_ms`` in the
bench); with nothing decoding, chunks stream back-to-back.

Admission is **page-aware** on paged engines: the scheduler pops only the
queue-head prefix the engine can actually seat
(``engine.admissible_prefix`` — slots, batched-program width, cumulative
page demand against free + evictable pages), keeping FIFO order — a
short request never jumps a long one that's next in line.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, List, Optional, Tuple

from ray_lightning_tpu_torch.serve.request import OccupancyError, Request

# scheduler verdicts for the next engine dispatch
ACTION_PREFILL = "prefill"
ACTION_STEP = "step"
ACTION_CHUNK = "chunk"
ACTION_IDLE = "idle"


class QueueFull(OccupancyError):
    """Admission control: the waiting queue is at max_queue_depth.

    Carries occupancy context for shed-load callers: ``queue_depth``
    (the bound that was hit) and ``oldest_age`` (how long the head of
    the queue has been waiting, in the driving client's clock units —
    None when no clock/arrival data is available). An old head means the
    server is drowning; a young one means a burst just landed.
    """

    def __init__(self, message: str, *, queue_depth: Optional[int] = None,
                 oldest_age: Optional[float] = None, **ctx):
        # **ctx: subclasses and the tenancy layer extend the shed
        # context (per-class queue depths / oldest-age breakdown, the
        # saturated class's name) — the OccupancyError base renders any
        # keys into the message suffix and exposes them as attributes
        super().__init__(message, queue_depth=queue_depth,
                         oldest_age=oldest_age, **ctx)


@dataclasses.dataclass
class SchedulerConfig:
    max_queue_depth: int = 64
    # 1.0 = inject eagerly (best TTFT), 0.0 = batch prefills (best decode
    # throughput); see the module docstring
    prefill_priority: float = 1.0
    # applied to requests submitted without an explicit deadline, as an
    # offset from arrival (clock units of the driving client); None = no
    # default deadline
    default_deadline: Optional[float] = None

    def __post_init__(self):
        if not 0.0 <= self.prefill_priority <= 1.0:
            raise ValueError(
                f"prefill_priority must be in [0, 1], got "
                f"{self.prefill_priority}")
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got "
                f"{self.max_queue_depth}")


class FifoScheduler:
    """Bounded FIFO queue + the prefill/decode/chunk interleaving
    policy."""

    def __init__(self, config: Optional[SchedulerConfig] = None):
        self.config = config or SchedulerConfig()
        self._queue: Deque[Request] = deque()
        # chunk/decode alternation latch — see the module docstring
        self._last_was_chunk = False

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def waiting(self) -> List[Request]:
        return list(self._queue)

    def oldest_age(self, now: Optional[float]) -> Optional[float]:
        """How long the queue head has been waiting (clock units), or
        ``None`` on an empty queue / missing clock data. The fleet
        router reads this as a live backpressure signal; :class:`QueueFull`
        carries it as shed context."""
        if not self._queue or now is None:
            return None
        head = self._queue[0]
        if head.arrival_time is None:
            return None
        return now - head.arrival_time

    def submit(self, request: Request,
               now: Optional[float] = None) -> None:
        """Enqueue, or raise :class:`QueueFull` — overload sheds at the
        door instead of growing an unbounded backlog."""
        if len(self._queue) >= self.config.max_queue_depth:
            raise QueueFull(
                f"queue at max_queue_depth={self.config.max_queue_depth}",
                queue_depth=len(self._queue),
                oldest_age=self.oldest_age(now))
        self._stamp_admission(request, now, self.config.default_deadline)
        self._queue.append(request)

    @staticmethod
    def _stamp_admission(request: Request, now: Optional[float],
                         deadline_offset: Optional[float]) -> None:
        """The one copy of admission stamping, shared with the tenancy
        scheduler (which passes its per-class deadline offset) so the
        two submit paths cannot drift: apply the default deadline as an
        offset from ``now``, and stamp arrival at admission so
        ``oldest_age`` works for direct scheduler callers too (the
        driving client's own post-submit stamp uses the same ``now``,
        so this is a no-op there)."""
        if now is None:
            return
        if request.deadline is None and deadline_offset is not None:
            request.deadline = now + deadline_offset
        if request.arrival_time is None:
            request.arrival_time = now

    def requeue_front(self, requests: List[Request]) -> None:
        """Put popped-but-not-dispatched requests back at the queue head
        in their original order (e.g. a prefill deferred because its seed
        collides with an in-flight request's seed)."""
        for req in reversed(requests):
            self._queue.appendleft(req)

    def expire(self, now: float) -> List[Request]:
        """Drop queued requests whose deadline has passed; returns them
        (the client retires each as a timeout completion)."""
        expired = [r for r in self._queue
                   if r.deadline is not None and now >= r.deadline]
        if expired:
            gone = {id(r) for r in expired}
            self._queue = deque(
                r for r in self._queue if id(r) not in gone)
        return expired

    def _admit_width(self, engine) -> int:
        """How many queue-head requests :meth:`next_action` would pop
        for a prefill RIGHT NOW — 0 when the next dispatch is not a
        prefill. Pure query (no pops, no latch flips): the decision
        half of ``next_action``, shared with :meth:`peek_action` so the
        lookahead can never drift from the real policy."""
        free = engine.free_slots
        chunks = getattr(engine, "chunk_pending", 0)
        if not self._queue or free <= 0:
            return 0
        k = min(len(self._queue), free)
        probe = getattr(engine, "admissible_prefix", None)
        if probe is not None:
            # page-aware admission: only the head prefix that fits
            # slots, pages AND the batched-program width (the probe
            # owns the width rule — chunk-routed requests consume
            # none of it, so pre-capping at prefill_batch here would
            # needlessly throttle them). The probe's verdict over a
            # FIFO prefix is prefix-stable, so feed it the head
            # slice, not a copy of the whole queue.
            k = min(k, probe([self._queue[i] for i in range(k)]))
        else:
            k = min(k, engine.prefill_batch)
        if k <= 0:
            return 0
        if engine.active_count == 0 and not chunks:
            return k
        # batching threshold: how many waiters justify stalling
        # the in-flight decodes for one prefill dispatch
        need = max(1, math.ceil(
            (1.0 - self.config.prefill_priority)
            * min(engine.prefill_batch, free)))
        return k if len(self._queue) >= need else 0

    def next_action(self, engine) -> Tuple[str, List[Request]]:
        """Decide the next engine dispatch.

        Returns ``(ACTION_PREFILL, requests)`` with the requests POPPED
        from the queue, ``(ACTION_CHUNK, [])`` to advance the head
        mid-chunking prompt, ``(ACTION_STEP, [])`` to advance decode, or
        ``(ACTION_IDLE, [])`` when there is nothing to do (the client
        waits for the next arrival).
        """
        k = self._admit_width(engine)
        if k > 0:
            return ACTION_PREFILL, self._pop(k)
        return self.drain_action(engine), []

    def peek_action(self, engine) -> str:
        """What :meth:`next_action` would return, WITHOUT popping
        requests or flipping the chunk/decode alternation latch.

        The fleet's runnable-replica probe reads this (the async client
        itself pipelines off ``next_action`` returning ``ACTION_STEP``
        — this lookahead shares ``_admit_width`` with it, so the two
        can't drift). The verdict is computed against the engine's
        SYNCED host state, so with a dispatch in flight it answers for
        the synced frontier — exactly the state the next *enqueue*
        would be built from."""
        if self._admit_width(engine) > 0:
            return ACTION_PREFILL
        return self._drain_verdict(engine, self._last_was_chunk)[0]

    @staticmethod
    def _drain_verdict(engine, latch: bool) -> Tuple[str, bool]:
        """The chunk/decode half of the policy as a PURE function of
        the alternation latch: ``(action, new_latch)``.
        :meth:`drain_action` commits the latch, :meth:`peek_action`
        discards it — one copy of the policy, so the lookahead cannot
        drift from what the tick actually dispatches."""
        if getattr(engine, "chunk_pending", 0):
            if engine.active_count > 0 and latch:
                return ACTION_STEP, False
            return ACTION_CHUNK, True
        if engine.active_count > 0:
            return ACTION_STEP, False
        return ACTION_IDLE, False

    def drain_action(self, engine) -> str:
        """The chunk/decode half of the policy: strict alternation while
        decode rows are active (the one-chunk stall bound), chunks
        back-to-back otherwise. The client also calls this directly when
        an admission tick dispatched nothing (every popped request
        seed-deferred) — the substitute dispatch must honor the same
        bound, or a persistent deferral would let chunks starve decode."""
        action, self._last_was_chunk = self._drain_verdict(
            engine, self._last_was_chunk)
        return action

    def _pop(self, k: int) -> List[Request]:
        return [self._queue.popleft() for _ in range(k)]
