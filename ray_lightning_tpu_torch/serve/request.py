"""Request/Completion dataclasses for the continuous-batching engine.

The port's own copy of ``ray_lightning_tpu/serve/request.py`` (the port
imports nothing of the JAX package). A :class:`Request` is one user
generation call: its prompt, a per-request token budget, and per-request
sampling params -- each batch row of the engine's step carries its own
temperature/top_k/eos/seed. A row retires the moment it hits eos or
exhausts its budget, and its KV slot is handed to the next queued
request mid-flight.

A :class:`Completion` is the retired request: the generated tokens (eos
included when sampled), why it stopped, its latency stamps, and how many
prompt tokens it took from the prefix cache, its tenant class and the
LoRA adapter it decoded under. A request a crash recovery re-admits
carries the tokens it had emitted (``replay_tokens``) and how many
recoveries it has been part of (``crash_implications``); a recovery that
gives up retires it ``FINISH_FAILED`` with its partial tokens.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

#: the tenant class a request belongs to when none is named: an engine
#: without tenant classes only ever sees this one, and a
#: TenantScheduler holding only it decides as the FIFO scheduler does
DEFAULT_TENANT = "default"

FINISH_EOS = "eos"            # sampled its eos id
FINISH_LENGTH = "length"      # exhausted max_new_tokens
FINISH_TIMEOUT = "timeout"    # deadline expired (queued or mid-decode)
FINISH_REJECTED = "rejected"  # shed at admission (trace replay only)
FINISH_FAILED = "failed"      # engine crash recovery exhausted its retries


class OccupancyError(RuntimeError):
    """Base for admission-control errors carrying occupancy context.

    Keyword context renders as a ``[k=v, ...]`` suffix on the message
    (None values omitted) and every key becomes an attribute."""

    def __init__(self, message: str, **ctx):
        shown = [f"{k}={v}" for k, v in ctx.items() if v is not None]
        super().__init__(
            message + (f" [{', '.join(shown)}]" if shown else ""))
        for k, v in ctx.items():
            setattr(self, k, v)


@dataclasses.dataclass
class Request:
    """One generation request.

    ``seed`` defaults to the request id: the engine derives every sample
    from (engine seed, request seed, step)
    (:func:`~ray_lightning_tpu_torch.models.generate.row_seed`), so a
    request's token stream with ``temperature > 0`` is reproducible
    across arrival orders, slot assignments and batch compositions.
    Distinct co-resident seeds are asserted at slot assignment.

    ``deadline``: optional absolute clock value (in the driving client's
    clock units) after which the request is abandoned.

    ``tenant``: the tenant class whose queue, quotas and fair share the
    request rides (:mod:`~ray_lightning_tpu_torch.serve.tenancy`); it
    orders admissions and never changes tokens. ``adapter``: the
    resident LoRA adapter whose bank slot the request's rows gather
    (:mod:`~ray_lightning_tpu_torch.serve.adapters`); None is the base
    model, or the tenant class's default adapter, which the engine
    resolves at admission and stamps here.
    """
    id: int
    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    eos_id: Optional[int] = None
    seed: Optional[int] = None
    deadline: Optional[float] = None
    tenant: str = DEFAULT_TENANT
    # timing bookkeeping, stamped by the driving client (clock units)
    arrival_time: Optional[float] = None
    first_token_time: Optional[float] = None
    # crash-recovery replay (set by ServeSupervisor or a journal restore,
    # never by submit): tokens this request had already emitted before
    # its engine died. Prefill re-feeds prompt + replay_tokens and
    # samples step len(replay_tokens) with that step's seed
    replay_tokens: Optional[List[int]] = None
    # prompt tokens whose KV came from the prefix cache at admission
    prefix_hit_tokens: int = 0
    # recovery episodes this request has been co-batched with (bumped by
    # ServeSupervisor per recovery, carried through re-admission)
    crash_implications: int = 0
    adapter: Optional[str] = None

    def __post_init__(self):
        self.prompt = [int(t) for t in self.prompt]
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if not self.tenant or not isinstance(self.tenant, str):
            raise ValueError(
                f"tenant must be a non-empty string, got {self.tenant!r}")
        if self.adapter is not None and (
                not self.adapter or not isinstance(self.adapter, str)):
            raise ValueError(
                f"adapter must be a non-empty string or None, "
                f"got {self.adapter!r}")
        if self.seed is None:
            self.seed = self.id

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclasses.dataclass
class Completion:
    """A retired request: output tokens + stop reason + latency stamps."""
    request_id: int
    prompt: List[int]
    tokens: List[int]               # generated tokens, eos included
    finish_reason: str              # FINISH_EOS | FINISH_LENGTH | ...
    arrival_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    prefix_hit_tokens: int = 0
    # the retiring request's tenant class, and the adapter it decoded
    # under (after a tenant class's default; None = the base model)
    tenant: str = DEFAULT_TENANT
    adapter: Optional[str] = None

    @property
    def latency(self) -> Optional[float]:
        """Arrival -> completion, in the driving client's clock units."""
        if self.arrival_time is None or self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def time_to_first_token(self) -> Optional[float]:
        if self.arrival_time is None or self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time
