"""Adapter residency registry for batched multi-LoRA serving (counterpart of ``ray_lightning_tpu/serve/adapters.py``).

The port's own copy of the JAX package's module (the port imports
nothing of it), unchanged but for this paragraph, the names of the
modules it points to and the import below.

S-LoRA (Sheng et al., 2023) and Punica (Chen et al., 2023) serve many
LoRA fine-tunes from ONE base model by keeping a resident **adapter
bank** — a ``(num_adapters, ...)`` leading axis on every low-rank pair —
inside the shared batch programs, with each batch row gathering its own
``(A, B)`` slice by integer id. The bank's shape is part of the compiled
program, so adapter churn (hot load, unload, eviction) is a *data*
write, never a recompile; rows bound to different adapters batch in one
dispatch.

This module is the **host-side bookkeeping half** of that design: which
adapter *name* owns which bank *index*, LRU residency with deterministic
eviction, per-adapter refcounts (an adapter pinned by in-flight rows is
never evicted under it), and exact byte accounting. It is deliberately
pure — no framework, no telemetry, no device state. The
:class:`~ray_lightning_tpu_torch.serve.engine.ServeEngine` owns the device
half (grafting banks with :func:`~ray_lightning_tpu_torch.models.lora.
install_lora_bank`, writing slots with :func:`~ray_lightning_tpu_torch.
models.lora.install_adapter`) and emits the ``engine.adapter_*`` events; the
registry just answers "what lives where".

Shedding model (mirrors :class:`~ray_lightning_tpu_torch.serve.tenancy.
ClassQueueFull`): naming an unknown/evicted adapter at submit raises
:class:`UnknownAdapter` — a ``ValueError`` subclass, so every existing
admission-refusal path (client trace shed → ``FINISH_REJECTED``,
supervisor refusal re-raise) handles it without new plumbing — and
loading into a bank whose every slot is pinned raises
:class:`AdapterBankFull`. Both carry registry context as ``[k=v]``
attributes via the shared :class:`~ray_lightning_tpu_torch.serve.request.
OccupancyError` base.

Eviction is **deterministic**: least-recently-*bound* resident with a
zero refcount, ties broken by load order (an :class:`collections.
OrderedDict` walk). Same load/bind sequence → same evictee, always.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ray_lightning_tpu_torch.serve.request import OccupancyError

__all__ = ["AdapterRegistry", "AdapterBankFull", "UnknownAdapter"]


class AdapterBankFull(OccupancyError):
    """Every bank slot is resident AND pinned by in-flight rows — the
    load cannot evict anything. Carries ``capacity``/``pinned``
    context; retry after the pinning requests retire, or size the bank
    with a larger ``max_resident_adapters``."""


class UnknownAdapter(OccupancyError, ValueError):
    """A request named an adapter that is not resident (never loaded,
    or evicted since). ``ValueError`` by inheritance so the existing
    shed/refusal paths (client ``(QueueFull, ValueError)`` catch,
    supervisor refusal re-raise) treat it as the admission refusal it
    is. Carries ``adapter``/``resident`` context."""


class AdapterRegistry:
    """Name → bank-index map with LRU residency and refcounts.

    ``capacity`` is the bank's ``num_adapters`` (fixed at engine build —
    the compiled programs' shapes depend on it). ``bytes_per_adapter``
    is the exact per-slot device footprint (one adapter's slices across
    every bank, from :func:`~ray_lightning_tpu_torch.models.lora.
    adapter_bytes`) so :meth:`resident_bytes` is accounting, not
    estimate.
    """

    def __init__(self, capacity: int, bytes_per_adapter: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.bytes_per_adapter = int(bytes_per_adapter)
        # name -> index, maintained in LRU order (oldest first): admit
        # and bind both move the touched name to the end
        self._resident: "OrderedDict[str, int]" = OrderedDict()
        self._refcount: Dict[str, int] = {}
        self._free: List[int] = list(range(self.capacity))
        self.loads = 0
        self.evictions = 0

    # ------------------------------------------------------------ views
    @property
    def residents(self) -> List[str]:
        """Resident names, least-recently-bound first (eviction order)."""
        return list(self._resident)

    def resident(self, name: str) -> bool:
        return name in self._resident

    def index_of(self, name: str) -> int:
        """Bank index of a resident adapter; :class:`UnknownAdapter`
        otherwise (the submit-time refusal)."""
        idx = self._resident.get(name)
        if idx is None:
            raise UnknownAdapter(
                f"adapter {name!r} is not resident — load it with "
                "load_adapter() (it may have been evicted)",
                adapter=name, resident=self.residents,
                capacity=self.capacity)
        return idx

    def refcount(self, name: str) -> int:
        return self._refcount.get(name, 0)

    def resident_bytes(self) -> int:
        """Exact device bytes attributable to *resident* adapters (the
        bank itself is ``capacity * bytes_per_adapter`` at rest —
        residency accounting reports the slice actually in use)."""
        return len(self._resident) * self.bytes_per_adapter

    # -------------------------------------------------------- lifecycle
    def admit(self, name: str) -> Tuple[int, Optional[str]]:
        """Claim a bank index for ``name``: reuse its resident index,
        else a free slot, else evict the LRU refcount-0 resident.
        Returns ``(index, evicted_name)``; raises
        :class:`AdapterBankFull` when every slot is pinned."""
        if not name or not isinstance(name, str):
            raise ValueError(
                f"adapter name must be a non-empty string, got {name!r}")
        idx = self._resident.get(name)
        if idx is not None:
            self._resident.move_to_end(name)
            return idx, None
        evicted: Optional[str] = None
        if self._free:
            idx = self._free.pop(0)
        else:
            victim = next((n for n in self._resident
                           if self._refcount.get(n, 0) == 0), None)
            if victim is None:
                raise AdapterBankFull(
                    f"cannot load adapter {name!r}: all {self.capacity} "
                    "bank slots are pinned by in-flight requests",
                    capacity=self.capacity,
                    pinned=sum(1 for n in self._resident
                               if self._refcount.get(n, 0) > 0))
            idx = self._resident.pop(victim)
            self._refcount.pop(victim, None)
            self.evictions += 1
            evicted = victim
        self._resident[name] = idx
        self._refcount[name] = 0
        self.loads += 1
        return idx, evicted

    def unload(self, name: str) -> int:
        """Release ``name``'s slot back to the free list. Refuses while
        in-flight rows still pin it (eviction safety is the same rule
        stated explicitly)."""
        idx = self.index_of(name)
        refs = self._refcount.get(name, 0)
        if refs > 0:
            raise OccupancyError(
                f"cannot unload adapter {name!r}: {refs} in-flight "
                "request(s) still bound to it",
                adapter=name, refcount=refs)
        del self._resident[name]
        self._refcount.pop(name, None)
        self._free.append(idx)
        self._free.sort()
        return idx

    # --------------------------------------------------------- pinning
    def bind(self, name: str) -> int:
        """Pin ``name`` for one in-flight request (admission): bumps
        the refcount, touches LRU recency, returns the bank index. The
        index is stable for the request's whole residency — eviction
        skips pinned adapters."""
        idx = self.index_of(name)
        self._refcount[name] = self._refcount.get(name, 0) + 1
        self._resident.move_to_end(name)
        return idx

    def unbind(self, name: str) -> None:
        """Drop one request's pin (retire/cancel/rollback)."""
        refs = self._refcount.get(name, 0)
        if refs <= 0:
            raise ValueError(
                f"unbind of adapter {name!r} without a matching bind")
        self._refcount[name] = refs - 1
