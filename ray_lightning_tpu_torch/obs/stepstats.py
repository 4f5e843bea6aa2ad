"""Per-step training telemetry: timing, data-wait share, throughput, and an EWMA z-score step-time anomaly detector (counterpart of ``ray_lightning_tpu/obs/stepstats.py``).

MegaScale-style large-run telemetry (Jiang et al., NSDI'24) boils down
to: measure every step, keep a running distribution, and flag the steps
that fall out of it -- a straggling host, a slow storage read, a thermal
throttle all show up as step-time outliers long before they show up in
loss curves. :class:`StepStatsCallback` is that loop for this trainer:

- **step time**: wall clock around the step. CUDA launches are
  asynchronous -- the host blocks only when the launch queue is full --
  so by default this times the step's enqueue, as the JAX callback
  times XLA's dispatch; ``block=True`` calls
  ``Trainer.block_until_ready`` (a ``torch.cuda.synchronize`` of the
  rank's card) before the clock is read, so the step time covers the
  device work, at the cost of the host/device overlap.
- **data-wait share**: fraction of the batch-to-batch interval spent
  before the step (loader + host work) -- the input-bound indicator.
- **tokens/sec**: inferred from the batch's first tensor shape
  (``batch x seq`` for 2-D+ leaves), or supply ``tokens_fn(batch)``.
- **anomaly detection**: an exponentially-weighted moving mean/variance
  of step time; a step whose z-score exceeds ``z_threshold`` (after
  ``warmup_steps``) increments the anomaly counter and emits a
  ``train.straggler`` event with the z-score and the EWMA baseline.

Everything lands in ``trainer.callback_metrics`` (``step_time_ms``,
``data_wait_frac``, ``tokens_per_sec``, ``step_time_z``,
``step_anomalies``), so it rides the rank-0 metric transport to the
driver unchanged. With a :class:`~ray_lightning_tpu_torch.obs.Telemetry`
handle it also feeds the ``train_step_ms`` histogram, the throughput
gauges and the event bus. Nothing it does reads a device tensor.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Optional

from ray_lightning_tpu_torch.core.callbacks import Callback


def _infer_tokens(batch: Any) -> int:
    """batch x seq for the first 2-D+ leaf; batch size for 1-D; 0 when
    the batch has no array leaves (override with ``tokens_fn``). Leaves
    are visited in the JAX package's order (dict keys sorted)."""
    for leaf in _leaves(batch):
        shape = getattr(leaf, "shape", None)
        if shape and len(shape) >= 2:
            return int(shape[0]) * int(shape[1])
        if shape and len(shape) == 1:
            return int(shape[0])
    return 0


def _leaves(tree: Any):
    """The leaves of a nest of dicts, lists and tuples, in
    ``jax.tree_util.tree_leaves``'s order (a dict's keys sorted); None is
    an empty subtree, as it is to jax."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class StepStatsCallback(Callback):
    """Per-step timing/throughput stats + EWMA z-score straggler detector.

    ``StepStatsCallback(telemetry=tel)`` to feed the metrics registry and
    event bus; without a handle it still populates
    ``trainer.callback_metrics`` (host scalars only — nothing touches the
    training step). ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, telemetry=None, *,
                 ewma_alpha: float = 0.1,
                 z_threshold: float = 3.0,
                 warmup_steps: int = 5,
                 min_sigma_frac: float = 0.05,
                 tokens_fn: Optional[Callable[[Any], int]] = None,
                 block: bool = False,
                 clock: Callable[[], float] = time.perf_counter):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        if z_threshold <= 0:
            raise ValueError(
                f"z_threshold must be > 0, got {z_threshold}")
        if min_sigma_frac < 0:
            raise ValueError(
                f"min_sigma_frac must be >= 0, got {min_sigma_frac}")
        self.telemetry = telemetry
        self.ewma_alpha = ewma_alpha
        self.z_threshold = z_threshold
        self.warmup_steps = warmup_steps
        self.min_sigma_frac = min_sigma_frac
        self.tokens_fn = tokens_fn or _infer_tokens
        self.block = block
        self._clock = clock
        # EWMA state (reset per fit)
        self._mean = 0.0
        self._var = 0.0
        self._n = 0
        self.anomalies = 0
        self._t_start: Optional[float] = None
        self._t_prev_end: Optional[float] = None
        # hot-loop caches: instrument handles resolved once, and the
        # per-batch token count memoized (batch shapes are static in
        # this stack — recomputed only if tokens_fn is user-supplied)
        self._tokens_cached: Optional[int] = None
        self._instruments = None

    # ------------------------------------------------------------ hooks
    def on_train_start(self, trainer, pl_module) -> None:
        self._mean = self._var = 0.0
        self._n = 0
        self.anomalies = 0
        self._t_start = self._t_prev_end = None
        self._tokens_cached = None  # a new fit may feed new shapes

    def on_train_epoch_start(self, trainer, pl_module) -> None:
        # epoch boundaries (validation, checkpointing, callbacks) are not
        # data wait; restart the interval measurement
        self._t_prev_end = None

    def on_train_batch_start(self, trainer, pl_module, batch,
                             batch_idx: int) -> None:
        self._t_start = self._clock()

    def on_train_batch_end(self, trainer, pl_module, outputs, batch,
                           batch_idx: int) -> None:
        if self._t_start is None:
            return
        if self.block:
            trainer.block_until_ready()
        now = self._clock()
        step_s = now - self._t_start
        data_wait_s = (self._t_start - self._t_prev_end
                       if self._t_prev_end is not None else 0.0)
        self._t_prev_end = now
        interval = step_s + data_wait_s
        data_wait_frac = data_wait_s / interval if interval > 0 else 0.0
        if self.tokens_fn is not _infer_tokens:
            tokens = self.tokens_fn(batch)
        else:  # static shapes: infer once, reuse every step
            if self._tokens_cached is None:
                self._tokens_cached = _infer_tokens(batch)
            tokens = self._tokens_cached
        tok_rate = tokens / step_s if step_s > 0 else 0.0

        z = self._update_ewma(step_s)
        anomaly = (z is not None and abs(z) > self.z_threshold)
        if anomaly:
            self.anomalies += 1

        step_ms = step_s * 1e3
        trainer.callback_metrics.update({
            "step_time_ms": step_ms,
            "data_wait_frac": data_wait_frac,
            "tokens_per_sec": tok_rate,
            "step_time_z": 0.0 if z is None else z,
            "step_anomalies": float(self.anomalies),
        })

        tel = self.telemetry
        if tel is not None:
            if self._instruments is None:
                m = tel.metrics
                self._instruments = (
                    m.histogram("train_step_ms",
                                help="train step host wall time (ms)"),
                    m.gauge("train_tokens_per_sec",
                            help="tokens through the train step per "
                            "second"),
                    m.gauge("train_data_wait_frac",
                            help="share of the batch interval spent "
                            "waiting on data"),
                    m.counter("train_step_anomalies_total",
                              help="steps whose time broke the EWMA "
                              "z-score threshold"),
                )
            hist, g_tok, g_wait, c_anom = self._instruments
            hist.observe(step_ms)
            g_tok.set(tok_rate)
            g_wait.set(data_wait_frac)
            if anomaly:
                c_anom.inc()
                tel.event("train.straggler", step=trainer.global_step,
                          z=round(z, 2), step_ms=round(step_ms, 3),
                          ewma_ms=round(self._mean * 1e3, 3))

    # ------------------------------------------------------------- ewma
    def _update_ewma(self, x: float) -> Optional[float]:
        """Fold ``x`` into the EWMA mean/var; return the z-score of ``x``
        against the PRE-update baseline (None during warmup — the
        baseline isn't trustworthy yet, and the anomaly must not poison
        its own reference)."""
        z = None
        if self._n >= self.warmup_steps:
            # sigma floor (min_sigma_frac x mean): an ultra-stable
            # baseline (EWMA var -> 0) must neither divide by zero nor
            # turn ordinary µs jitter into "anomalies"
            sigma = max(math.sqrt(self._var) if self._var > 0 else 0.0,
                        self.min_sigma_frac * abs(self._mean) + 1e-12)
            z = (x - self._mean) / sigma
        if self._n == 0:
            self._mean = x
        else:
            diff = x - self._mean
            incr = self.ewma_alpha * diff
            self._mean += incr
            self._var = (1.0 - self.ewma_alpha) * (self._var + diff * incr)
        self._n += 1
        return z

    # ------------------------------------------------------------ state
    def state_dict(self):
        return {"anomalies": self.anomalies}

    def load_state_dict(self, state) -> None:
        self.anomalies = int(state.get("anomalies", 0))
