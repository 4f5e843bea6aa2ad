"""Directory checkpoints and the resume scan (counterpart of ``ray_lightning_tpu/core/checkpoint.py``).

Two formats hold the same logical dict (``state`` / ``epoch`` /
``global_step`` / ``loop`` / ``world`` / ``callbacks`` / ``module`` and
``callback_arrays``), so ``Trainer.fit(ckpt_path=...)`` takes either --
a file is a stream, a directory is the directory format:

- **stream** (``Trainer.save_checkpoint``'s default): ``torch.save`` of
  the whole dict into one file (:mod:`ray_lightning_tpu_torch.util`).
- **directory** (``save_format="orbax"``, the JAX package's name, kept
  for users' code): written by :func:`save_sharded_checkpoint` through
  ``torch.distributed.checkpoint`` (DCP), or, in a torch built without
  distributed support (:func:`have_dcp`), by one plain ``torch.save`` --
  chosen automatically, as the JAX package falls back to numpy without
  orbax. DCP keys tensors by a flat name, so the writer flattens the
  tensors itself (``state/params/...``,
  ``state/opt_state/state/0/exp_avg``) and keeps the nest they came from
  in the meta file; loading rebuilds it and reads either writer's
  directory.

Crash-safety contract, both writers:

- A directory is staged in a ``<dir>.tmp-<pid>-<n>`` sibling and
  ``os.replace``\\ d into place; a process killed mid-save leaves only
  the staging directory, which resume scans ignore.
- ``tl_meta.pt`` is the commit marker, written *last* inside the
  staging directory (after DCP's own files): a directory without it is
  an interrupted save, and :func:`load_sharded_checkpoint` raises
  :class:`CorruptCheckpointError` instead of a bare DCP or pickle error.
  ``Trainer(resume="auto")`` skips such candidates.
- The ``ckpt.save`` fault site fires at the pre-commit point of every
  writer (and of the stream file's), so tests kill saves mid-flight.

``async_save=True`` (DCP only) returns once the tensors are staged in
host memory; a background thread (one for the process, so commits land
in the order issued) finishes the write, then the marker and the rename.
In one process the staging is the port's own: every tensor is copied to
a CPU tensor on the caller's thread (no reference to a live CUDA tensor
outlives the call, so the next step may overwrite the params), and the
commit thread writes those copies with DCP's one-process ``save`` -- the
JAX package's one-process async orbax save
(``ray_lightning_tpu/core/checkpoint.py:144-148``). Under a process group
the staging is DCP's ``async_save``. :func:`wait_for_async_saves` waits
for every such commit; the trainer calls it at fit end and before it
reads a checkpoint.

Under a process group (a multi-worker strategy) a directory save is a
collective: rank 0 stages the directory and broadcasts its name, every
rank writes its shards through DCP (replicated tensors are written
once), and after a barrier rank 0 writes the marker and commits. DCP's
exchanges run on the strategy's own gloo group, also from the async
thread, and one async save is in flight at a time, so the collectives
of two saves never interleave. Loading reads the whole state on every
rank, with no collective.
"""
from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import itertools
import os
import shutil
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_lightning_tpu_torch.reliability import faults, log_suppressed

_META_NAME = "tl_meta.pt"
_STATE_NAME = "state"            # the DCP checkpoint inside the directory
_TORCH_STATE_NAME = "state.pt"   # the torch.save payload
_TMP_MARK = ".tmp-"
_LAYOUT = "__layout__"
_TENSOR = "__tensor__"

# one commit thread: async saves finish (and rename) in the order issued
_COMMITS: Optional[concurrent.futures.ThreadPoolExecutor] = None
_PENDING: List[concurrent.futures.Future] = []
_STAGES = itertools.count()   # async saves to one path stage apart


class CorruptCheckpointError(RuntimeError):
    """A checkpoint directory/file is incomplete or unreadable -- the
    saving process likely died before its commit finished. Auto-resume
    skips such candidates; manual loads should pick an older one."""


def have_dcp() -> bool:
    """DCP needs a torch built with distributed support; without it the
    directory format falls back to the plain ``torch.save`` writer."""
    return torch.distributed.is_available()


def _dcp():
    import torch.distributed.checkpoint as dcp
    return dcp


@contextlib.contextmanager
def _quiet():
    """DCP warns on every call that it runs in one process without a
    process group, which is the one-process trainer's design."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="torch.distributed is disabled")
        yield


def _split(tree: Any, prefix: str, out: Dict[str, torch.Tensor]) -> Any:
    """``tree`` with every tensor replaced by ``{"__tensor__": name}``;
    the tensors go to ``out`` under their path names."""
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach()
        return {_TENSOR: prefix}
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        return {k: _split(v, join(k), out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split(v, join(i), out)
                          for i, v in enumerate(tree))
    return tree


def _join(layout: Any, tensors: Dict[str, torch.Tensor]) -> Any:
    if isinstance(layout, dict):
        if set(layout) == {_TENSOR}:
            return tensors[layout[_TENSOR]]
        return {k: _join(v, tensors) for k, v in layout.items()}
    if isinstance(layout, (list, tuple)):
        return type(layout)(_join(v, tensors) for v in layout)
    return layout


def _meta(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in ckpt.items()
            if k not in ("state", "callback_arrays")}


def _commit(tmp: str, dirpath: str) -> None:
    """Publish a staged directory. ``os.replace`` cannot replace a
    non-empty directory, so an existing checkpoint is first renamed
    aside (atomic) and removed after the new one lands: at every instant
    one committed copy is on disk (the aside copy is still a candidate;
    only ``.tmp-`` staging is ignored)."""
    aside = None
    if os.path.isdir(dirpath):
        aside = f"{dirpath}.prev-{os.getpid()}"
        shutil.rmtree(aside, ignore_errors=True)
        os.replace(dirpath, aside)
    os.replace(tmp, dirpath)
    if aside is not None:
        shutil.rmtree(aside, ignore_errors=True)


def _stage(dirpath: str) -> Tuple[str, str]:
    dirpath = os.path.abspath(dirpath)
    parent = os.path.dirname(dirpath)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{dirpath}{_TMP_MARK}{os.getpid()}-{next(_STAGES)}"
    os.makedirs(tmp)
    return dirpath, tmp


def wait_for_async_saves() -> None:
    """Block until every in-flight async checkpoint has committed (its
    marker written and its directory renamed into place); re-raises the
    first failure. No-op when no async save was issued."""
    while _PENDING:
        _PENDING.pop(0).result()


def save_sharded_checkpoint(dirpath: str, ckpt: Dict[str, Any],
                            async_save: bool = False,
                            strategy: Any = None) -> None:
    """Write ``ckpt`` as a committed directory, through DCP where
    :func:`have_dcp`, else through the plain ``torch.save`` writer.

    ``async_save`` (DCP only) returns once the tensors are staged in
    host memory; call :func:`wait_for_async_saves` before relying on the
    files. ``strategy``: the trainer's, whose process group (when it is
    up) makes the save the collective the module docstring describes.
    """
    world = strategy is not None and strategy.in_world
    if not have_dcp():
        if async_save:
            raise ValueError(
                "async_save requires torch.distributed.checkpoint (the "
                "plain writer is a synchronous host write)")
        _save_torch_checkpoint(dirpath, ckpt)
        return
    if not async_save or world:
        # an async save still in flight must not commit over this one,
        # nor run its collectives beside this one's
        wait_for_async_saves()
    lead = not world or strategy.global_rank == 0
    group = strategy.checkpoint_group() if world else None
    if lead:
        dirpath, tmp = _stage(dirpath)
    else:
        dirpath, tmp = os.path.abspath(dirpath), None
    if world:
        tmp = strategy.broadcast_object(tmp)
    tensors: Dict[str, torch.Tensor] = {}
    layout = _split({"state": ckpt.get("state"),
                     "callback_arrays": ckpt.get("callback_arrays")},
                    "", tensors)
    meta = {**_meta(ckpt), _LAYOUT: layout}
    target = os.path.join(tmp, _STATE_NAME)

    def finish():
        if not lead:
            return
        with open(os.path.join(tmp, _META_NAME), "wb") as f:
            torch.save(meta, f)                 # the marker, last
        _commit(tmp, dirpath)

    def discard():
        if lead:
            shutil.rmtree(tmp, ignore_errors=True)

    if async_save:
        global _COMMITS
        try:
            faults.fire("ckpt.save")
            if world:
                with _quiet():
                    future = _dcp().async_save(tensors, checkpoint_id=target,
                                               process_group=group)
            else:
                # host copies taken here, on the caller's thread: the
                # commit thread never touches a live tensor
                tensors = host_copy(tensors)
        except BaseException:
            discard()
            raise
        if _COMMITS is None:
            _COMMITS = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-commit")
            # a run that exits right after its last async save must not
            # lose the tail commit
            atexit.register(wait_for_async_saves)

        def commit():
            # DCP's last exchange gathers every rank's write results on
            # rank 0, so rank 0's future resolves after every shard is in
            try:
                if world:
                    future.result()
                else:
                    with _quiet():
                        _dcp().save(tensors, checkpoint_id=target)
                finish()
            except BaseException:
                discard()
                raise

        _PENDING.append(_COMMITS.submit(commit))
        return
    try:
        with _quiet():
            _dcp().save(tensors, checkpoint_id=target, process_group=group)
        # pre-commit point: a raise here = the process died mid-save;
        # only the staging directory (ignored by resume scans) remains
        faults.fire("ckpt.save")
        if world:
            strategy.barrier()      # every rank's shards are written
        finish()
    finally:
        discard()
    if world:
        strategy.barrier()          # committed before any rank reads it


def host_copy(tree: Any) -> Any:
    """``tree`` with every tensor replaced by a copy of it in CPU memory
    (a CPU tensor is cloned too): what an asynchronous writer or the
    in-memory checkpoint tier may hold while training goes on. A CUDA
    tensor is never kept, so nothing depends on the process (and the
    CUDA context) that made it."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def _save_torch_checkpoint(dirpath: str, ckpt: Dict[str, Any]) -> None:
    """The writer without DCP: one ``torch.save`` of the tensors' nest
    beside the meta, staged and committed as the DCP writer's."""
    dirpath, tmp = _stage(dirpath)
    try:
        payload = {"state": ckpt.get("state"),
                   "callback_arrays": ckpt.get("callback_arrays")}
        with open(os.path.join(tmp, _TORCH_STATE_NAME), "wb") as f:
            torch.save(payload, f)
        with open(os.path.join(tmp, _META_NAME), "wb") as f:
            torch.save(_meta(ckpt), f)
        faults.fire("ckpt.save")
        _commit(tmp, dirpath)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _read_meta(meta_path: str) -> Dict[str, Any]:
    try:
        with open(meta_path, "rb") as f:
            return torch.load(f, map_location="cpu", weights_only=True)
    except Exception as exc:
        raise CorruptCheckpointError(
            f"unreadable checkpoint meta {meta_path}: "
            f"{type(exc).__name__}: {exc}") from exc


def load_sharded_checkpoint(dirpath: str,
                            map_location=None) -> Dict[str, Any]:
    """Inverse of :func:`save_sharded_checkpoint` -> the logical dict,
    its tensors on ``map_location`` (default the CPU).

    Raises :class:`CorruptCheckpointError` for a directory without its
    ``tl_meta.pt`` commit marker or with unreadable contents, so resume
    logic can skip to an older candidate.
    """
    dirpath = os.path.abspath(dirpath)
    meta_path = os.path.join(dirpath, _META_NAME)
    torch_path = os.path.join(dirpath, _TORCH_STATE_NAME)
    dcp_path = os.path.join(dirpath, _STATE_NAME)
    if not os.path.exists(meta_path):
        raise CorruptCheckpointError(
            f"{dirpath} has no '{_META_NAME}' commit marker -- the save "
            "was interrupted before it finished. Pick an older "
            "checkpoint.")
    out = dict(_read_meta(meta_path))
    layout = out.pop(_LAYOUT, None)
    if os.path.exists(torch_path):
        try:
            with open(torch_path, "rb") as f:
                payload = torch.load(f, map_location=map_location or "cpu",
                                     weights_only=True)
        except Exception as exc:
            raise CorruptCheckpointError(
                f"unreadable checkpoint {torch_path}: "
                f"{type(exc).__name__}: {exc}") from exc
    elif os.path.isdir(dcp_path) and layout is not None:
        payload = _join(layout, _load_dcp(dcp_path, map_location))
    else:
        raise CorruptCheckpointError(
            f"{dirpath} has no committed state -- the checkpoint is "
            "incomplete. Pick an older checkpoint.")
    out["state"] = payload["state"]
    if payload.get("callback_arrays") is not None:
        out["callback_arrays"] = payload["callback_arrays"]
    return out


def _load_dcp(path: str, map_location) -> Dict[str, torch.Tensor]:
    dcp = _dcp()
    try:
        with _quiet():
            md = dcp.FileSystemReader(path).read_metadata()
            tensors = {
                k: torch.empty(tuple(m.size), dtype=m.properties.dtype,
                               device=map_location or "cpu")
                for k, m in md.state_dict_metadata.items()}
            dcp.load(tensors, checkpoint_id=path, no_dist=True)
    except Exception as exc:
        raise CorruptCheckpointError(
            f"failed to load the DCP state from {path}: "
            f"{type(exc).__name__}: {exc}") from exc
    return tensors


def reshard_state(state: Any, restored: Dict[str, Any],
                  strategy: Any) -> Any:
    """Copy a restored ``state`` dict into the live train state under the
    resuming strategy's layout -- the save-N-way / restore-M-way seat of
    elastic recovery (the JAX package's ``reshard_state``).

    Every loader here returns the *whole* state (the one-process layout,
    full tensors) on every rank, whatever world wrote it, so resharding
    is the strategy's own load: replicated under DDP and the all-reduce,
    this rank's slices by the JAX rule under ZeRO, FSDP2's
    ``torch.chunk`` split on the resuming mesh. A checkpoint of any
    world size therefore restores element-identical params and optimizer
    state. Raises :class:`CorruptCheckpointError` when the state cannot
    adopt the live one (a foreign checkpoint), so ``resume="auto"`` falls
    back to an older candidate."""
    try:
        strategy.load_state_dict(state, restored)
    except (KeyError, IndexError, TypeError, RuntimeError,
            ValueError) as exc:
        raise CorruptCheckpointError(
            "checkpoint state does not match the resuming run's state: "
            f"{type(exc).__name__}: {exc}") from exc
    return state


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(path)


def step_of(path: str) -> int:
    """Parse the ``step=N`` our ModelCheckpoint naming embeds, else -1."""
    name = os.path.basename(path)
    for part in name.replace(".ckpt", "").replace(".orbax", "").split("-"):
        if part.startswith("step="):
            try:
                return int(part[len("step="):])
            except ValueError:
                return -1
    return -1


def is_committed_checkpoint(path: str) -> bool:
    """True when ``path`` is a *committed* checkpoint: a stream file, or
    a directory carrying the ``tl_meta.pt`` commit marker."""
    if os.path.isdir(path):
        return os.path.exists(os.path.join(path, _META_NAME))
    return path.endswith(".ckpt")


def prune_checkpoints(root: str, keep_last_n: int,
                      protect: Any = ()) -> List[str]:
    """Delete committed checkpoints beyond the newest ``keep_last_n``.

    Only committed candidates are touched (staging directories are never
    candidates, marker-less directories are left alone), the newest
    ``keep_last_n`` always survive, and any path in ``protect`` (e.g. a
    ModelCheckpoint's best/top-k ledger) survives regardless of age.
    Returns the paths actually deleted.
    """
    if keep_last_n < 1:
        raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
    protected = {os.path.abspath(p) for p in protect if p}
    committed = [p for p in find_resume_candidates(root)
                 if is_committed_checkpoint(p)]
    doomed = [p for p in committed[keep_last_n:]
              if os.path.abspath(p) not in protected]
    deleted = []
    for path in doomed:
        try:
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
        except OSError as exc:
            # still on disk, still a valid resume fallback: not reported
            # deleted
            log_suppressed("ckpt.prune", exc,
                           f"could not prune old checkpoint {path}")
        else:
            deleted.append(path)
    return deleted


def find_resume_candidates(root: str,
                           keep_last_n: Optional[int] = None) -> List[str]:
    """Checkpoint candidates under ``root``, best-first: by the
    ``step=N`` in our file names (newest progress first), then mtime.
    Staging directories (``*.tmp-*``) are never candidates. The caller
    (``resume="auto"``) tries each in turn and skips the ones that raise
    :class:`CorruptCheckpointError`. ``keep_last_n`` first prunes
    committed candidates beyond the newest ``keep_last_n``."""
    if not os.path.isdir(root):
        return []
    stamped = []
    for name in sorted(os.listdir(root)):
        if _TMP_MARK in name:
            continue
        path = os.path.join(root, name)
        if os.path.isdir(path) or name.endswith(".ckpt"):
            try:
                stamped.append((step_of(path), os.path.getmtime(path), path))
            except FileNotFoundError:
                # gone since the listing: an async writer moved its
                # previous copy aside and removed it
                continue
    out = [path for *_, path in sorted(stamped, reverse=True)]
    if keep_last_n is not None:
        pruned = set(prune_checkpoints(root, keep_last_n))
        out = [p for p in out if p not in pruned]
    return out
