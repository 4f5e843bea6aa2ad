"""The port's multiprocess loader (``ray_lightning_tpu_torch/_native.py``, ``csrc/shm_ring.cpp``, ``data/multiproc.py``) against the JAX package.

- The ring cases of ``tests/test_native.py``, on the port's ring: framed
  round trips and wrap-around, close and drain, oversized messages, pop
  timeouts, a forked child pushing across processes, scatter-gather
  pushes and the zero-copy unpack. The library is the port's own build
  of ``csrc/shm_ring.cpp`` in ``ray_lightning_tpu_torch/_build/``; a
  broken source raises with the compiler's output.
- ``MultiprocessDataLoader`` yields exactly the batches of the JAX
  package's ``MultiprocessDataLoader`` on the same arrays and seed
  (bitwise: the batches are gathered rows, no arithmetic), under fork
  and under spawn, across two epochs; a worker's error reaches the
  consumer; the start-method rule, the strided ``iter_batches``, the
  in-process fallback and the worker cap under a patched core count.
- ``DevicePrefetcher`` on the CPU keeps the order and hands tensors over
  the same memory, and a one-process ``Trainer.fit`` fed through the
  ring and the prefetcher ends with the same parameters, bitwise, as the
  fit fed in-process.

The overlap measurement of ``tests/test_native.py`` (a host-timing test)
is not repeated here: the overlap is measured on the card.
"""
import os
import pickle
import threading
import warnings

import numpy as np
import pytest
import torch

from ray_lightning_tpu.data.loader import ArrayDataset as JaxArrayDataset
from ray_lightning_tpu.data.loader import DataLoader as JaxDataLoader
from ray_lightning_tpu.data.multiproc import \
    MultiprocessDataLoader as JaxMultiprocessDataLoader
from ray_lightning_tpu_torch import _build, _native
from ray_lightning_tpu_torch._native import ShmRing, native_available
from ray_lightning_tpu_torch.data import multiproc as mp_mod
from ray_lightning_tpu_torch.data.loader import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.data.multiproc import (DevicePrefetcher,
                                                    MultiprocessDataLoader,
                                                    _pack_frames,
                                                    _unpack_frames,
                                                    default_mp_context)

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port


def _name(tag):
    return f"/tl_pt_{os.getpid()}_{tag}"


# --------------------------------------------------------------------- ring
def test_ring_library_is_the_ports_own_build():
    assert native_available()
    lib = _native.load()
    path = _build._host_target("shm_ring")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert lib._name == str(path)
    src = _build.CSRC / "shm_ring.cpp"
    jax_src = (_build.PKG.parent / "ray_lightning_tpu" / "_native"
               / "shm_ring.cpp")
    assert src.read_bytes() == jax_src.read_bytes()


def test_a_broken_source_raises_with_the_compiler_output(tmp_path,
                                                         monkeypatch):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "shm_ring.cpp").write_text("int broken(\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        _build.build_host("shm_ring")
    assert not any((tmp_path / "_build").glob("*.so"))


def test_disable_native_is_the_explicit_opt_out(monkeypatch):
    monkeypatch.setenv("TL_DISABLE_NATIVE", "1")
    assert not native_available()
    with pytest.raises(RuntimeError, match="TL_DISABLE_NATIVE"):
        ShmRing(_name("off"), capacity=1 << 12)


def test_ring_roundtrip():
    r = ShmRing(_name("rt"), capacity=1 << 16)
    try:
        r.push(b"alpha")
        r.push(b"beta" * 100)
        assert len(r) == 2
        assert r.pop() == b"alpha"
        assert r.pop() == b"beta" * 100
    finally:
        r.destroy()


def test_ring_wraparound_many_sizes():
    r = ShmRing(_name("wrap"), capacity=1 << 14)
    msgs = [bytes([i % 256]) * ((i * 37) % 4000 + 1) for i in range(300)]
    got = []

    def produce():
        for m in msgs:
            r.push(m, timeout=30)
        r.close()

    def consume():
        while True:
            m = r.pop(timeout=30)
            if m is None:
                return
            got.append(m)

    try:
        tp, tc = (threading.Thread(target=produce),
                  threading.Thread(target=consume))
        tp.start(); tc.start(); tp.join(); tc.join()
        assert got == msgs
    finally:
        r.destroy()


def test_ring_close_oversize_and_timeout():
    r = ShmRing(_name("close"), capacity=1 << 12)
    try:
        r.push(b"last")
        r.close()
        assert r.closed
        assert r.pop() == b"last"
        assert r.pop() is None
        with pytest.raises(BrokenPipeError):
            r.push(b"late")
    finally:
        r.destroy()
    r = ShmRing(_name("big"), capacity=1 << 12)
    try:
        with pytest.raises(ValueError, match="half the ring"):
            r.push(b"x" * (1 << 12))
        with pytest.raises(TimeoutError):
            r.pop(timeout=0.05)
    finally:
        r.destroy()


def test_ring_cross_process():
    import multiprocessing as mp
    name = _name("xproc")
    r = ShmRing(name, capacity=1 << 16)

    def child():
        ring = ShmRing.attach(name)
        for i in range(20):
            ring.push(pickle.dumps(np.full((8, 8), i)))
        ring.close()

    try:
        p = mp.get_context("fork").Process(target=child, daemon=True)
        p.start()
        out = []
        while True:
            m = r.pop(timeout=30)
            if m is None:
                break
            out.append(pickle.loads(m))
        p.join()
        assert len(out) == 20
        for i, arr in enumerate(out):
            np.testing.assert_array_equal(arr, np.full((8, 8), i))
    finally:
        r.destroy()


def test_ring_scatter_gather_zero_copy_and_writable():
    """Arrays come back as windows into the one popped buffer, and that
    buffer is writable: ``torch.from_numpy`` takes them without a copy
    and without the read-only warning."""
    r = ShmRing(_name("sg"), capacity=1 << 22)
    try:
        x = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
        y = np.arange(64, dtype=np.int64)
        r.push_buffers(_pack_frames(("batch", (x, y))))
        view = r.pop_view()
        kind, (gx, gy) = _unpack_frames(view)
        assert kind == "batch"
        np.testing.assert_array_equal(gx, x)
        np.testing.assert_array_equal(gy, y)
        backing = np.frombuffer(view, dtype=np.uint8)
        assert np.shares_memory(gx, backing)
        assert np.shares_memory(gy, backing)
        assert gx.flags.writeable and gy.flags.writeable
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            t = torch.from_numpy(gx)
        assert np.shares_memory(t.numpy(), backing)
        r.push_buffers(_pack_frames(("error", "boom", "trace")))
        assert _unpack_frames(r.pop_view()) == ("error", "boom", "trace")
    finally:
        r.destroy()


def test_ring_scatter_gather_noncontiguous_and_raw_strided():
    r = ShmRing(_name("sgnc"), capacity=1 << 22)
    try:
        contig = np.arange(32 * 8, dtype=np.float32).reshape(32, 8)
        r.push_buffers(_pack_frames((contig, contig.T, contig[::2])))
        gc, gs, ge = _unpack_frames(r.pop_view())
        np.testing.assert_array_equal(gc, contig)
        np.testing.assert_array_equal(gs, contig.T)
        np.testing.assert_array_equal(ge, contig[::2])
        ints = np.arange(16 * 4, dtype=np.int32).reshape(16, 4)
        r.push_buffers([b"hdr", memoryview(ints.T), ints[::2]])
        assert r.pop() == (b"hdr" + np.ascontiguousarray(ints.T).tobytes()
                           + np.ascontiguousarray(ints[::2]).tobytes())
    finally:
        r.destroy()


def test_ring_scatter_gather_wraparound():
    r = ShmRing(_name("sgwrap"), capacity=1 << 14)
    try:
        for i in range(40):
            arr = np.full((13 + (i % 7), 11), i, dtype=np.int32)
            r.push_buffers(_pack_frames(arr), timeout=30)
            np.testing.assert_array_equal(
                _unpack_frames(r.pop_view(timeout=30)), arr)
    finally:
        r.destroy()


def test_frames_equal_the_jax_packages():
    from ray_lightning_tpu.data.multiproc import _pack_frames as jax_pack
    obj = ("batch", (np.arange(12, dtype=np.float32).reshape(3, 4),
                     np.arange(3, dtype=np.int32)), {"k": [1, 2]})
    ours = b"".join(bytes(memoryview(b).cast("B")) for b in
                    _pack_frames(obj))
    theirs = b"".join(bytes(memoryview(b).cast("B")) for b in
                      jax_pack(obj))
    assert ours == theirs


# ------------------------------------------------------------------- loader
def _arrays(n=64):
    x = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    y = np.arange(n, dtype=np.int32)
    return x, y


def _make_loader(n=64, batch=8, shuffle=True):
    return DataLoader(ArrayDataset(_arrays(n)), batch_size=batch,
                      shuffle=shuffle, seed=7)


def _jax_loader(n=64, batch=8, shuffle=True):
    return JaxDataLoader(JaxArrayDataset(_arrays(n)), batch_size=batch,
                         shuffle=shuffle, seed=7)


def _epochs(loader, n=2):
    out = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        out.append([(np.asarray(x), np.asarray(y)) for x, y in loader])
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb) and ea
        for (ax, ay), (bx, by) in zip(ea, eb):
            np.testing.assert_array_equal(ax, bx)
            np.testing.assert_array_equal(ay, by)


@pytest.fixture(scope="module")
def jax_epochs():
    """The JAX package's ring loader, two epochs (forked producers)."""
    return _epochs(JaxMultiprocessDataLoader(
        _jax_loader(), num_workers=3, auto_fallback=False,
        mp_context="fork"))


@pytest.mark.parametrize("ctx", ["fork", "spawn"])
def test_loader_batches_equal_the_jax_loaders(jax_epochs, ctx):
    loader = MultiprocessDataLoader(_make_loader(), num_workers=3,
                                    auto_fallback=False, mp_context=ctx)
    assert loader.uses_ring and loader.mp_context == ctx
    got = _epochs(loader)
    _assert_same(got, jax_epochs)
    _assert_same(got, _epochs(_make_loader()))
    # shuffle: the epochs differ in order, not in rows
    assert any(not np.array_equal(a[1], b[1])
               for a, b in zip(got[0], got[1]))
    assert loader.stats["batches"] == 8
    assert loader.stats["bytes"] > 8 * 8 * (4 * 4 + 4)
    assert 0 < loader.stats["first_batch_s"] <= loader.stats["seconds"]


class _ExplodingLoader:
    # module-level: a spawned producer unpickles it
    def __iter__(self):
        yield (np.zeros(2), np.zeros(2))
        raise RuntimeError("loader exploded")


def test_a_worker_error_reaches_the_consumer():
    loader = MultiprocessDataLoader(_ExplodingLoader(), num_workers=1,
                                    auto_fallback=False, mp_context="fork")
    with pytest.raises(RuntimeError, match="loader exploded"):
        list(loader)


def test_a_consumer_that_stops_early_ends_its_producers_cleanly():
    """Abandoning the iterator (a step limit, the trainer's peek at the
    first batch) closes the rings; the producers see the closed ring,
    stop, and exit 0; the ring segments are unlinked."""
    import multiprocessing as mp
    loader = MultiprocessDataLoader(_make_loader(n=512, batch=2),
                                    num_workers=2, auto_fallback=False,
                                    mp_context="fork", ring_capacity=1 << 12)
    it = iter(loader)
    first = [next(it) for _ in range(3)]
    assert len(first) == 3
    before = set(mp.active_children())
    assert len(before) == 2
    it.close()
    assert not (set(mp.active_children()) & before)
    assert [p.exitcode for p in before] == [0, 0]
    assert not [f for f in os.listdir("/dev/shm")
                if f.startswith(f"tl_{os.getpid()}_")]


def test_the_start_method_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert default_mp_context() == "fork"
    loader = MultiprocessDataLoader(_make_loader(), num_workers=1)
    assert loader.mp_context == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert default_mp_context() == "spawn"
    # decided when the producers start, not when the loader was built
    assert loader.mp_context == "spawn"
    assert MultiprocessDataLoader(_make_loader(), num_workers=1,
                                  mp_context="fork").mp_context == "fork"


def test_iter_batches_strided_equals_jax():
    full = list(_make_loader(shuffle=False))
    for w in range(3):
        ours = list(_make_loader().iter_batches(start=w, step=3))
        theirs = list(_jax_loader().iter_batches(start=w, step=3))
        _assert_same([ours], [theirs])
        for i, (gx, _) in enumerate(
                _make_loader(shuffle=False).iter_batches(start=w, step=3)):
            np.testing.assert_array_equal(gx, full[w + 3 * i][0])
    loader = _make_loader()
    list(loader.iter_batches(1, 2))
    assert loader._epoch == 0      # iter_batches leaves the epoch alone
    list(loader)
    assert loader._epoch == 1      # a full pass advances it


def test_fallback_without_native(monkeypatch):
    monkeypatch.setattr(mp_mod, "native_available", lambda: False)
    loader = MultiprocessDataLoader(_make_loader(), num_workers=2,
                                    auto_fallback=False)
    assert loader.native is False and loader.uses_ring is False
    _assert_same([list(loader)], [list(_make_loader())])


def test_auto_fallback_and_worker_cap(monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    auto = MultiprocessDataLoader(_make_loader(), num_workers=3)
    assert auto.uses_ring is False and auto.num_workers == 1
    _assert_same([list(auto)], [list(_make_loader())])
    forced = MultiprocessDataLoader(_make_loader(), num_workers=3,
                                    auto_fallback=False)
    assert forced.uses_ring is True and forced.num_workers == 3
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    capped = MultiprocessDataLoader(_make_loader(), num_workers=8)
    assert capped.num_workers == 3 and capped.uses_ring is True


# --------------------------------------------------------------- prefetcher
def test_device_prefetcher_order_on_the_cpu():
    ref = list(_make_loader(shuffle=False))
    pref = DevicePrefetcher(_make_loader(shuffle=False), device="cpu",
                            depth=3)
    got = list(pref)
    assert len(got) == len(ref) == len(pref)
    for (rx, ry), (gx, gy) in zip(ref, got):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        np.testing.assert_array_equal(rx, gx.numpy())
        np.testing.assert_array_equal(ry, gy.numpy())
    assert pref.copies == 0  # the CPU path hands over the same memory
    writable = np.arange(4.0)
    frozen = np.arange(4.0)
    frozen.flags.writeable = False
    (tw, tf), = list(DevicePrefetcher([(writable, frozen)], device="cpu"))
    assert np.shares_memory(tw.numpy(), writable)
    assert not np.shares_memory(tf.numpy(), frozen)   # copied, once


def test_device_prefetcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher(_make_loader())


# ------------------------------------------------------------------ the fit
from ray_lightning_tpu_torch.models import GPTModule  # noqa: E402


class RingGPT(GPTModule):
    """``GPTModule`` fed through the ring and the prefetcher (module
    level: the trainer may pickle it)."""

    def train_dataloader(self):
        return DevicePrefetcher(MultiprocessDataLoader(
            super().train_dataloader(), num_workers=2, auto_fallback=False,
            mp_context="fork"), device="cpu")


def _fit(cls):
    from ray_lightning_tpu_torch import RayStrategy, Trainer
    module = cls(size="nano", batch_size=4, seq_len=16, num_samples=32,
                 vocab_size=128)
    trainer = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=2,
                      seed=3, enable_checkpointing=False,
                      num_sanity_val_steps=0, limit_val_batches=0)
    trainer.fit(module)
    return {k: v.detach().clone()
            for k, v in trainer.train_state.model.state_dict().items()}


def test_a_fit_fed_through_the_ring_equals_the_in_process_fit():
    base = _fit(GPTModule)
    ring = _fit(RingGPT)
    assert base.keys() == ring.keys() and base
    for k in base:
        assert torch.equal(base[k], ring[k]), k
