"""The port's shared-memory batch pipeline against the JAX package's: the
same ``_encode`` bytes for the same batch, and a batch written by one
package's ``ShmBatchWriter`` in another process decodes in the other
package's ``ShmDataLoader``, both ways, bit for bit (dtypes, shapes,
the tree and its non-array leaves). Then the port alone, writer and
loader streaming through fewer slots than batches.

The two packages' queue servers answer an empty poll with sentinels of
their own, so across packages the writer has put every batch before the
loader starts reading; the slab and the (slot, nbytes) items are the
same bytes either way.
"""

import importlib
import multiprocessing
import os
import time

import numpy as np
import pytest

N = 6
SLOT_BYTES = 1 << 16


def _batches(n):
    rs = np.random.RandomState(0)
    return [{
        "tokens": rs.randint(0, 1 << 40, size=(4, 9)).astype(np.int64),
        "mask": rs.rand(4, 9) > 0.5,
        "x": {"f16": rs.randn(3).astype(np.float16),
              "f32": rs.randn(2, 2, 2).astype(np.float32),
              "empty": np.zeros((0, 5), np.int32)},
        "pair": (rs.randint(0, 9, size=5).astype(np.int32), "tag"),
        "list": [np.float64(i) * np.ones(()), 7],
        "step": i,
    } for i in range(n)]


def _assert_same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    else:
        assert got == want


def _set_socket_dirs(sock_dir):
    os.environ["DLROVER_TPU_SOCKET_DIR"] = sock_dir
    os.environ["DLROVER_TPU_TORCH_SOCKET_DIR"] = sock_dir


def _wait_for(path, seconds=60.0):
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.01)


def _writer(pkg, name, sock_dir, n, slots, ready, release):
    """A writer process: put ``n`` batches and the end, then hold the
    queues up until the test releases it."""
    _set_socket_dirs(sock_dir)
    mod = importlib.import_module(f"{pkg}.trainer.elastic.shm_loader")
    writer = mod.ShmBatchWriter(name, slots=slots, slot_bytes=SLOT_BYTES)
    try:
        for batch in _batches(n):
            writer.put(batch, timeout=60)
        writer.end()
        open(ready, "w").close()
        _wait_for(release)
    finally:
        writer.close(unlink=True)


def test_encode_is_the_jax_package_bytes():
    from dlrover_tpu.trainer.elastic import shm_loader as jax_shm
    from dlrover_tpu_torch.trainer.elastic import shm_loader as port_shm

    for batch in _batches(N):
        data = port_shm._encode(batch)
        assert data == jax_shm._encode(batch)
        _assert_same(port_shm._decode(memoryview(data)), batch)
        _assert_same(jax_shm._decode(memoryview(data)), batch)


@pytest.mark.parametrize("writer_pkg,loader_pkg", [
    ("dlrover_tpu", "dlrover_tpu_torch"),
    ("dlrover_tpu_torch", "dlrover_tpu"),
])
def test_a_batch_crosses_packages_and_processes(tmp_path, monkeypatch,
                                                writer_pkg, loader_pkg):
    sock_dir = str(tmp_path / "s")
    for env in ("DLROVER_TPU_SOCKET_DIR", "DLROVER_TPU_TORCH_SOCKET_DIR"):
        monkeypatch.setenv(env, sock_dir)
    name = f"x{os.getpid()}{writer_pkg[-5:]}"
    ready, release = str(tmp_path / "ready"), str(tmp_path / "release")
    ctx = multiprocessing.get_context("spawn")
    proc = ctx.Process(target=_writer, args=(
        writer_pkg, name, sock_dir, N, N + 1, ready, release))
    proc.start()
    try:
        deadline = time.monotonic() + 90
        while not os.path.exists(ready):
            assert proc.is_alive(), f"writer exited {proc.exitcode}"
            assert time.monotonic() < deadline, "the writer never finished"
            time.sleep(0.02)
        mod = importlib.import_module(f"{loader_pkg}.trainer.elastic."
                                      "shm_loader")
        loader = mod.ShmDataLoader(name, slots=N + 1, slot_bytes=SLOT_BYTES)
        got = list(loader)
        loader.close()
        assert len(got) == N
        for g, w in zip(got, _batches(N)):
            _assert_same(g, w)
    finally:
        open(release, "w").close()
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()
    assert proc.exitcode == 0


def test_the_port_streams_through_fewer_slots(tmp_path, monkeypatch):
    """Writer and loader run together through 2 slots: the free queue
    holds the writer back until the loader recycles a slot."""
    from dlrover_tpu_torch.trainer.elastic import ShmDataLoader

    sock_dir = str(tmp_path / "s")
    monkeypatch.setenv("DLROVER_TPU_TORCH_SOCKET_DIR", sock_dir)
    name = f"p{os.getpid()}"
    ready, release = str(tmp_path / "ready"), str(tmp_path / "release")
    n = 3 * N
    ctx = multiprocessing.get_context("spawn")
    proc = ctx.Process(target=_writer, args=(
        "dlrover_tpu_torch", name, sock_dir, n, 2, ready, release))
    proc.start()
    try:
        sock = os.path.join(sock_dir, f"queue_batchfill_{name}.sock")
        deadline = time.monotonic() + 90
        while not os.path.exists(sock):
            assert proc.is_alive(), f"writer exited {proc.exitcode}"
            assert time.monotonic() < deadline, "the writer never started"
            time.sleep(0.02)
        loader = ShmDataLoader(name, slots=2, slot_bytes=SLOT_BYTES)
        got = list(loader)
        loader.close()
        assert len(got) == n
        for g, w in zip(got, _batches(n)):
            _assert_same(g, w)
        assert os.path.exists(ready)
    finally:
        open(release, "w").close()
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()
    assert proc.exitcode == 0


def test_an_oversized_batch_is_refused(tmp_path, monkeypatch):
    from dlrover_tpu_torch.trainer.elastic import ShmBatchWriter

    monkeypatch.setenv("DLROVER_TPU_TORCH_SOCKET_DIR", str(tmp_path / "s"))
    writer = ShmBatchWriter(f"o{os.getpid()}", slots=1, slot_bytes=1024)
    try:
        with pytest.raises(ValueError, match="slot_bytes"):
            writer.put({"x": np.zeros(4096, np.uint8)})
    finally:
        writer.close(unlink=True)
