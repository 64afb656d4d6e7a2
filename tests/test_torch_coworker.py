"""The port's coworker data services, mirroring tests/test_coworker.py:
one coworker feeding a trainer, two coworkers sharing the work, a dead
coworker that does not stall the trainer, an exhausted coworker that
reports end of stream; then a coworker in its own process whose batches
reach the trainer, through the prefetcher, bit for bit and in order.
"""

import multiprocessing
import os
import time

import numpy as np
import torch

from dlrover_tpu_torch.trainer.elastic.coworker import (
    CoworkerDataService,
    CoworkerDataset,
    DataInfoService,
)
from dlrover_tpu_torch.trainer.elastic.prefetch import DevicePrefetcher


def _producer(tag, n=10_000):
    def it():
        for i in range(n):
            yield {"x": np.full((4, 8), i, np.float32), "tag": tag}

    return it


def test_single_coworker_feeds_trainer():
    info = DataInfoService()
    info.start()
    cw = CoworkerDataService(_producer("a"), announce_to=info.addr,
                             announce_every=2, queue_size=4)
    cw.start()
    try:
        batches = list(CoworkerDataset(info.addr, n_batches=6, prefetch=2))
        assert len(batches) == 6
        for b in batches:
            assert b["tag"] == "a" and b["x"].shape == (4, 8)
        # one coworker's stream arrives in its own order
        assert [int(b["x"][0, 0]) for b in batches] == list(range(6))
    finally:
        cw.stop()
        info.stop()


def test_two_coworkers_work_stealing():
    info = DataInfoService()
    info.start()
    cws = [CoworkerDataService(_producer(t), announce_to=info.addr,
                               announce_every=1, queue_size=4)
           for t in ("a", "b")]
    for c in cws:
        c.start()
    try:
        tags = [b["tag"] for b in CoworkerDataset(info.addr, n_batches=12,
                                                  prefetch=2)]
        assert len(tags) == 12 and {"a", "b"} == set(tags)
    finally:
        for c in cws:
            c.stop()
        info.stop()


def test_dead_coworker_does_not_stall():
    info = DataInfoService()
    info.start()
    live = CoworkerDataService(_producer("live"), announce_to=info.addr,
                               announce_every=1, queue_size=4)
    dead = CoworkerDataService(_producer("dead"), announce_to=info.addr,
                               announce_every=1, queue_size=4)
    live.start()
    dead.start()
    time.sleep(0.3)  # let both announce
    dead.stop()      # dies after announcing
    try:
        batches = list(CoworkerDataset(info.addr, n_batches=5, prefetch=1,
                                       fetch_timeout=5.0, max_failures=1))
        assert len(batches) == 5
        assert all(b["tag"] == "live" for b in batches)
    finally:
        live.stop()
        info.stop()


def test_exhausted_iterator_reports_eof():
    info = DataInfoService()
    info.start()

    def finite():
        for _ in range(2):
            yield {"x": np.zeros((2, 2), np.float32), "tag": "finite"}

    live = CoworkerDataService(_producer("live"), announce_to=info.addr,
                               announce_every=1, queue_size=4)
    done = CoworkerDataService(finite, announce_to=info.addr,
                               announce_every=1, queue_size=4)
    live.start()
    done.start()
    try:
        tags = [b["tag"] for b in CoworkerDataset(
            info.addr, n_batches=8, prefetch=1, fetch_timeout=8.0)]
        assert len(tags) == 8
        assert tags.count("finite") <= 2 and tags.count("live") >= 6
    finally:
        live.stop()
        done.stop()
        info.stop()


def _tokens(i):
    return np.random.RandomState(i).randint(0, 1 << 20, size=(2, 17))


def _coworker_proc(info_addr, stop_path):
    def it():
        for i in range(1000):
            yield {"tokens": _tokens(i), "i": i}

    cw = CoworkerDataService(it, announce_to=info_addr, announce_every=1,
                             queue_size=4)
    cw.start()
    deadline = time.monotonic() + 60
    while not os.path.exists(stop_path) and time.monotonic() < deadline:
        time.sleep(0.02)
    cw.stop()


def test_a_coworker_process_feeds_the_prefetcher(tmp_path):
    info = DataInfoService()
    info.start()
    stop = str(tmp_path / "stop")
    proc = multiprocessing.get_context("spawn").Process(
        target=_coworker_proc, args=(info.addr, stop))
    proc.start()
    try:
        feed = DevicePrefetcher(
            CoworkerDataset(info.addr, n_batches=7, fetch_timeout=20.0),
            device="cpu", depth=2)
        got = list(feed)
        assert [b["i"] for b in got] == list(range(7))
        for b in got:
            assert isinstance(b["tokens"], torch.Tensor)
            np.testing.assert_array_equal(b["tokens"].numpy(),
                                          _tokens(b["i"]))
    finally:
        open(stop, "w").close()
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()
        info.stop()
    assert proc.exitcode == 0
