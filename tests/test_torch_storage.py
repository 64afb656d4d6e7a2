"""Concurrent writers of one path through the port's PosixDiskStorage.

Each rank's checkpoint saver writes the tracker file
(``latest_checkpointed_iteration.txt``) of one checkpoint directory, so
several processes, and threads within them, may write the same path at
once. Every write must succeed, the file must end as one writer's whole
payload, and no temp file may be left beside it.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from dlrover_tpu_torch.common.storage import PosixDiskStorage

ROOT = Path(__file__).resolve().parents[1]
THREADS = 8
PROCESSES = 2
WRITES = 50
PAYLOAD_LINES = 2000  # ~40 KB a write: a torn file would show

# run in each writer process: THREADS threads, WRITES writes each
_WRITER = """
import sys, threading
from dlrover_tpu_torch.common.storage import PosixDiskStorage
sys.path.insert(0, {tests!r})
from test_torch_storage import hammer
errors = hammer(PosixDiskStorage(), {path!r}, {tag!r}, {parts!r})
sys.exit(1 if errors else 0)
"""


def payload(tag: str, writer: int, i: int) -> str:
    line = f"{tag}:{writer}:{i}\n"
    return line * PAYLOAD_LINES


def whole(text: str) -> bool:
    """Whether ``text`` is one writer's payload, complete."""
    lines = text.split("\n")
    return (len(lines) == PAYLOAD_LINES + 1 and lines[-1] == ""
            and len(set(lines[:-1])) == 1)


def hammer(storage, path: str, tag: str, parts: bool) -> list:
    """THREADS threads write ``path`` WRITES times each (through
    ``write_parts`` when ``parts``); returns the errors raised."""
    errors = []
    start = threading.Barrier(THREADS)

    def writer(n):
        start.wait()
        for i in range(WRITES):
            text = payload(tag, n, i)
            try:
                if parts:
                    data = text.encode()
                    half = len(data) // 2
                    storage.write_parts([data[:half], data[half:]], path)
                else:
                    storage.write(text, path)
            except Exception as e:  # noqa: BLE001 - collected and asserted
                errors.append(repr(e))

    threads = [threading.Thread(target=writer, args=(n,))
               for n in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return errors


@pytest.mark.parametrize("parts", [False, True], ids=["write", "write_parts"])
def test_threads_and_processes_write_one_path(tmp_path, parts):
    """8 threads in each of 2 processes and 8 in this one write the
    tracker path 50 times each at once."""
    path = str(tmp_path / "ckpt" / "latest_checkpointed_iteration.txt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WRITER.format(
            tests=str(ROOT / "tests"), path=path, tag=f"proc{p}",
            parts=parts)], env=env)
        for p in range(PROCESSES)]
    errors = hammer(PosixDiskStorage(), path, "main", parts)
    codes = [p.wait(timeout=120) for p in procs]
    assert errors == []
    assert codes == [0] * PROCESSES
    assert whole(Path(path).read_text())
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "latest_checkpointed_iteration.txt"]
