"""The prefetcher's side-stream copies on the card against synchronous
copies of the same batches, bit for bit, while the consumer's stream is
kept busy so that copies run ahead of it and the pinned staging buffers
are refilled under it. These need an NVIDIA GPU: without CUDA they skip
with a reason. Run them on the GPU with

    python -m pytest --noconftest -m cuda tests/test_torch_prefetch_cuda.py
"""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.device import CUDA_SKIP_REASON, cuda_available
from dlrover_tpu_torch.trainer.elastic.prefetch import DevicePrefetcher

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not cuda_available():
        pytest.skip(CUDA_SKIP_REASON)


def _batches(n, rows=8, seq=2049):
    rs = np.random.RandomState(0)
    return [{"tokens": rs.randint(0, 32000, size=(rows, seq)),
             "labels": rs.rand(rows).astype(np.float32), "step": i}
            for i in range(n)]


def _busy(ms: float = 5.0):
    """Keep the current stream busy for about ``ms`` (a chain of GEMMs)."""
    a = torch.randn(2048, 2048, device="cuda")
    for _ in range(max(1, int(ms))):
        a = a @ a
        a = a / a.norm()
    return a


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_side_stream_copies_equal_synchronous_ones(depth):
    batches = _batches(12)
    sync = [{k: (torch.as_tensor(v).cuda() if isinstance(v, np.ndarray)
                 else v) for k, v in b.items()} for b in batches]
    torch.cuda.synchronize()
    feed = DevicePrefetcher(batches, device="cuda", depth=depth)
    seen = 0
    for got, want in zip(feed, sync):
        _busy()
        # reading on the consumer's stream after the wait on the copy
        assert torch.equal(got["tokens"], want["tokens"])
        assert torch.equal(got["labels"], want["labels"])
        assert got["step"] == want["step"]
        assert got["tokens"].device.type == "cuda"
        seen += 1
    assert seen == len(batches)
    times = feed.copy_ms()
    assert len(times) == len(batches) and all(t >= 0 for t in times)


def test_copies_are_not_overwritten_by_the_next_batches():
    """Hold every batch the prefetcher handed out while later ones are
    staged and copied through the same pinned buffers: none changes."""
    batches = _batches(10, rows=64)
    feed = DevicePrefetcher(batches, device="cuda", depth=2)
    held = []
    for got in feed:
        held.append(got)
        _busy(2)
    torch.cuda.synchronize()
    for got, want in zip(held, batches):
        assert torch.equal(got["tokens"].cpu(),
                           torch.from_numpy(want["tokens"]))
