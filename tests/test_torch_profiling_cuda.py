"""The profiling plane's windows on the card: a Kineto window with CUDA
activity over K1-K4 holds a CUDA event named for each kernel, the
summarizer reads them as device time (K1, K3 and K4 as matmul, K2 as
fusion), and a sampler window through the real backend publishes its
categories. These need an NVIDIA GPU: without CUDA they skip with a
reason. Run them on the GPU with

    python -m pytest --noconftest -m cuda tests/test_torch_profiling_cuda.py
"""

import re

import pytest
import torch

from dlrover_tpu_torch.common import profiling, trace_summary
from dlrover_tpu_torch.device import CUDA_SKIP_REASON, cuda_available

pytestmark = pytest.mark.cuda

KERNELS = {"flash_fwd": "matmul", "flash_bwd_preprocess": "fusion",
           "flash_bwd_dq": "matmul", "flash_bwd_dkv": "matmul"}


def attention_step():
    from dlrover_tpu_torch.ops import attention as att

    B, H, S, D = 1, 2, 256, 128
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v, do = (torch.randn(B, H, S, D, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))
    scale = D ** -0.5

    def step():
        o, lse = att.flash_fwd(q, k, v, None, None, True, scale)
        delta = att.flash_bwd_preprocess(do, o)
        args = (q, k, v, do, lse, delta, None, None, True, scale)
        att.flash_bwd_dq(*args)
        att.flash_bwd_dkv(*args)

    return step


@pytest.fixture(scope="module")
def step():
    if not cuda_available():
        pytest.skip(CUDA_SKIP_REASON)
    assert trace_summary.toolchain_available()
    fn = attention_step()
    fn()
    torch.cuda.synchronize()
    return fn


def test_cuda_window_records_the_flash_kernels(tmp_path, step):
    backend = profiling.TorchProfilerBackend("cuda")
    assert backend.start(str(tmp_path))
    step()
    backend.stop()
    assert trace_summary.window_info(str(tmp_path))["activities"] == [
        "cpu", "cuda"]
    s = trace_summary.summarize(str(tmp_path))
    assert s["device_events"] >= 4
    for name, cat in KERNELS.items():
        rows = [o for o in s["top_ops"]
                if re.search(rf"\b{name}_kernel\b", o["op"])]
        assert len(rows) == 1 and rows[0]["occurrences"] == 1, name
        assert rows[0]["category"] == cat and rows[0]["ms_per_step"] > 0
    events, base = profiling.device_trace(str(tmp_path))
    assert events and base is not None


def test_sampler_window_on_the_card(tmp_path, step):
    import time

    s = profiling.DeviceTimeSampler(
        str(tmp_path / "prof"), sample_steps=2,
        baseline=profiling.OpCostBaseline(str(tmp_path / "b.json")),
        capture_channel=None, overhead_pct=0.0, device="cuda")
    s.set_context("fp", "devices=1")
    assert s.sampling_enabled
    for i in range(1, 5):
        s.on_step_start(i)
        step()
        s.on_step_end(i, 0.001)
    deadline = time.time() + 30
    while time.time() < deadline and not s.baseline.get(s.baseline_key):
        time.sleep(0.05)
    s.close()
    base = s.baseline.get(s.baseline_key)
    assert base and base["matmul"] > 0 and base["fusion"] > 0
    assert [w["step"] for w in s.window_costs] == [2, 4]
    assert {"sync_s", "stop_s", "export_s"} <= set(s.window_costs[1])
