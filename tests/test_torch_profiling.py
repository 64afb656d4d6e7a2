"""The port's deep-profiling plane held against the JAX package's on the
CPU: the category rules (xprof's category strings give JAX's buckets;
CUDA, cuBLAS, cuDNN and NCCL kernel names and the port's own kernels give
the buckets ``common/trace_summary.py`` documents), the op-cost baseline
(the same update and diff sequences from the same seeded samples, and
each package reading the other's file), the capture channel (a request
and an ack written by either package read by the other), the device-time
sampler (the same windows, governor gaps, gauges, regressions and
capture summaries for the same step and cost sequence through the JAX
tests' ``FakeBackend`` seam and one fake clock), ``merge_perfetto`` on
the same spans and device events, the summarizer on a Chrome trace of
real CUDA kernel names, real ``torch.profiler`` windows on the CPU
(``profile=True`` in the port's Trainer, the one-profiler slot, the cold
first start), the agent's capture relay, and the acceptance scenario of
``tests/test_profiling.py``: an injected step-time regression in the
port's Trainer becomes an SLO breach on the port's master, a capture
directive, a capture executed by the worker through a real
``torch.profiler`` CPU window, a ``done`` record on ``/captures.json``
whose attribution names the inflated category, and a merged timeline.
Every new module of the slice imports neither jax nor the JAX package,
and the brain imports no torch (a subprocess each)."""

import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

from dlrover_tpu.common import profiling as jax_prof
from dlrover_tpu.common import telemetry as jax_tele
from dlrover_tpu.common import trace_summary as jax_ts
from dlrover_tpu_torch.common import profiling as port_prof
from dlrover_tpu_torch.common import telemetry as port_tele
from dlrover_tpu_torch.common import trace_summary as port_ts

pytestmark = pytest.mark.profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jax_prof, jax_tele), "port": (port_prof, port_tele)}


@pytest.fixture
def fresh_telemetry(monkeypatch):
    """A fresh worker registry in each package; neither writes files."""
    saved = (jax_tele._REGISTRY, port_tele._REGISTRY)
    for tele in (jax_tele, port_tele):
        monkeypatch.setenv(tele.ENV_ROLE, "worker")
        monkeypatch.delenv(tele.ENV_DIR, raising=False)
    regs = {"jax": jax_tele.enable(), "port": port_tele.enable()}
    yield regs
    jax_tele._REGISTRY, port_tele._REGISTRY = saved


def wait_until(cond, timeout=10.0, poll=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(poll)
    return cond()


# -------------------------------------------------------------------------
# category rules
# -------------------------------------------------------------------------

# xprof hlo_stats category strings (and the JAX tests' own cases)
XPROF_NAMES = [
    "%dot", "convolution fusion", "all-gather fusion", "collective permute",
    "collective-permute-done", "collective-permute-start", "reduce-scatter",
    "all-to-all", "infeed", "outfeed", "host compute", "loop fusion",
    "output fusion", "input fusion", "kLoop fusion", "mystery-op", "",
    "convolution", "data formatting", "non-fusion elementwise", "custom-call",
    "all-reduce", "all-reduce fusion", "all-reduce-start", "cross-replica-sum",
    "copy-start", "copy-done", "copy", "transpose", "reshape", "reduce",
    "reduce-window", "dynamic-update-slice", "send", "recv", "while",
    "conditional", "rng-bit-generator", "sort", "gather", "scatter",
    "host callback", "idle", "stall", "einsum", "matmul", "gemm fusion",
    "cublas-gemm", "all gather", "reduce scatter", "all to all",
] + list(jax_ts.CANONICAL_CATEGORIES)

# CUDA kernel names as Kineto records them on the H100, and the bucket
# trace_summary's docstring gives each
CUDA_NAMES = {
    "void fa::flash_fwd_kernel<128>(fa::sm90::FwdParams)": "matmul",
    "void fa::flash_fwd_kernel<64>(fa::sm90::FwdParams)": "matmul",
    "void fa::flash_bwd_dq_kernel<128>(fa::sm90::bwd::BwdParams)": "matmul",
    "void fa::flash_bwd_dkv_kernel<128>(fa::sm90::bwd::BwdParams)": "matmul",
    "fa::flash_fwd_heads_kernel(fa::sm90::FwdParams)": "matmul",
    "fa::flash_bwd_dq_heads_kernel(fa::sm90::bwd::BwdParams)": "matmul",
    "fa::flash_bwd_dkv_heads_kernel(fa::sm90::bwd::BwdParams)": "matmul",
    "fa::flash_ring_fwd_kernel(fa::sm90::FwdParams)": "matmul",
    "fa::flash_ring_dq_kernel(fa::sm90::bwd::BwdParams)": "matmul",
    "fa::flash_ring_dkv_kernel(fa::sm90::bwd::BwdParams)": "matmul",
    "void fa::flash_bwd_preprocess_kernel<128>(fa::PreParams)": "fusion",
    "void fa::flash_fwd_rope_k_kernel<128>(fa::RopeParams)": "fusion",
    "void quantize_int8_kernel(QuantParams)": "fusion",
    "void dequantize_int8_kernel(QuantParams)": "fusion",
    "void fused_adamw32_kernel(AdamParams)": "fusion",
    "void fused_adamw8_kernel(AdamParams)": "fusion",
    "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT": "matmul",
    "nvjet_tst_128x64_64x8_1x2_h_bz_NTT": "matmul",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroup"
    "size1x1x1_execute_segment_k_off_kernel__5x_cublas": "matmul",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16>"
    "(cublasLt::cublasSplitKParams<float>)": "matmul",
    "void gemv2T_kernel_val<int, int, float, float, float, 128, 16, 4, 4>":
        "matmul",
    "ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_stages_64x3_tn": "matmul",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc":
        "convolution",
    "sm80_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32": "convolution",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096>)":
        "all-reduce",
    "ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL(ncclDevKernelArgs)":
        "reduce-scatter",
    "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096>)":
        "all-gather",
    "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096>)":
        "collective-permute",
    "ncclKernel_AllReduce_RING_LL_Sum_float(ncclWorkElem)": "all-reduce",
    "ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096>)":
        "other",
    "ncclDevKernel_Reduce_Sum_f32_RING_LL(ncclDevKernelArgs)": "other",
    "Memcpy DtoD (Device -> Device)": "copy",
    "Memcpy HtoD (Pageable -> Device)": "copy",
    "Memcpy DtoH (Device -> Pinned)": "copy",
    "Memset (Device)": "copy",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "FillFunctor<float>, at::detail::Array<char*, 1> >": "fusion",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
    "float, float>::operator()>, unsigned int, float, 4> >": "fusion",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
    "at::native::(anonymous namespace)::TensorListMetadata<4>>": "fusion",
    "void at::native::unrolled_elementwise_kernel<at::native::"
    "direct_copy_kernel_cuda(at::TensorIteratorBase&)>": "copy",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>":
        "copy",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "bfloat16_convert_kernel>": "fusion",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4>": "other",
}


def test_xprof_category_strings_give_the_jax_buckets():
    for name in XPROF_NAMES:
        assert port_ts.canonical_category(name) == \
            jax_ts.canonical_category(name), name
    assert port_ts.CANONICAL_CATEGORIES == jax_ts.CANONICAL_CATEGORIES
    for cat in port_ts.CANONICAL_CATEGORIES:
        assert port_ts.canonical_category(cat) == cat


@pytest.mark.parametrize("name", sorted(CUDA_NAMES))
def test_cuda_kernel_names_give_the_documented_buckets(name):
    assert port_ts.canonical_category(name) == CUDA_NAMES[name]


def test_canonical_breakdown_matches_jax():
    rs = np.random.RandomState(3)
    raw = {name: float(rs.uniform(0.01, 9.0)) for name in XPROF_NAMES[:30]}
    want = jax_ts.canonical_breakdown(raw)
    got = port_ts.canonical_breakdown(raw)
    assert set(got) == set(want)
    for cat in want:
        assert got[cat] == pytest.approx(want[cat], rel=1e-9, abs=1e-9)


# -------------------------------------------------------------------------
# the summarizer on a Chrome trace of real kernel names
# -------------------------------------------------------------------------


def _write_trace(directory, events, activities=("cpu", "cuda"),
                 base_ns=1_790_857_026_000_000_000):
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "h_1" + port_ts.TRACE_SUFFIX),
              "w") as f:
        json.dump({"schemaVersion": 1, "baseTimeNanoseconds": base_ns,
                   "traceEvents": events}, f)
    with open(os.path.join(directory, port_ts.WINDOW_FILE), "w") as f:
        json.dump({"activities": list(activities)}, f)


def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"stream": 7}}


FLASH = ("void fa::flash_fwd_kernel<128>(fa::sm90::FwdParams)",
         "void fa::flash_bwd_dq_kernel<128>(fa::sm90::bwd::BwdParams)",
         "void fa::flash_bwd_dkv_kernel<128>(fa::sm90::bwd::BwdParams)",
         "void fa::flash_bwd_preprocess_kernel<128>(fa::PreParams)")


def _step_events():
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
           "tid": 1, "ts": 10.0, "dur": 500.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "pid": 1, "tid": 1, "ts": 11.0, "dur": 4.0},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "step",
           "pid": 0, "tid": 7, "ts": 10.0, "dur": 900.0}]
    t = 100.0
    for _layer in range(2):
        for name, dur in zip(FLASH, (180.0, 250.0, 340.0, 30.0)):
            ev.append(_kernel(name, t, dur))
            t += dur + 1
        ev.append(_kernel("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", t,
                          120.0))
        t += 121
    ev.append(_kernel("Memcpy DtoD (Device -> Device)", t, 12.0,
                      cat="gpu_memcpy"))
    ev.append(_kernel("Memset (Device)", t + 20, 2.0, cat="gpu_memset"))
    return ev


def test_summary_counts_device_events_only(tmp_path):
    _write_trace(str(tmp_path), _step_events())
    s = port_ts.summarize(str(tmp_path), steps=2)
    assert s["activities"] == ["cpu", "cuda"] and s["device_events"] == 12
    assert s["by_category"] == pytest.approx(
        {"matmul": (2 * (180 + 250 + 340) + 240) / 2e3,
         "fusion": 60 / 2e3, "copy": 14 / 2e3})
    assert s["by_canonical_category"] == s["by_category"]
    top = {o["op"]: o for o in s["top_ops"]}
    for name in FLASH:
        assert top[name]["occurrences"] == 2
    assert "aten::mm" not in top and "step" not in top
    ops = port_ts.top_ops(str(tmp_path), k=3)
    assert [o["op"] for o in ops] == [FLASH[2], FLASH[1], FLASH[0]]
    assert ops[0]["self_ms_per_step"] == 0.68
    assert "=== by category ===" in port_ts.render(s)


def test_cpu_only_window_reports_no_device_time(tmp_path):
    _write_trace(str(tmp_path), _step_events()[:2], activities=("cpu",))
    s = port_ts.summarize(str(tmp_path))
    assert s["device_events"] == 0 and s["by_category"] == {}
    assert "CPU activity only" in port_ts.render(s)
    assert port_ts.summarize(str(tmp_path / "none")) is None
    assert port_ts.top_ops(str(tmp_path / "none")) == []


def test_a_cuda_window_without_cuda_events_is_a_failure(tmp_path,
                                                       fresh_telemetry):
    """On a card a window that holds no CUDA event is a parse failure of
    the sampler and of StepProfiler's gates, never a CPU-only summary."""
    from dlrover_tpu_torch.trainer.profiler import StepProfiler

    _write_trace(str(tmp_path / "w"), _step_events()[:2])
    s = port_prof.DeviceTimeSampler(
        str(tmp_path / "prof"), sample_steps=1, parse_fn=None,
        baseline=port_prof.OpCostBaseline(str(tmp_path / "b.json")),
        capture_channel=None, backend=FakeBackend())
    with pytest.raises(RuntimeError, match="no CUDA event"):
        s._parse(str(tmp_path / "w"), 1)
    prof = StepProfiler(str(tmp_path / "w"))
    with pytest.raises(AssertionError, match="no CUDA event"):
        prof.assert_ops_present(("flash_fwd",))
    _write_trace(str(tmp_path / "w"), _step_events())
    assert prof.assert_ops_present(("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv",
                                    "flash_bwd_preprocess")) == 7
    with pytest.raises(AssertionError, match="missing"):
        prof.assert_ops_present(("flash_ring",))
    with pytest.raises(AssertionError, match="forbidden"):
        prof.assert_ops_absent(("nvjet",))


def test_publish_kernel_stats_feeds_the_agents_metrics(tmp_path,
                                                      monkeypatch):
    """The agent's /metrics exposition serves the published top kernels
    as ``dlrtpu_kernel_self_ms``."""
    from dlrover_tpu_torch.agent.monitor import MetricsEndpoint
    from dlrover_tpu_torch.common.constants import ConfigPath
    from dlrover_tpu_torch.trainer.profiler import publish_kernel_stats

    _write_trace(str(tmp_path / "w"), _step_events())
    out = tmp_path / "kernels.json"
    monkeypatch.setenv(ConfigPath.ENV_KERNEL_METRICS, str(out))
    ops = publish_kernel_stats(str(tmp_path / "w"), steps=2)
    assert json.loads(out.read_text()) == {"top_ops": ops}
    text = MetricsEndpoint().render()
    assert "dlrtpu_kernel_self_ms" in text
    assert "flash_bwd_dkv_kernel" in text


# -------------------------------------------------------------------------
# op-cost baseline
# -------------------------------------------------------------------------


def _samples(seed, n=40):
    rs = np.random.RandomState(seed)
    cats = list(jax_ts.CANONICAL_CATEGORIES)
    out = []
    for i in range(n):
        picked = rs.choice(cats, size=rs.randint(1, 6), replace=False)
        sample = {str(c): float(rs.choice([rs.uniform(0.0, 0.08),
                                           rs.uniform(0.5, 4.0)]))
                  for c in picked}
        if i % 7 == 6:  # a regression: one category far above its past
            sample[str(picked[0])] = float(rs.uniform(20.0, 40.0))
        out.append(sample)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_baseline_update_and_diff_sequences_match_jax(tmp_path, seed):
    bases = {name: m.OpCostBaseline(str(tmp_path / f"{name}.json"))
             for name, (m, _t) in PACKAGES.items()}
    keys = [m.OpCostBaseline.key("fp", f"data={k}")
            for m, _t in PACKAGES.values() for k in (1, 2)]
    assert keys[:2] == keys[2:]
    for i, sample in enumerate(_samples(seed)):
        key = keys[i % 2]
        got = {name: (b.update(key, sample), b.diff(key, sample),
                      b.get(key)) for name, b in bases.items()}
        (jb, jr), jd, jg = got["jax"]
        (pb, pr), pd, pg = got["port"]
        assert pr == jr and pd == jd
        assert pb == pytest.approx(jb, rel=1e-9) and pg == pytest.approx(
            jg, rel=1e-9)
    # each package reads the other's file
    for name, (m, _t) in PACKAGES.items():
        other = "port" if name == "jax" else "jax"
        read = m.OpCostBaseline(str(tmp_path / f"{other}.json"))
        for key in keys[:2]:
            assert read.get(key) == bases[other].get(key)


def test_fingerprint_and_mesh_key_match_jax():
    import jax.numpy as jnp

    from dlrover_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from dlrover_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from dlrover_tpu_torch.parallel.mesh import build_mesh

    shapes = {"embed": (64, 32), "layers": {"0": {"wq": (32, 32),
                                                  "norm": (32,)}}}

    def tree(make, spec):
        if isinstance(spec, dict):
            return {k: tree(make, v) for k, v in spec.items()}
        return make(spec)

    jax_tree = tree(lambda s: jnp.zeros(s, jnp.float32), shapes)
    port_tree = tree(lambda s: torch.zeros(s, dtype=torch.float32), shapes)
    assert port_prof.model_fingerprint(port_tree) == \
        jax_prof.model_fingerprint(jax_tree)
    flat = {"w": torch.zeros(2, 3), "b": torch.zeros(3, dtype=torch.bfloat16)}
    assert port_prof.model_fingerprint(flat) == jax_prof.model_fingerprint(
        {"w": jnp.zeros((2, 3)), "b": jnp.zeros(3, jnp.bfloat16)})
    assert port_prof.model_fingerprint(flat) != port_prof.model_fingerprint(
        {"w": torch.zeros(2, 4), "b": torch.zeros(3, dtype=torch.bfloat16)})
    import jax

    jax_mesh = jax_build_mesh(JaxMeshConfig(data=1, fsdp=1),
                              devices=jax.devices()[:1])
    assert port_prof.mesh_shape_key(build_mesh()) == \
        jax_prof.mesh_shape_key(jax_mesh)
    named = types.SimpleNamespace(mesh_dim_names=("data", "fsdp"),
                                  shape=(2, 4))
    assert port_prof.mesh_shape_key(named) == "data=2,fsdp=4"
    assert port_prof.mesh_shape_key(object()) == "devices=?"


# -------------------------------------------------------------------------
# capture channel
# -------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_capture_channel_files_cross_read(tmp_path, writer, reader):
    w = PACKAGES[writer][0].CaptureChannel(str(tmp_path / "c"))
    r = PACKAGES[reader][0].CaptureChannel(str(tmp_path / "c"))
    assert not r.worker_ready()
    w.mark_ready()
    assert r.worker_ready()
    w.signal(PACKAGES[writer][0].CaptureRequest(
        capture_id="cap-3", steps=3, reason="slo:step_time"))
    req = r.poll("")
    assert (req.capture_id, req.steps, req.reason) == (
        "cap-3", 3, "slo:step_time")
    assert r.poll("cap-3") is None
    r.ack("cap-3", True, artifact="/a", summary={"x": 1})
    ack = w.read_ack("cap-3")
    assert ack["ok"] and ack["artifact"] == "/a" and ack["summary"] == {
        "x": 1}
    assert w.await_ack("cap-3", 1.0) is not None
    r.clear()
    assert not w.worker_ready() and w.poll("") is None


def test_execute_capture_matches_jax(tmp_path, fresh_telemetry):
    """The agent half, both packages' ``execute_capture`` against the
    same worker behaviours: no watcher, an ack, a dead worker."""
    results = {}
    for name, (m, _t) in PACKAGES.items():
        reports = []

        def report(*args):
            reports.append(args)

        ch = m.CaptureChannel(str(tmp_path / name / "none"))
        out = [m.execute_capture({"capture_id": "c0"}, ch, report),
               m.execute_capture({}, ch, report)]
        ch = m.CaptureChannel(str(tmp_path / name / "acked"))
        ch.mark_ready()

        def worker(ch=ch):
            assert wait_until(lambda: ch.poll("") is not None, 5.0)
            ch.ack("c1", True, artifact="/art", summary={"s": 1})

        thread = threading.Thread(target=worker)
        thread.start()
        out.append(m.execute_capture({"capture_id": "c1", "steps": 3},
                                     ch, report, timeout=10.0))
        thread.join()
        ch = m.CaptureChannel(str(tmp_path / name / "dead"))
        ch.mark_ready()
        out.append(m.execute_capture({"capture_id": "c2"}, ch, report,
                                     timeout=5.0, alive_fn=lambda: False))
        results[name] = (out, reports)
    assert results["port"] == results["jax"]
    assert results["port"][0] == [False, False, True, False]


# -------------------------------------------------------------------------
# the device-time sampler through the FakeBackend seam
# -------------------------------------------------------------------------


class FakeBackend:
    """tests/test_profiling.py's profiler-backend seam: records windows,
    captures nothing; ``clock`` (a FakeClock) advances by ``costs`` at
    each start."""

    def __init__(self, fail_start=False, clock=None, costs=()):
        self.active = None
        self.windows = []
        self.fail_start = fail_start
        self.clock, self.costs = clock, list(costs)

    def start(self, log_dir):
        if self.fail_start:
            return False
        if self.clock is not None and self.costs:
            self.clock.now += self.costs.pop(0)
        os.makedirs(log_dir, exist_ok=True)
        self.active = log_dir
        return True

    def stop(self, block_on=None):
        self.windows.append(self.active)
        self.active = None


class FakeClock:
    """``time`` for a profiling module: perf_counter and monotonic read
    ``now``; the rest is the real module."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def make_sampler(m, tmp_path, parse_fn, sample_steps=4, channel=None,
                 backend=None, overhead_pct=0.0):
    s = m.DeviceTimeSampler(
        str(tmp_path / "prof"), sample_steps=sample_steps,
        parse_fn=parse_fn,
        baseline=m.OpCostBaseline(str(tmp_path / "b.json")),
        capture_channel=channel, backend=backend or FakeBackend(),
        artifact_root=str(tmp_path / "captures"),
        overhead_pct=overhead_pct)
    s.set_context("fp0", "data=1,fsdp=1")
    return s


def _gauges(snap):
    return {(g["name"], tuple(sorted(g["labels"].items()))): g["value"]
            for g in snap["gauges"]}


@pytest.mark.parametrize("seed", [0, 1])
def test_sampler_windows_governor_and_gauges_match_jax(
        tmp_path, fresh_telemetry, monkeypatch, seed):
    """The same step times, window costs and parsed samples through each
    package's sampler: the same sampled steps, gaps, next-sample steps,
    gauges and regression events."""
    rs = np.random.RandomState(seed)
    steps = 160
    durs = [float(d) for d in rs.uniform(0.05, 0.2, steps)]
    costs = [float(c) for c in rs.uniform(0.001, 0.05, steps)]
    samples = _samples(seed + 10, steps)
    out = {}
    for name, (m, tele) in PACKAGES.items():
        clock = FakeClock()
        monkeypatch.setattr(m, "time", clock)
        backend = FakeBackend(clock=clock, costs=costs)
        seen = []

        def parse(d, n, seen=seen):
            seen.append(samples[len(seen)])
            return dict(seen[-1])

        s = make_sampler(m, tmp_path / name, parse, sample_steps=3,
                         backend=backend, overhead_pct=2.0)
        gaps = []
        for step in range(1, steps + 1):
            s.on_step_start(step)
            clock.now += durs[step - 1]
            s.on_step_end(step, durs[step - 1])
            gaps.append((s._next_sample, s.last_gap))
            # the parse thread takes each window before the next opens
            assert wait_until(lambda: s._queue.empty(), 5.0)
            time.sleep(0.002)
        s.close()
        monkeypatch.undo()
        snap = tele.snapshot()
        out[name] = {
            "windows": len(backend.windows), "gaps": gaps,
            "cost": s.last_window_cost_s, "ewma": s.step_ewma_s,
            "gauges": _gauges(snap),
            "regressions": [(e["step"], e["category"], e["delta_pct"])
                            for e in snap["events"]
                            if e["kind"] == "device.optime.regression"],
            "baseline": s.baseline.get(s.baseline_key),
        }
    jax_out, port_out = out["jax"], out["port"]
    assert port_out["windows"] == jax_out["windows"] > 3
    assert port_out["gaps"] == jax_out["gaps"]
    assert port_out["regressions"] == jax_out["regressions"]
    assert port_out["cost"] == pytest.approx(jax_out["cost"], rel=1e-9)
    assert port_out["ewma"] == pytest.approx(jax_out["ewma"], rel=1e-9)
    assert port_out["baseline"] == pytest.approx(jax_out["baseline"],
                                                 rel=1e-9)
    assert set(port_out["gauges"]) == set(jax_out["gauges"])
    for key, val in jax_out["gauges"].items():
        assert port_out["gauges"][key] == pytest.approx(val, rel=1e-9), key


@pytest.mark.parametrize("case", ["cadence", "disabled", "start_fails",
                                  "two_failures"])
def test_sampler_modes_match_jax(tmp_path, fresh_telemetry, case):
    out = {}
    for name, (m, _t) in PACKAGES.items():
        backend = FakeBackend(fail_start=case == "start_fails")
        calls = {"n": 0}

        def parse(d, n, calls=calls):
            calls["n"] += 1
            if case == "two_failures":
                raise ValueError("boom")
            return {"matmul": 1.0}

        s = make_sampler(m, tmp_path / name, parse,
                         sample_steps=0 if case == "disabled" else 3,
                         backend=backend)
        for step in range(1, 13):
            s.on_step_start(step)
            s.on_step_end(step, 0.001)
            assert wait_until(lambda: s._queue.empty(), 5.0)
            time.sleep(0.002)
        s.close()
        out[name] = (len(backend.windows), s._next_sample, calls["n"],
                     s.sampling_enabled)
    assert out["port"] == out["jax"]


def test_deep_capture_summary_matches_jax(tmp_path, fresh_telemetry):
    """The same capture request through each package's sampler: the
    same acked summary (but its source) and the same artifact files; the
    timelines' device slices are equal."""
    acks, timelines = {}, {}
    for name, (m, tele) in PACKAGES.items():
        tele.event("span", name="train.step", dur=0.01, trace="t",
                   span="s", parent="")
        ch = m.CaptureChannel(str(tmp_path / name / "chan"))
        s = make_sampler(m, tmp_path / name,
                         lambda d, n: {"collective-permute": 30.0,
                                       "%dot": 4.0},
                         sample_steps=0, channel=ch)
        assert ch.worker_ready()
        s.baseline.update(s.baseline_key, {"collective-permute": 2.0,
                                           "matmul": 4.0})
        ch.signal(m.CaptureRequest(capture_id="cap-7", steps=2,
                                   reason="slo:test"))
        for step in range(5, 9):
            s.on_step_start(step)
            s.on_step_end(step, 0.001)
        ack = ch.await_ack("cap-7", 10.0)
        s.close()
        assert ack is not None and ack["ok"], ack
        assert sorted(os.listdir(ack["artifact"])) == [
            "flight.json", "summary.json", "timeline.perfetto.json",
            "trace"]
        summary = dict(ack["summary"])
        summary.pop("source")
        summary.pop("wall_s")
        acks[name] = summary
        with open(os.path.join(ack["artifact"],
                               "timeline.perfetto.json")) as f:
            timelines[name] = [
                (e["name"], e["args"]) for e in json.load(f)["traceEvents"]
                if e.get("cat") == "device"]
    assert acks["port"] == acks["jax"]
    assert acks["port"]["attribution"][0]["category"] == "collective-permute"
    assert timelines["port"] == timelines["jax"]


def test_cold_window_is_kept_apart_from_the_governor(tmp_path,
                                                    fresh_telemetry,
                                                    monkeypatch):
    """The process's first profiler start is no steady cost: its window
    re-arms at the floor cadence and is reported apart."""
    clock = FakeClock()
    monkeypatch.setattr(port_prof, "time", clock)

    class ColdFirst(FakeBackend):
        last_cold = False

        def start(self, log_dir):
            self.last_cold = not self.windows
            return super().start(log_dir)

    backend = ColdFirst(clock=clock, costs=[2.0, 0.004, 0.004])
    s = make_sampler(port_prof, tmp_path, lambda d, n: {"matmul": 1.0},
                     sample_steps=2, backend=backend, overhead_pct=2.0)
    for step in range(1, 40):
        s.on_step_start(step)
        clock.now += 0.01
        s.on_step_end(step, 0.01)
    s.close()
    assert s.first_window_cost_s == pytest.approx(2.0)
    # the cold window re-armed at the floor (2 steps); the steady one
    # (4 ms on 10 ms steps at 2%) stretched the gap to 21
    assert [(w["step"], w["cold"]) for w in s.window_costs] == [
        (2, True), (4, False), (25, False)]
    assert s.last_window_cost_s == pytest.approx(0.004)
    assert s.last_gap == int(0.004 / (0.02 * 0.01)) + 1 == 21
    gauges = {g["name"] for g in port_tele.snapshot()["gauges"]}
    assert {"device.optime.first_window_cost_ms",
            "device.optime.window_cost_ms"} <= gauges


# -------------------------------------------------------------------------
# merge_perfetto
# -------------------------------------------------------------------------


def _host_events(rs, n=12):
    kinds = ["span", "slo.breach", "step.end", "span"]
    out = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        ev = {"t": float(100 + rs.uniform(0, 5)), "kind": kind,
              "source": f"worker-0-{i % 3}", "seq": i, "mono": 1.0}
        if kind == "span":
            ev.update(name=f"s{i}", dur=float(rs.uniform(0.001, 0.4)),
                      step=i)
        elif kind == "step.end":
            ev["dur"] = float(rs.uniform(0.001, 0.1))
        out.append(ev)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_perfetto_matches_jax(seed):
    rs = np.random.RandomState(seed)
    events = _host_events(rs)
    device = [{"ph": "X", "name": f"k{i}", "ts": float(rs.uniform(0, 1e4)),
               "dur": float(rs.uniform(1, 50)), "pid": 9, "tid": 7}
              for i in range(8)]
    cats = {"matmul": 6.0, "fusion": 2.0, "copy": 0.5}
    for kw in ({}, {"device_categories": cats},
               {"device_categories": cats, "device_window": (100.5, 101.0)},
               {"device_trace_events": device},
               {"device_trace_events": device,
                "device_window": (100.8, 101.0)}):
        assert port_prof.merge_perfetto(events, **kw) == \
            jax_prof.merge_perfetto(events, **kw), kw
    assert port_prof.merge_perfetto([]) == jax_prof.merge_perfetto([])


def test_merge_perfetto_rebases_kineto_time_onto_the_spans_clock():
    """With Kineto's time base each device event lands at its own wall
    time on the host timeline (not anchored at the window's start)."""
    base = 1000.0
    merged = port_prof.merge_perfetto(
        [{"t": 1001.0, "kind": "span", "name": "train.step", "dur": 0.5,
          "source": "w"}],
        device_window=(1000.6, 1001.0),
        device_trace_events=[_kernel(FLASH[0], 700_000.0, 5.0),
                             _kernel(FLASH[1], 700_020.0, 5.0)],
        device_time_base_s=base)
    dev = sorted((e for e in merged["traceEvents"]
                  if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    # host t0 = 1000.5 (the span's start); the first kernel ran at
    # 1000.7 s of wall time
    assert dev[0]["ts"] == pytest.approx(0.2e6)
    assert dev[1]["ts"] - dev[0]["ts"] == pytest.approx(20.0)
    assert dev[0]["tid"] == 7 and dev[0]["name"] == FLASH[0]


def test_capture_artifact_holds_the_kernels(tmp_path, fresh_telemetry):
    """A capture whose trace holds CUDA kernels: the merged timeline has
    the host spans and every flash kernel, at their own wall times."""
    port_tele.event("span", name="train.step", dur=0.3, trace="t",
                    span="s", parent="")
    art = tmp_path / "cap"
    t_span = time.time()
    base_ns = int((t_span - 1.0) * 1e9)
    _write_trace(str(art / "trace"), _step_events(), base_ns=base_ns)
    summary = {"reason": "test", "wall_s": 0.4,
               "categories": {"matmul": 1.0}}
    port_prof.write_capture_artifact(str(art), summary,
                                     port_tele.snapshot())
    with open(art / "timeline.perfetto.json") as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert set(FLASH) <= kernels
    assert "train.step" in {e["name"] for e in events
                            if e.get("cat") == "host"}
    assert all(e["ts"] >= 0 for e in events if "ts" in e)


# -------------------------------------------------------------------------
# real torch.profiler windows on the CPU
# -------------------------------------------------------------------------


def test_torch_backend_one_window_and_the_one_profiler_slot(tmp_path):
    backend = port_prof.TorchProfilerBackend("cpu")
    assert backend.start(str(tmp_path / "a"))
    other = port_prof.TorchProfilerBackend("cpu")
    assert port_prof._SLOT["owner"] is backend
    assert not other.start(str(tmp_path / "b"))  # refused, not raised
    x = torch.randn(64, 64)
    (x @ x).sum()
    backend.stop()
    assert port_prof._SLOT["owner"] is None
    assert len(port_ts.trace_paths(str(tmp_path / "a"))) == 1
    info = port_ts.window_info(str(tmp_path / "a"))
    assert info["activities"] == ["cpu"]
    assert info["stop_wall"] >= info["start_wall"]
    assert set(backend.last_stop_legs) == {"sync_s", "stop_s", "export_s"}
    s = port_ts.summarize(str(tmp_path / "a"))
    assert s["device_events"] == 0 and s["by_category"] == {}
    assert other.start(str(tmp_path / "b")) and not other.last_cold
    other.stop()
    assert port_prof.device_trace(str(tmp_path / "b")) == (None, None)


def test_real_torch_backend_sampler_window(tmp_path, fresh_telemetry):
    seen = {}

    def parse_fn(trace_dir, steps):
        assert port_prof.DeviceTimeSampler._await_trace(trace_dir, 10.0)
        seen["paths"] = port_ts.trace_paths(trace_dir)
        return {"matmul": 1.0}

    s = port_prof.DeviceTimeSampler(
        str(tmp_path / "prof"), sample_steps=2, parse_fn=parse_fn,
        baseline=port_prof.OpCostBaseline(str(tmp_path / "b.json")),
        capture_channel=None, artifact_root=str(tmp_path / "captures"),
        device="cpu")
    s.set_context("fp", "devices=1")
    x = torch.randn(32, 32)
    for i in range(1, 3):
        s.on_step_start(i)
        y = x @ x
        s.on_step_end(i, 0.001, block_on=y)
    assert wait_until(lambda: "paths" in seen, timeout=15.0)
    s.close()
    assert seen["paths"] and s.window_costs[0]["step"] == 2


def _tiny_trainer(tmp_path, prestep=None, n=96, **kw):
    from dlrover_tpu_torch.models import LlamaConfig, llama_init
    from dlrover_tpu_torch.models import llama_loss_fn
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    cfg = LlamaConfig(vocab_size=32, dim=16, n_layers=1, n_heads=2,
                      n_kv_heads=2, mlp_dim=32, max_seq_len=8,
                      dtype="float32")
    rs = np.random.RandomState(0)
    batches = [{"tokens": rs.randint(0, 32, (2, 9)).astype(np.int32)}
               for _ in range(n)]
    args = TrainingArgs(output_dir=str(tmp_path / "out"),
                        flash_checkpoint=False, log_steps=0,
                        compute_dtype="float32", **kw)
    return Trainer(llama_loss_fn(cfg), lambda s, d: llama_init(cfg, s, d),
                   None, args, train_data=batches, prestep=prestep,
                   device="cpu")


def test_profile_true_trains_and_profiles(tmp_path, fresh_telemetry):
    """``profile=True`` (which raised naming ROADMAP item 12 until the
    plane was ported) captures steps [2, 4) with a real CPU window; the
    always-on sampler is off on the CPU (no device to record) and its
    baseline key is set."""
    trainer = _tiny_trainer(tmp_path, max_steps=6, profile=True,
                            profile_start_step=2, profile_num_steps=2)
    try:
        trainer.train()
        prof_dir = tmp_path / "out" / "profile"
        assert len(port_ts.trace_paths(str(prof_dir))) == 1
        assert trainer._profiler._done
        assert trainer._profiler.assert_ops_present(("flash_fwd",)) == 0
        assert not trainer._prof.sampling_enabled
        fp, mesh = trainer._prof.baseline_key.split("|")
        assert fp == port_prof.model_fingerprint(trainer.state.params)
        assert mesh == "pipe=1,data=1,fsdp=1,expert=1,seq=1,tensor=1"
    finally:
        trainer.close()
    assert port_prof._SLOT["owner"] is None


def test_profile_window_and_sampled_window_on_one_step(tmp_path,
                                                      fresh_telemetry):
    """Both windows due at step 4: the ``profile`` window opens first
    and the sampler's start is refused and re-armed at the floor cadence,
    as the JAX loop's jax.profiler refuses a second trace."""
    trainer = _tiny_trainer(tmp_path, max_steps=10, profile=True,
                            profile_start_step=4, profile_num_steps=1)
    trainer._prof.close()
    trainer._prof = port_prof.DeviceTimeSampler(
        str(tmp_path / "prof"), sample_steps=4,
        parse_fn=lambda d, n: {"matmul": 1.0},
        baseline=port_prof.OpCostBaseline(str(tmp_path / "b.json")),
        capture_channel=None, overhead_pct=0.0, device="cpu")
    try:
        trainer.train()
        assert [w["step"] for w in trainer._prof.window_costs] == [8]
        assert trainer._profiler._done
    finally:
        trainer.close()


# -------------------------------------------------------------------------
# the agent's capture relay
# -------------------------------------------------------------------------


def test_agent_relays_a_directive_to_the_worker_sampler(tmp_path,
                                                       fresh_telemetry):
    """The agent's relay (one background thread) against a live
    worker-side sampler on the channel it created: acked ok with the
    artifact, re-serves of the same directive absorbed."""
    from dlrover_tpu_torch.agent.training_agent import (
        ElasticLaunchConfig,
        ElasticTrainingAgent,
        WorkerSpec,
    )

    reports = []
    client = types.SimpleNamespace(
        master_addr="127.0.0.1:1", node_id=0,
        report_capture_result=lambda *a, **kw: reports.append((a, kw)))
    agent = ElasticTrainingAgent(ElasticLaunchConfig(log_dir=str(tmp_path)),
                                 WorkerSpec("w.py", (), None), client)
    env = agent._worker_env(0, 0, 1, "h:1")
    channel = port_prof.CaptureChannel(env[port_prof.ENV_CAPTURE_DIR])
    s = make_sampler(port_prof, tmp_path, lambda d, n: {"matmul": 3.0},
                     sample_steps=0, channel=channel)
    agent._maybe_execute_capture({"capture_id": "cap-1", "steps": 2})
    agent._maybe_execute_capture({"capture_id": "cap-1", "steps": 2})
    step = 0
    while agent._capture_thread.is_alive() and step < 2000:
        s.on_step_start(step)
        s.on_step_end(step, 0.001)
        step += 1
        time.sleep(0.005)
    agent._capture_thread.join(10)
    s.close()
    assert len(reports) == 1, reports
    (cid, rank, ok), kw = reports[0]
    assert (cid, rank, ok) == ("cap-1", 0, True)
    assert os.path.isdir(kw["artifact"]) and not kw["error"]
    assert kw["summary"]["categories"] == {"matmul": 3.0}
    assert agent._capture_inflight == ""


# -------------------------------------------------------------------------
# end to end: regression -> breach -> capture -> artifact -> timeline
# -------------------------------------------------------------------------


def _http_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return json.loads(resp.read().decode())


# the injected regression: the tiny CPU Llama steps in ~0.05 s on an
# idle host, so 0.25 s more is a ~6x step-time regression; on a loaded
# host it is 4x the healthy median step, whichever is more. The
# synthetic parser prices it into collective-permute time.
MIN_DELAY_S = 0.25


def test_deep_profiling_end_to_end(tmp_path, fresh_telemetry):
    """tests/test_profiling.py's acceptance scenario through the port's
    Trainer, master, HTTP plane and relay, the capture window a REAL
    torch.profiler CPU window: an injected 5-6x step-time regression gives
    an SLO breach naming the host, a capture directive, a capture
    executed by the worker whose attribution names the inflated category
    against the stored baseline, a ``done`` record on /captures.json,
    the always-on gauges on /metrics, and a merged timeline with the
    host spans and the device slices."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.agent.monitor import TelemetryReporter
    from dlrover_tpu_torch.master.http_plane import MasterHttpPlane
    from dlrover_tpu_torch.master.master import LocalJobMaster
    from dlrover_tpu_torch.scheduler.job import new_job_args
    from tests.test_metrics_plane import parse_prometheus

    master = LocalJobMaster(0, new_job_args("local", "prof-e2e",
                                            node_num=1))
    master.prepare()
    svc = master.servicer
    plane = MasterHttpPlane(svc)
    plane.start()
    client = MasterClient(master.addr, 0, "worker")
    reporter = TelemetryReporter(client, interval=999)
    delay = {"s": 0.0}

    def prestep(state, batch):
        if delay["s"]:
            time.sleep(delay["s"])
        return state, batch

    def parse_fn(trace_dir, steps):
        return {"collective-permute": 2.0 + delay["s"] * 1e3,
                "matmul": 1.0}

    trainer = _tiny_trainer(tmp_path, prestep=prestep, max_steps=24)
    channel = port_prof.CaptureChannel(str(tmp_path / "chan"))
    trainer._prof.close()
    trainer._prof = port_prof.DeviceTimeSampler(
        str(tmp_path / "prof"), sample_steps=4, parse_fn=parse_fn,
        baseline=port_prof.OpCostBaseline(str(tmp_path / "baseline.json")),
        capture_channel=channel,
        backend=port_prof.TorchProfilerBackend("cpu"),
        artifact_root=str(tmp_path / "captures"), overhead_pct=0.0)
    trainer._refresh_prof_context()
    try:
        trainer.train()
        prof = trainer._prof
        assert wait_until(lambda: prof.baseline.get(prof.baseline_key))
        reporter.report_once()
        source = port_tele.snapshot()["source"]
        assert svc.diagnosis.check(force=True)["slo"] == {}
        assert prof.baseline.get(prof.baseline_key)[
            "collective-permute"] == pytest.approx(2.0)

        points = next(x["points"] for x in port_tele.snapshot()["series"]
                      if x["name"] == "train.step.last_s")
        healthy = float(np.median([value for *_seq_t, value in points]))
        delay["s"] = max(MIN_DELAY_S, 4 * healthy)
        slow_cp_ms = 2.0 + delay["s"] * 1e3
        trainer.args.max_steps = 34
        trainer.train()

        def slow_sample_parsed():
            return any(
                g["name"] == port_prof.OPTIME_GAUGE
                and g["labels"].get("category") == "collective-permute"
                and g["value"] == pytest.approx(slow_cp_ms)
                for g in port_tele.snapshot()["gauges"])

        assert wait_until(slow_sample_parsed)
        reporter.report_once()
        verdicts = svc.diagnosis.check(force=True)
        assert f"step_time:{source}" in verdicts["slo"], verdicts["slo"]
        directive = dict(client.get_diagnosis().capture)
        assert directive.get("capture_id"), (svc.capture.list(), verdicts)
        assert "slo:step_time_regression" in directive["reason"]

        executor = threading.Thread(
            target=port_prof.execute_capture,
            args=(directive, channel,
                  lambda cid, ok, artifact, summary, error:
                  client.report_capture_result(
                      cid, 0, ok, artifact=artifact, summary=summary,
                      error=error)),
            kwargs={"timeout": 60.0}, daemon=True)
        executor.start()
        trainer.args.max_steps = 40
        trainer.train()
        executor.join(timeout=60)
        assert not executor.is_alive()

        payload = _http_json(plane.port, "/captures.json")
        rec = next(r for r in payload["captures"]
                   if r["id"] == directive["capture_id"])
        assert rec["state"] == "done", rec
        attribution = rec["summary"]["attribution"]
        assert attribution[0]["category"] == "collective-permute"
        assert attribution[0]["delta_pct"] > 300
        trace_dir = os.path.join(rec["artifact"], "trace")
        assert port_ts.trace_paths(trace_dir)
        assert port_ts.window_info(trace_dir)["activities"] == ["cpu"]

        with open(os.path.join(rec["artifact"],
                               "timeline.perfetto.json")) as f:
            timeline = json.load(f)["traceEvents"]
        cats = {e.get("cat") for e in timeline}
        assert "host" in cats and "device" in cats
        assert "train.step" in {e["name"] for e in timeline
                                if e.get("cat") == "host"}
        assert "collective-permute" in {e["name"] for e in timeline
                                        if e.get("cat") == "device"}

        with urllib.request.urlopen(
                f"http://127.0.0.1:{plane.port}/metrics", timeout=10) as r:
            samples = parse_prometheus(r.read().decode())
        optime = dict(samples["dlrtpu_device_optime_ms"])
        assert next(v for k, v in optime.items()
                    if 'category="collective-permute"' in k) == \
            pytest.approx(slow_cp_ms)
        assert any('state="done"' in k
                   for k, _v in samples["dlrtpu_prof_captures"])
        rep = _http_json(plane.port, "/report.json")
        assert "device.optime.regression" in {e["kind"]
                                              for e in rep["timeline"]}
        assert rep["captures"]["states"].get("done") == 1
    finally:
        delay["s"] = 0.0
        trainer.close()
        client.close()
        plane.stop()
        master.stop()


# -------------------------------------------------------------------------
# import boundaries
# -------------------------------------------------------------------------


def test_new_modules_import_neither_jax_nor_the_jax_package():
    """The slice's modules, imported in a fresh interpreter, load neither
    jax nor dlrover_tpu; the brain and the profiling plane's common
    modules, imported in one of their own, load no torch either."""
    no_torch = ["dlrover_tpu_torch.common.profiling",
                "dlrover_tpu_torch.common.trace_summary",
                "dlrover_tpu_torch.brain", "dlrover_tpu_torch.brain.main",
                "dlrover_tpu_torch.brain.monitor",
                "dlrover_tpu_torch.brain.runtime_opt",
                "dlrover_tpu_torch.brain.algorithms",
                "dlrover_tpu_torch.brain.service",
                "dlrover_tpu_torch.brain.client",
                "dlrover_tpu_torch.brain.datastore",
                "dlrover_tpu_torch.brain.messages"]
    with_torch = ["dlrover_tpu_torch.trainer.profiler",
                  "dlrover_tpu_torch.trainer.trainer",
                  "dlrover_tpu_torch.agent.training_agent"]
    code = (
        "import importlib, sys\n"
        "torch_ok = sys.argv[1] == '1'\n"
        "for mod in sys.argv[2:]:\n"
        "    importlib.import_module(mod)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dlrover_tpu' or m.startswith('dlrover_tpu.')]\n"
        "assert not bad, bad\n"
        "assert torch_ok or 'torch' not in sys.modules, 'torch imported'\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    for flag, mods in (("0", no_torch), ("1", with_torch)):
        subprocess.run([sys.executable, "-c", code, flag, *mods],
                       check=True, cwd=REPO, env=env, timeout=120)
