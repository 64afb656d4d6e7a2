"""The port's strategy search engine (dlrover_tpu_torch/parallel/engine.py)
against the JAX package's (dlrover_tpu/parallel/engine.py).

Every pure case of tests/test_engine.py runs through both packages on
the same inputs, and their answers are compared element for element:
the factorizations, the slow-link placement, the analysis of the same
shapes (a nested JAX tree and the port's flat dict), the candidate
lists, the memory estimate, the GP's features, the Bayesian search's
suggestions and picks, the task loop, the quantized-dtype gate and the
rank correlation. The JAX package's TPU defaults (16 GiB, 4 devices a
host, 180 and 25 Gbit/s) are passed to both explicitly: the port has
no such defaults.

Then the port alone: ``DryRunner`` on the port's ``auto_accelerate`` on
the CPU, ``search_strategy`` in one process (its analysis from a
``FakeTensorMode`` init equal to JAX's of the same model), which
failures a dry-run records and which propagate, and the defaults it
refuses to guess.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import (
    LlamaConfig,
    llama_init,
    llama_logical_axes,
    llama_loss_fn,
)
from dlrover_tpu_torch.parallel import engine as port
from dlrover_tpu_torch.parallel.mesh import MeshError
from dlrover_tpu_torch.parallel.strategy import MeshConfig, Strategy
from dlrover_tpu_torch.trainer import build_optimizer

# the JAX package's defaults, passed to both packages
TPU = dict(hbm_gb=16.0, devices_per_host=4)


def _jax():
    from dlrover_tpu.parallel import engine

    return engine


def _jax_types():
    from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
    from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy

    return JaxMesh, JaxStrategy


def _key(s) -> tuple:
    """A strategy of either package as comparable values."""
    return (dataclasses.asdict(s.mesh), s.remat, s.compute_dtype)


def _to_jax(s):
    """A port Strategy as the JAX package's (mesh, remat, dtype)."""
    JaxMesh, JaxStrategy = _jax_types()
    return JaxStrategy(mesh=JaxMesh(**dataclasses.asdict(s.mesh)),
                       remat=s.remat, compute_dtype=s.compute_dtype)


def _analyses(**kw):
    d = dict(param_count=1_000_000, param_bytes=4_000_000, n_layers=4)
    d.update(kw)
    return port.ModelAnalysis(**d), _jax().ModelAnalysis(**d)


# ------------------------------------------------------- pure arithmetic


@pytest.mark.parametrize("n,dims", [(1, 4), (8, 4), (12, 3), (64, 4),
                                    (7, 2)])
def test_factorizations_match(n, dims):
    ours = list(port._factorizations(n, dims))
    assert ours == list(_jax()._factorizations(n, dims))
    assert all(np.prod(f) == n for f in ours)
    assert len(set(ours)) == len(ours)


def test_dcn_placement_matches():
    for pipe, data, fsdp in [(1, 1, 8), (2, 4, 1), (1, 2, 4), (4, 1, 2),
                             (1, 3, 3)]:
        for slices in (1, 2, 4, 8, 3):
            assert port._dcn_placement(pipe, data, fsdp, slices) == \
                _jax()._dcn_placement(pipe, data, fsdp, slices)


def _shapes_cases():
    def hidden_model(d, layers=4):
        return {"embed": (512, d), "layers.wq": (layers, d, d),
                "layers.mlp": (layers, d, 4 * d), "layers.norm": (layers, d)}

    return {
        "counts": {"w": (4, 8), "layers": (6, 3, 3)},
        "eval_shape": {"w": (10, 10)},
        "hidden1k": hidden_model(1024),
        "hidden8k": hidden_model(8192),
        "tie": {"a": (4, 16), "b": (16, 8), "c": (3, 3, 3)},
        "llama": {k: tuple(v.shape) for k, v in llama_init(
            LlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4,
                        n_kv_heads=2, mlp_dim=64, max_seq_len=32,
                        dtype="float32"), 0, "cpu").items()},
    }


def _nested(flat: dict) -> dict:
    out: dict = {}
    for name, leaf in flat.items():
        node = out
        *parents, last = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


@pytest.mark.parametrize("case", list(_shapes_cases()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_analysis_of_the_same_shapes_matches(case, dtype):
    """The port's flat dict of tensors against JAX's nested tree of
    arrays of the same shapes and dtype (abstract on JAX's side, as
    under eval_shape)."""
    import jax
    import jax.numpy as jnp

    shapes = _shapes_cases()[case]
    ours = port.analyse_params(
        {k: torch.zeros(s, dtype=getattr(torch, dtype))
         for k, s in shapes.items()})
    theirs = _jax().analyse_params(_nested(
        {k: jax.ShapeDtypeStruct(s, getattr(jnp, dtype))
         for k, s in shapes.items()}))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def _candidate_cases():
    return {
        "prefers_fsdp": (8, {}, dict(TPU)),
        "memory_forces_sharding": (8, dict(param_count=7_000_000_000),
                                   dict(TPU)),
        "tensor_capped_at_host": (16, {}, dict(TPU)),
        "long_context_seq": (8, {}, dict(TPU, seq_len=131072,
                                         hbm_gb=1024.0)),
        "moe_expert": (8, dict(moe=True, n_experts=8),
                       dict(TPU, hbm_gb=1024.0)),
        "bo_space": (64, dict(n_layers=32), dict(
            hbm_gb=1024.0, devices_per_host=8, max_candidates=16)),
        "narrow_64gb": (8, dict(param_count=1024 * 1024 * 5 * 32,
                               n_layers=32, hidden=1024),
                       dict(TPU, hbm_gb=64.0, batch_per_device=8)),
        "wide_64gb": (8, dict(param_count=1024 * 1024 * 5 * 32,
                             n_layers=32, hidden=8192),
                     dict(TPU, hbm_gb=64.0, batch_per_device=8)),
        "two_slices": (16, dict(n_layers=8), dict(
            TPU, n_slices=2, ici_gbps=180.0, dcn_gbps=25.0)),
        "four_slices_no_pipe": (32, dict(n_layers=8), dict(
            TPU, n_slices=4, ici_gbps=180.0, dcn_gbps=25.0,
            allow_pipe=False)),
        "quadratic_override": (8, {}, dict(TPU, hidden=8192, seq_len=8192)),
    }


@pytest.mark.parametrize("case", list(_candidate_cases()))
def test_candidates_match(case):
    n, analysis_kw, kw = _candidate_cases()[case]
    ours_a, theirs_a = _analyses(**analysis_kw)
    ours = port.candidate_strategies(n, ours_a, **kw)
    theirs = _jax().candidate_strategies(n, theirs_a, **kw)
    assert ours, "no candidates"
    assert [_key(s) for s in ours] == [_key(s) for s in theirs]
    assert all(s.compute_dtype == "bfloat16" for s in ours)


def test_candidate_properties_hold():
    """The JAX tests' properties, on the port's lists: pure fsdp first,
    a 7B model never unsharded, tensor at most a host, a seq axis for
    long sequences, an expert axis for MoE."""
    a, _ = _analyses()
    top = port.candidate_strategies(8, a, **TPU)[0].mesh
    assert (top.fsdp, top.tensor, top.pipe) == (8, 1, 1)
    big, _ = _analyses(param_count=7_000_000_000)
    assert all(s.mesh.fsdp * s.mesh.tensor * s.mesh.pipe > 1
               for s in port.candidate_strategies(8, big, **TPU))
    assert all(s.mesh.tensor <= 4
               for s in port.candidate_strategies(16, a, **TPU))
    assert any(s.mesh.seq > 1 for s in port.candidate_strategies(
        8, a, seq_len=131072, hbm_gb=1024.0, devices_per_host=4))
    moe, _ = _analyses(moe=True, n_experts=8)
    assert any(s.mesh.expert > 1 for s in port.candidate_strategies(
        8, moe, hbm_gb=1024.0, devices_per_host=4))
    # the activation term follows the model's width
    narrow, wide = (port.candidate_strategies(
        *_candidate_cases()[case][:1], _analyses(
            **_candidate_cases()[case][1])[0], **_candidate_cases()[case][2])
        for case in ("narrow_64gb", "wide_64gb"))
    assert ({(s.mesh.fsdp, s.mesh.data, s.remat) for s in narrow}
            != {(s.mesh.fsdp, s.mesh.data, s.remat) for s in wide})


@pytest.mark.parametrize("remat", ["none", "minimal", "offload", "full",
                                   "unknown"])
def test_hbm_estimate_matches(remat):
    big, big_jax = _analyses(param_count=350_000_000, n_layers=16,
                             hidden=1024)
    meshes = [dict(fsdp=1), dict(fsdp=8), dict(fsdp=2, tensor=2, seq=2),
              dict(data=2, expert=4, pipe=2), dict(fsdp=1, seq=8)]
    JaxMesh, JaxStrategy = _jax_types()
    for mesh in meshes:
        for kw in (dict(), dict(batch_per_device=8, seq_len=32768),
                   dict(seq_len=8192, attn_quadratic=True),
                   dict(hidden=8192)):
            ours = port.estimate_hbm_per_device(
                big, Strategy(mesh=MeshConfig(**mesh), remat=remat), **kw)
            theirs = _jax().estimate_hbm_per_device(
                big_jax, JaxStrategy(mesh=JaxMesh(**mesh), remat=remat),
                **kw)
            assert ours == theirs


def test_features_match():
    a, _ = _analyses(n_layers=32)
    for s in port.candidate_strategies(64, a, hbm_gb=1024.0,
                                       devices_per_host=8):
        assert port._strategy_features(s) == \
            _jax()._strategy_features(_to_jax(s))


# ----------------------------------------------------- the search itself


def _bo_candidates():
    a, a_jax = _analyses(n_layers=32)
    kw = dict(hbm_gb=1024.0, devices_per_host=8, max_candidates=16)
    return (port.candidate_strategies(64, a, **kw),
            _jax().candidate_strategies(64, a_jax, **kw))


def _true_step_time(features):
    # optimum at fsdp=8, away from the cost model's top pick (fsdp=64)
    f = features
    return (0.1 + 0.02 * (f[1] - 3.0) ** 2 + 0.05 * f[2] + 0.08 * f[3]
            + 0.03 * f[6])


def test_bo_suggestions_and_pick_match():
    """The seed order, every suggestion and the pick, the same index by
    index; the optimum found within half the candidates."""
    ours_c, theirs_c = _bo_candidates()
    ours, theirs = port.BayesianSearch(ours_c), _jax().BayesianSearch(
        theirs_c)
    assert ours._seed_order == theirs._seed_order
    seen = []
    for _ in range(len(ours_c) // 2):
        i, j = ours.suggest(), theirs.suggest()
        assert i == j
        seen.append(i)
        t = _true_step_time(port._strategy_features(ours_c[i]))
        ours.observe(i, t)
        theirs.observe(j, t)
    assert ours.best() == theirs.best()
    best_true = min(range(len(ours_c)), key=lambda i: _true_step_time(
        port._strategy_features(ours_c[i])))
    assert best_true != 0 and ours.best() == best_true


def test_bo_failures_match():
    """A failed first dry-run steers the next suggestion away; the
    penalty is 10x the worst ok time (at least 1) and does not
    compound; best() skips failures."""
    ours_c, theirs_c = _bo_candidates()
    for search in (port.BayesianSearch(ours_c),
                   _jax().BayesianSearch(theirs_c)):
        i0 = search.suggest()
        search.observe(i0, 0.0, ok=False)
        i1 = search.suggest()
        assert i1 != i0
        search.observe(i1, 0.2)
        assert search.best() == i1
    ours, theirs = port.BayesianSearch(ours_c), _jax().BayesianSearch(
        theirs_c)
    for search in (ours, theirs):
        search.observe(0, 0.1)
        for i in range(1, 5):
            search.observe(i, 0.0, ok=False)
        search.observe(5, 99.0)
    assert ours._observed == theirs._observed
    assert max(ours._observed[i] for i in range(1, 5)) <= 1.0 + 1e-9
    assert ours.best() == theirs.best() == 0


def _engines(n=64, analysis_kw=None, **kw):
    a, a_jax = _analyses(**(analysis_kw or dict(n_layers=32)))
    return (port.StrategySearchEngine(n, a, **kw),
            _jax().StrategySearchEngine(n, a_jax, **kw))


@pytest.mark.parametrize("algo", ["greedy", "bo"])
def test_task_loop_matches(algo):
    """The task loop, fed the same results: the same task ids, and the
    same FINISH strategy; under "bo" the second task is the GP's seed
    (the most distant candidate), not cursor 1."""
    ours, theirs = _engines(hbm_gb=1024.0, devices_per_host=8,
                            max_dryruns=4, search_algo=algo,
                            max_candidates=16)
    seen = []
    while True:
        t, u = ours.get_task(), theirs.get_task()
        assert (t.task_type, t.task_id) == (u.task_type, u.task_id)
        if t.task_type == port.TaskType.FINISH:
            assert _key(t.strategy) == _key(u.strategy)
            break
        seen.append(t.task_id)
        step = sum(port._strategy_features(t.strategy))
        ours.report_task_result(t.task_id,
                                port.DryRunResult(t.strategy, step_s=step))
        theirs.report_task_result(u.task_id,
                                  _jax().DryRunResult(u.strategy,
                                                      step_s=step))
    assert len(seen) == 4
    if algo == "bo":
        assert seen[1] != 1 and len(ours._bo._observed) == 4


def test_concurrent_tasks_and_failures_match():
    ours, theirs = _engines(hbm_gb=1024.0, devices_per_host=8,
                            max_dryruns=6, search_algo="bo",
                            max_candidates=16)
    ids = [ours.get_task().task_id for _ in range(4)]
    assert ids == [theirs.get_task().task_id for _ in range(4)]
    assert len(set(ids)) == 4
    ours, theirs = _engines(8, dict(), max_dryruns=1, **TPU)
    t, u = ours.get_task(), theirs.get_task()
    ours.report_task_result(t.task_id, port.DryRunResult(
        t.strategy, ok=False, error="OOM"))
    theirs.report_task_result(u.task_id, _jax().DryRunResult(
        u.strategy, ok=False, error="OOM"))
    t, u = ours.get_task(), theirs.get_task()
    assert t.task_type == u.task_type == port.TaskType.FINISH
    assert _key(t.strategy) == _key(u.strategy)


class _Runner:
    """A dry-runner of either package: step time from the features,
    loss and time by compute dtype where given."""

    def __init__(self, result_type, times=None, losses=None, fail=()):
        self.result_type, self.times = result_type, times
        self.losses, self.fail = losses, fail
        self.calls = []

    def profile(self, s):
        self.calls.append(_key(s))
        if s.compute_dtype in self.fail:
            return self.result_type(strategy=s, ok=False, error="OOM")
        step = (self.times[s.compute_dtype] if self.times
                else sum(port._strategy_features(s)))
        loss = self.losses[s.compute_dtype] if self.losses else None
        return self.result_type(strategy=s, step_s=step, loss=loss)


def _search_both(runner_kw, n=8, analysis_kw=None, **kw):
    ours_r = _Runner(port.DryRunResult, **runner_kw)
    theirs_r = _Runner(_jax().DryRunResult, **runner_kw)
    ours, theirs = _engines(n, analysis_kw or {}, **kw)
    ours._dry_runner, theirs._dry_runner = ours_r, theirs_r
    best, best_jax = ours.search(), theirs.search()
    assert ours_r.calls == theirs_r.calls
    assert _key(best) == _key(best_jax)
    return best, ours, ours_r


def test_engine_bo_search_matches():
    best, engine, runner = _search_both(
        {}, 64, dict(n_layers=32), hbm_gb=1024.0, devices_per_host=8,
        max_dryruns=5, search_algo="bo", max_candidates=16)
    assert isinstance(best, Strategy)
    assert len(runner.calls) <= 5 < len(engine.candidates)


@pytest.mark.parametrize("case,times,losses,want,weighed", [
    ("int8_wins_with_parity", {"bfloat16": 0.10, "int8": 0.09},
     {"bfloat16": 2.00, "int8": 2.02}, "int8", {True}),
    ("int8_gated_without_parity", {"bfloat16": 0.10, "int8": 0.08},
     {"bfloat16": 2.00, "int8": 2.50}, "bfloat16", {False}),
    ("int8_not_selected_when_slower", {"bfloat16": 0.10, "int8": 0.12},
     {"bfloat16": 2.00, "int8": 2.00}, "bfloat16", set()),
])
def test_low_precision_gate_matches(case, times, losses, want, weighed):
    """Both engines pick alike; the port's ``quant_gate`` keeps each
    decision (an int8 run slower than a bf16 one is never weighed)."""
    best, engine, _ = _search_both(
        dict(times=times, losses=losses), try_low_precision=True,
        max_dryruns=8, **TPU)
    assert best.compute_dtype == want
    assert {passed for _, passed in engine.quant_gate} == weighed
    assert all(r.strategy.compute_dtype == "int8"
               for r, _ in engine.quant_gate)
    assert {s.compute_dtype for s in engine.candidates} == {"bfloat16",
                                                           "int8"}


def test_low_precision_fallbacks_match():
    """Without the flag only bf16 is proposed; when only gated-off int8
    runs succeeded, the cost model's top bf16 candidate is returned."""
    ours, theirs = _engines(8, {}, **TPU)
    assert [_key(s) for s in ours.candidates] == \
        [_key(s) for s in theirs.candidates]
    assert all(s.compute_dtype == "bfloat16" for s in ours.candidates)
    best, engine, _ = _search_both(
        dict(times={"int8": 0.08}, losses={"int8": 2.0},
             fail=("bfloat16",)), try_low_precision=True, max_dryruns=8,
        **TPU)
    assert best.compute_dtype == "bfloat16"


def test_no_feasible_candidate_falls_back_to_the_planner():
    """Nothing fits: both engines return the heuristic planner's plan,
    the port's with its own memory and host size (JAX's planner takes
    its defaults; here they plan the same)."""
    from dlrover_tpu_torch.parallel.strategy import auto_strategy

    best, engine, runner = _search_both(
        {}, 8, dict(param_count=7_000_000_000), hbm_gb=0.001,
        devices_per_host=4)
    assert engine.candidates == [] and runner.calls == []
    assert _key(best) == _key(auto_strategy(8, 7_000_000_000, hbm_gb=0.001,
                                            devices_per_host=4))
    assert best.mesh.tensor == 4 and best.remat == "full"


def test_rank_correlation_matches():
    a, _ = _analyses()
    cands = port.candidate_strategies(8, a, hbm_gb=1024.0,
                                      devices_per_host=4, max_candidates=8)
    jax_cands = [_to_jax(s) for s in cands]

    def both(make):
        ours = port.cost_model_rank_correlation(
            cands, [make(port.DryRunResult, s, i)
                    for i, s in enumerate(cands[:5])])
        theirs = _jax().cost_model_rank_correlation(
            jax_cands, [make(_jax().DryRunResult, s, i)
                        for i, s in enumerate(jax_cands[:5])])
        assert ours == theirs
        return ours

    assert both(lambda R, s, i: R(s, step_s=0.1 + 0.01 * i)) == \
        pytest.approx(1.0)
    assert both(lambda R, s, i: R(s, step_s=0.1 - 0.01 * i)) == \
        pytest.approx(-1.0)
    assert both(lambda R, s, i: R(s, step_s=0.1 + 0.01 * (i % 3))) < 1.0
    assert both(lambda R, s, i: R(s, ok=False)) is None
    assert both(lambda R, s, i: R(s, step_s=0.1)) is None
    two = [port.DryRunResult(s, step_s=0.1) for s in cands[:2]]
    assert port.cost_model_rank_correlation(cands, two) is None


# ------------------------------------------------------ the port's runner


TINY = LlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4,
                   n_kv_heads=2, mlp_dim=64, max_seq_len=32,
                   attn_impl="flash", remat=False, dtype="float32",
                   attn_block_q=16, attn_block_k=16)


def _make_batch():
    return {"tokens": np.random.RandomState(0).randint(
        0, TINY.vocab_size, (8, 17)).astype(np.int32)}


def _init(seed, device):
    return llama_init(TINY, seed, device)


def test_dry_runner_times_the_port_step():
    runner = port.make_auto_accelerate_dry_runner(
        llama_loss_fn(TINY), _init, build_optimizer("adamw", 1e-3),
        llama_logical_axes(TINY), _make_batch, device="cpu")
    res = runner.profile(Strategy(remat="none", compute_dtype="float32"))
    assert res.ok, res.error
    assert res.step_s > 0 and res.compile_s > 0
    assert np.isfinite(res.loss)


def test_search_strategy_in_one_process():
    """One process, no group: one device, the unsharded mesh at its first
    feasible remat; the analysis from a FakeTensorMode init equals
    JAX's of the same model."""
    import jax

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_init as jax_init

    best = port.search_strategy(
        llama_loss_fn(TINY), _init, build_optimizer("adamw", 1e-3),
        llama_logical_axes(TINY), _make_batch, device="cpu", hbm_gb=16.0,
        max_dryruns=2)
    m = best.mesh
    assert (m.data, m.fsdp, m.tensor, m.seq, m.pipe, m.expert) == \
        (1, 1, 1, 1, 1, 1)
    assert best.remat == "none"
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        ours = port.analyse_params(_init(0, "cpu"))
    theirs = _jax().analyse_params(jax.eval_shape(
        lambda r: jax_init(JaxConfig(**dataclasses.asdict(TINY)), r),
        jax.random.key(0)))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("error,recorded", [
    (RuntimeError("CUDA error: an illegal memory access"), False),
    (NotImplementedError("pipe (ROADMAP Queue 1 item 10)"), True),
    (MeshError("mesh axes do not fit"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (ValueError("some other fault"), False),
], ids=["runtime", "not_implemented", "mesh", "oom", "value"])
def test_dry_run_records_only_infeasible_candidates(error, recorded):
    """An out-of-memory error, a NotImplementedError and a MeshError make
    an infeasible candidate; a kernel's RuntimeError or any other error
    propagates (JAX's runner records every Exception)."""
    def build(strategy):
        raise error

    runner = port.DryRunner(build)
    if not recorded:
        with pytest.raises(type(error)):
            runner.profile(Strategy())
        return
    res = runner.profile(Strategy())
    assert not res.ok and res.error.startswith(type(error).__name__)


def test_no_tpu_figure_is_a_default(monkeypatch):
    """hbm_gb=None reads the card (none here: it raises); a multi-slice
    search needs both bandwidths; devices_per_host=None is the local
    world size."""
    a, _ = _analyses()
    with pytest.raises(ValueError, match="no CUDA device"):
        port.candidate_strategies(8, a)
    with pytest.raises(ValueError, match="ici_gbps and dcn_gbps"):
        port.candidate_strategies(16, a, hbm_gb=16.0, n_slices=2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert all(s.mesh.tensor <= 2
               for s in port.candidate_strategies(8, a, hbm_gb=16.0))
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert port._local_world_size() == 1
