"""The port's brain service (``dlrover_tpu_torch/brain/``) held against
the JAX package's on the CPU: the same store records give the same plans
from every registered algorithm (the scenarios of ``tests/test_brain.py``,
its reference Go scenarios of the windowed algorithms, and seeded random
histories), the pure runtime functions agree, the service answers the
same over the port's RPC as the JAX service over its own, the master
integrations (``BrainResourceOptimizer`` over ``master/resource.py``,
``BrainReporter`` over ``master/stats.py``) and the cluster monitor, a
client on a dead address degrades without costing a training step, and
``python -m dlrover_tpu_torch.brain.main`` serves. The two packages'
services are not wire-compatible (each unpickler admits its own
package's message classes only): a JAX client gets nothing from the
port's brain."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from dlrover_tpu.brain import algorithms as jax_algos
from dlrover_tpu.brain import datastore as jax_store
from dlrover_tpu.brain import messages as jax_msg
from dlrover_tpu.brain import monitor as jax_monitor
from dlrover_tpu.brain import runtime_opt as jax_rt
from dlrover_tpu_torch.brain import algorithms as port_algos
from dlrover_tpu_torch.brain import datastore as port_store
from dlrover_tpu_torch.brain import messages as port_msg
from dlrover_tpu_torch.brain import monitor as port_monitor
from dlrover_tpu_torch.brain import runtime_opt as port_rt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": (jax_store, jax_algos, jax_msg),
         "port": (port_store, port_algos, port_msg)}


def plans(records, opt_type, job_uuid, job_name, config=None):
    """Each package's plan for ``opt_type`` over a store holding
    ``records`` ([(uuid, name, metrics, timestamp)], in order)."""
    out = {}
    for side, (store_mod, algos, msg) in SIDES.items():
        store = store_mod.MetricsStore()
        for uuid, name, metrics, ts in records:
            store.persist(uuid, name, metrics, timestamp=ts)
        out[side] = algos.get_algorithm(opt_type)(store, msg.OptimizeRequest(
            job_uuid=job_uuid, job_name=job_name, opt_type=opt_type,
            config=dict(config or {})))
        store.close()
    return out


def assert_same(got: dict):
    assert got["port"] == got["jax"], got


def test_registries_match():
    assert port_algos.algorithm_names() == jax_algos.algorithm_names()
    assert len(port_algos.algorithm_names()) == 8


def _r(uuid, name, metrics, ts):
    return (uuid, name, metrics, float(ts))


# (name, records, opt_type, job_uuid, job_name, config, expected plan):
# tests/test_brain.py's scenarios; the expected plan is the one that
# test asserts
SCENARIOS = [
    ("cold_create", [_r(u, "train-llama", {"worker_count": c,
                                           "used_memory_mb": m}, i)
                     for i, (u, c, m) in enumerate((
                         ("a", 4, 1000), ("b", 8, 2000), ("c", 6, 1500)))],
     "cold_create", "new", "train-llama", {},
     {"worker_count": 6, "memory_mb": int(1500 * 1.3)}),
    ("cold_create_none", [], "cold_create", "new", "never-seen", {}, None),
    ("worker_resource", [_r("job1", "j", {"used_memory_mb": m}, i)
                         for i, m in enumerate((1000, 3000, 2000))],
     "worker_resource", "job1", "j", {}, {"memory_mb": int(3000 * 1.4)}),
    ("oom_memory", [], "oom_memory", "j", "j", {"memory_mb": 4096},
     {"memory_mb": 8192}),
    ("worker_count", [_r("job2", "j2", {"worker_count": c, "speed": s}, i)
                      for i, (c, s) in enumerate(
                          [(4, 40.0), (8, 60.0), (16, 64.0), (8, 62.0)])],
     "worker_count", "job2", "j2", {}, {"worker_count": 8}),
    ("worker_count_lax", [_r("job2", "j2", {"worker_count": c, "speed": s},
                             i) for i, (c, s) in enumerate(
                                 [(4, 40.0), (8, 60.0), (16, 64.0),
                                  (8, 62.0)])],
     "worker_count", "job2", "j2", {"min_efficiency": 0.3},
     {"worker_count": 16}),
    ("hot_ps", [_r("hot1", "jh", {
        "worker_count": 4,
        "nodes": [{"node_id": 0, "cpu_percent": 95.0,
                   "used_memory_mb": 9000},
                  {"node_id": 1, "cpu_percent": 20.0,
                   "used_memory_mb": 3000}]}, 0)],
     "hot_ps", "hot1", "jh", {"hot_cpu_threshold": 90.0,
                              "hot_memory_threshold_mb": 8000,
                              "target_worker_count": 8,
                              "memory_adjust_mb": 2048},
     {"node_adjustments": {"0": {"cpu_percent_target": 190.0,
                                 "memory_mb": 11048}}}),
    ("hot_ps_none", [_r("cool1", "jc", {"nodes": [
        {"node_id": 0, "cpu_percent": 10.0, "used_memory_mb": 100}]}, 0)],
     "hot_ps", "cool1", "jc", {}, None),
    ("init_adjust", [_r("init1", "ji", {"global_step": 10,
                                        "worker_count": 2,
                                        "used_memory_mb": 1000}, 0)],
     "init_adjust", "init1", "ji", {"step_count_threshold": 100,
                                    "target_worker_count": 4,
                                    "init_headroom": 1.5},
     {"memory_mb": 3000}),
    ("init_adjust_past", [_r("init2", "ji", {"global_step": 5000,
                                             "used_memory_mb": 1000}, 0)],
     "init_adjust", "init2", "ji", {"step_count_threshold": 100}, None),
    ("job_completion", [_r("jc1", "jj", {"global_step": 100}, 1000.0),
                        _r("jc1", "jj", {"global_step": 600}, 1100.0)],
     "job_completion", "jc1", "jj", {"max_steps": 1100},
     {"steps_per_second": 5.0, "estimated_remaining_s": 100,
      "estimated_completion_ts": 1200}),
    ("worker_create_oom", [
        _r("u1", "train-llm", {"used_memory_mb": 9000, "oom": 1,
                               "memory_mb": 10000}, 0),
        _r("u2", "train-llm", {"used_memory_mb": 7000}, 1)],
     "worker_create_oom", "u3", "train-llm", {}, {"memory_mb": 11024}),
    ("worker_create_oom_none", [_r("u1", "clean-job",
                                   {"used_memory_mb": 9000}, 0)],
     "worker_create_oom", "u2", "clean-job", {}, None),
    ("hot_ps_runtime", [_r("uuid-rt", "job-rt", {"runtime": {
        "ps_cpu": {0: 6.0, 1: 9.0}, "ps_memory": {0: 4e9, 1: 4e9},
        "worker_cpu": {}}}, i) for i in range(3)],
     "hot_ps", "uuid-rt", "job-rt",
     {"ps_cpus": {0: 10.0, 1: 10.0}, "ps_memory": {0: 5e9, 1: 5e9},
      "hot_cpu_threshold": 0.8}, "nonnull"),
    ("worker_resource_spmd", [_r("uuid-spmd", "job-spmd", {
        "runtime": {"speed": 8.0, "worker_cpu": {i: 0.3 for i in range(8)},
                    "worker_memory": {i: 10.0 for i in range(8)}},
        "used_memory_mb": 100}, t) for t in range(4)],
     "worker_resource", "uuid-spmd", "job-spmd", {}, {"memory_mb": 140}),
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s[0] for s in SCENARIOS])
def test_algorithm_scenarios_match_jax(scenario):
    _name, records, opt_type, uuid, job, config, want = scenario
    got = plans(records, opt_type, uuid, job, config)
    assert_same(got)
    if want == "nonnull":
        assert got["port"]["node_adjustments"]["1"]["cpu_cores"] == 32
    else:
        assert got["port"] == want


def _random_history(seed):
    """Seeded records of three jobs sharing a name: worker counts, speeds,
    memory, steps, per-node stats, OOM flags and runtime samples."""
    rs = np.random.RandomState(seed)
    records = []
    for j, uuid in enumerate(("r0", "r1", "r2")):
        workers = int(rs.choice([2, 4, 8, 16]))
        for i in range(12):
            metrics = {"worker_count": workers,
                       "speed": float(rs.uniform(5, 50)) * workers ** 0.8,
                       "used_memory_mb": float(rs.uniform(800, 9000)),
                       "global_step": 10 * i + int(rs.randint(0, 5)),
                       "memory_mb": float(rs.choice([8192, 16384]))}
            if rs.rand() < 0.2:
                metrics["oom"] = 1
            if i % 3 == 0:
                metrics["nodes"] = [
                    {"node_id": n, "cpu_percent": float(rs.uniform(5, 99)),
                     "used_memory_mb": float(rs.uniform(100, 9500))}
                    for n in range(3)]
            if i >= 6:
                metrics["runtime"] = {
                    "speed": float(rs.uniform(5, 20)),
                    "ps_cpu": {n: float(rs.uniform(1, 10)) for n in range(2)},
                    "ps_memory": {n: float(rs.uniform(1e9, 5e9))
                                  for n in range(2)},
                    "worker_cpu": {n: float(rs.uniform(0.1, 0.9))
                                   for n in range(workers)},
                    "worker_memory": {n: float(rs.uniform(1, 40))
                                      for n in range(workers)},
                }
            records.append((uuid, "seeded-job", metrics,
                            1000.0 + 100 * j + 10 * i))
    config = {"ps_cpus": {0: 10.0, 1: 10.0},
              "ps_memory": {0: 5e9, 1: 5e9},
              "hot_cpu_threshold": float(rs.choice([0.5, 0.8, 90.0])),
              "hot_memory_threshold_mb": 8000,
              "target_worker_count": int(rs.choice([4, 20, 32])),
              "step_count_threshold": int(rs.choice([5, 100])),
              "max_steps": 5000, "max_replica": 10,
              "model_feature": {"recv_op_count": 100},
              "memory_mb": float(rs.choice([0, 4096]))}
    return records, config


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("opt_type", sorted(jax_algos.algorithm_names()))
def test_every_algorithm_matches_jax_on_seeded_history(opt_type, seed):
    records, config = _random_history(seed)
    for uuid in ("r1", "new"):
        assert_same(plans(records, opt_type, uuid, "seeded-job", config))


def test_runtime_functions_match_jax():
    """The pure windowed functions on tests/test_brain.py's reference
    scenarios (transcribed from the Go *_test.go cases)."""
    gib = 1024 ** 3
    hot = {"ps_cpu": {0: 6.0, 1: 9.0}, "ps_memory": {0: 4 * gib, 1: 4 * gib},
           "worker_cpu": {}}
    hot_cfg = {"hot_cpu_threshold": 0.8, "hot_memory_threshold": 0.9,
               "target_worker_count": 20, "memory_adjust": 4e9}
    one = {"speed": 8.0, "ps_cpu": {0: 4.0}, "worker_cpu": {0: 0.3},
           "worker_memory": {0: 10.0}}

    def five(speed):
        return {"speed": speed, "ps_cpu": {0: 6.0},
                "worker_cpu": {i: 0.35 for i in range(5)},
                "worker_memory": {i: 20.0 for i in range(5)}}

    wcfg = {"max_replica": 10, "step_count_threshold": 5,
            "ps_cpu_exhausted": 0.95, "ps_cpu_overload": 0.8,
            "speed_less_percent": 0.1, "replica_decrease_count": 1,
            "max_init_count_per_step": 32, "max_count_per_step": 4,
            "memory_margin_percent": 0.2, "cpu_margin_cores": 1.0,
            "cpu_util_comp_count": 2, "cpu_util_less_percent": 0.15,
            "phase": "stable"}
    exhausted = [dict(one)] * 5 + [dict(five(10.0))] * 2 + [
        dict(five(10.0), ps_cpu={0: 9.8})] * 3
    init = {"speed": 5.0, "ps_cpu": {0: 4.0, 1: 2.0},
            "ps_memory": {0: 1e9, 1: 8e8}, "worker_cpu": {0: 0.3, 1: 0.3}}
    calm, spike = {"ps_cpu": {0: 3.0}}, {"ps_cpu": {0: 9.9}}

    def mk(speed, workers):
        return {"speed": speed,
                "worker_cpu": {i: 0.1 for i in range(workers)}}

    calls = [
        ("optimize_hot_ps_windowed", ([dict(hot)] * 3,
                                      {0: 10.0, 1: 10.0},
                                      {0: 5 * gib, 1: 5 * gib}, hot_cfg)),
        ("optimize_hot_ps_windowed", ([{"ps_cpu": {0: 9.0, 1: 50.0},
                                        "ps_memory": {},
                                        "worker_cpu": {0: 0.3}}] * 3,
                                      {0: 10.0, 1: 100.0}, {},
                                      {"hot_cpu_threshold": 0.8,
                                       "target_worker_count": 20})),
        ("hot_memory_nodes", ([{"ps_memory": {0: 9.5}}] * 3, {0: 10.0},
                              0.9)),
        ("hot_memory_nodes", ([{"ps_memory": {0: 9.5}},
                               {"ps_memory": {0: 1.0}},
                               {"ps_memory": {0: 9.5}}], {0: 10.0}, 0.9)),
        ("optimize_worker_resource_windowed",
         ([dict(one)] * 5 + [dict(five(10.0))] * 5, {0: 10.0}, dict(wcfg))),
        ("optimize_worker_resource_windowed",
         ([dict(one)] * 5 + [dict(five(5.0))] * 5, {0: 10.0}, dict(wcfg))),
        ("optimize_worker_resource_windowed",
         (exhausted, {0: 10.0}, dict(wcfg))),
        ("filter_singularities", ([calm, spike, calm, calm], {0: 10.0},
                                  0.8, 1, 0.15)),
        ("filter_singularities", ([calm, spike, spike, calm], {0: 10.0},
                                  0.8, 1, 0.15)),
        ("filter_singularities", ([{"ps_cpu": {0: 3.0, 1: 3.0}}] * 2
                                  + [{"ps_cpu": {0: 3.0}}],
                                  {0: 10.0, 1: 10.0}, 0.8, 1, 0.15)),
        ("training_speed_state", ([mk(8, 1)] * 3 + [mk(10, 5)] * 3, 3, 0.1)),
        ("training_speed_state", ([mk(8, 1)] * 3 + [mk(6, 5)] * 3, 3, 0.1)),
        ("training_speed_state", ([mk(8, 1)] * 3 + [mk(10, 5)], 3, 0.1)),
        ("node_avg_resources", ([dict(one), dict(five(3.0))], "worker_cpu")),
        ("node_max_resources", ([dict(one), dict(five(3.0))],
                                "worker_memory")),
        ("max_util", ({0: 6.0, 1: 9.0}, {0: 10.0, 1: 10.0})),
        ("hot_cpu_nodes", ([dict(hot)] * 3, {0: 10.0, 1: 10.0}, 0.8)),
    ]
    for fn, args in calls:
        want = getattr(jax_rt, fn)(*args)
        got = getattr(port_rt, fn)(*args)
        assert got == want, fn
    kw = {"config": {"ps_margin_cpu": 4, "target_worker_count": 32,
                     "step_count_threshold": 5, "total_steps": 1e6,
                     "ps_memory_margin_percent": 0.2},
          "model_feature": {"recv_op_count": 100}}
    want = jax_rt.optimize_ps_init_adjust_windowed([dict(init)] * 3, **kw)
    assert port_rt.optimize_ps_init_adjust_windowed([dict(init)] * 3,
                                                    **kw) == want
    assert want == {"ps_count": 3, "ps_cpu_cores": 8.0,
                    "ps_memory_mb": 1.2e9, "source": "windowed"}
    assert port_rt.optimize_ps_init_adjust_windowed(
        [{"speed": 0.0, "ps_cpu": {0: 4.0}, "ps_memory": {0: 1e9},
          "worker_cpu": {0: 0.3}}] * 3, config={}) is None


def test_datastore_matches_jax(tmp_path):
    out = {}
    for side, (store_mod, _a, _m) in SIDES.items():
        store = store_mod.MetricsStore(str(tmp_path / side / "b.sqlite"))
        for uuid, count in (("a", 4), ("b", 4), ("c", 8)):
            store.persist(uuid, "train-llama", {"worker_count": count},
                          timestamp=float(ord(uuid)))
        store.persist("x", "other-job", {"worker_count": 99}, timestamp=1.0)
        store.persist("a", "train-llama", {"speed": 6.0}, timestamp=200.0)
        out[side] = (store.job_records("a"),
                     store.similar_job_records("train-llama"))
        store.close()
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) == 3


@pytest.fixture
def brains():
    """Each package's brain service behind its own RPC server, and its
    own client."""
    from dlrover_tpu.brain import BrainClient as JaxClient
    from dlrover_tpu.brain import create_brain_service as jax_create
    from dlrover_tpu_torch.brain import BrainClient as PortClient
    from dlrover_tpu_torch.brain import create_brain_service as port_create

    made = {}
    for side, create, client_cls in (("jax", jax_create, JaxClient),
                                     ("port", port_create, PortClient)):
        server, service = create(0)
        server.start()
        made[side] = (client_cls(f"127.0.0.1:{server.port}"), service,
                      server)
    yield made
    for client, service, server in made.values():
        client.close()
        server.stop()
        service.store.close()


def test_service_answers_match_jax(brains):
    answers = {}
    for side, (client, service, _s) in brains.items():
        for uuid, count, mem in (("a", 4, 1000), ("b", 8, 2000),
                                 ("c", 6, 1500)):
            assert client.persist_metrics(
                uuid, "train-llama",
                {"worker_count": count, "used_memory_mb": mem})
        records = client.get_job_metrics("b")
        answers[side] = (
            client.optimize("new", "train-llama", "cold_create"),
            client.optimize("new", "train-llama", "nope"),
            client.optimize("b", "train-llama", "oom_memory",
                            {"memory_mb": 4096}),
            [{k: v for k, v in r.items() if k != "timestamp"}
             for r in records])
    assert answers["port"] == answers["jax"]
    assert answers["port"][0] == {"worker_count": 6, "memory_mb": 1950}


def test_services_are_not_wire_compatible(brains):
    """The JAX package's client against the port's brain (and the
    reverse): each side's restricted unpickler refuses the other's
    message classes, so the call fails and the non-critical client
    degrades to its no-op answers."""
    from dlrover_tpu.brain import BrainClient as JaxClient
    from dlrover_tpu_torch.brain import BrainClient as PortClient

    for client_cls, target in ((JaxClient, "port"), (PortClient, "jax")):
        server = brains[target][2]
        client = client_cls(f"127.0.0.1:{server.port}")
        try:
            assert client.persist_metrics("u", "j", {"speed": 1.0}) is False
            assert client.optimize("u", "j", "oom_memory",
                                   {"memory_mb": 4096}) is None
        finally:
            client.close()
        assert brains[target][1].store.job_records("u") == []


def test_resource_optimizer_and_reporter_over_the_port_master(brains):
    from dlrover_tpu.brain import BrainResourceOptimizer as JaxOptimizer
    from dlrover_tpu.common.constants import NodeType as JaxNodeType
    from dlrover_tpu.common.node import Node as JaxNode
    from dlrover_tpu.common.node import NodeResource as JaxNodeResource
    from dlrover_tpu_torch.brain import BrainReporter, BrainResourceOptimizer
    from dlrover_tpu_torch.common.constants import NodeType
    from dlrover_tpu_torch.common.node import Node, NodeResource
    from dlrover_tpu_torch.master.master import LocalJobMaster
    from dlrover_tpu_torch.scheduler.job import new_job_args

    plans_of = {}
    for side, opt_cls, node_cls, res_cls, ntype in (
            ("jax", JaxOptimizer, JaxNode, JaxNodeResource, JaxNodeType),
            ("port", BrainResourceOptimizer, Node, NodeResource, NodeType)):
        client, service, _s = brains[side]
        for uuid in ("a", "b"):
            service.store.persist(uuid, "train-x", {"worker_count": 4,
                                                    "used_memory_mb": 1000})
        opt = opt_cls(client, "new-job", "train-x")
        plan = opt.generate_opt_plan("initial", {})
        group = plan.node_group_resources[ntype.WORKER]
        node = node_cls(ntype.WORKER, 0,
                        config_resource=res_cls(memory=2048))
        node.name = "worker-0"
        oom = opt.generate_oom_recovery_plan([node], "stable")
        plans_of[side] = (group.count, group.node_resource.memory,
                          oom.node_resources["worker-0"].memory)
    assert plans_of["port"] == plans_of["jax"] == (4, 1300, 4096)

    client, _service, _s = brains["port"]
    master = LocalJobMaster(0, new_job_args("local", "brain-r", node_num=1))
    master.prepare()
    try:
        reporter = BrainReporter(
            client, "job-r", "reporter-job",
            job_manager=master.job_manager,
            speed_monitor=master.task_manager.speed_monitor)
        assert reporter.report_once()
        records = client.get_job_metrics("job-r")
        assert records and records[0]["status"] == "running"
        assert "worker_count" in records[0]
    finally:
        master.stop()


def test_cluster_monitor_matches_jax():
    class FakeClient:
        def list_pods(self, selector):
            def pod(job, uid, phase, oom=None):
                status = {"phase": phase}
                if oom:
                    status["containerStatuses"] = [{oom: {"terminated": {
                        "reason": "OOMKilled"}}}]
                return {"metadata": {"labels": {"elasticjob-name": job,
                                                "job-uid": uid}},
                        "status": status}

            return {"items": [pod("job-a", "ua", "Running"),
                              pod("job-a", "ua", "Failed", "lastState"),
                              pod("job-b", "ub", "Running"),
                              pod("job-c", "uc", "Failed", "state"),
                              {"metadata": {"labels": {}}}]}

    out = {}
    for side, mon in (("jax", jax_monitor), ("port", port_monitor)):
        snap = mon.snapshot_jobs(FakeClient())
        store = SIDES[side][0].MetricsStore()
        assert mon.ClusterMonitor(store, FakeClient(),
                                  interval=999).poll_once() == 3
        out[side] = (snap, [store.job_records(u)[0]
                            for u in ("ua", "ub", "uc")])
        store.close()
    for recs in (out["jax"][1], out["port"][1]):
        for rec in recs:
            rec.pop("timestamp")
    assert out["port"] == out["jax"]
    assert out["port"][0]["ua"]["oom"] == 1


def test_client_on_a_dead_address_costs_no_step():
    """tests/test_retry_policy.py's dead-brain case for the port: after
    the short budget is spent a few times the client disables itself,
    and its later calls are instant no-ops."""
    from dlrover_tpu_torch.brain.client import BrainClient
    from dlrover_tpu_torch.common import retry
    from dlrover_tpu_torch.common.retry import RetryPolicy
    from dlrover_tpu_torch.common.rpc import find_free_port

    retry.set_default_rpc_policy(RetryPolicy(
        max_attempts=1, base_delay=0.01, deadline=0.5, jitter=False))
    try:
        client = BrainClient(f"127.0.0.1:{find_free_port('127.0.0.1')}")
        for _ in range(3):
            assert client.persist_metrics("u", "j", {"s": 1}) is False
        assert client.degraded
        start = time.monotonic()
        assert client.optimize("u", "j", "cold_create") is None
        assert client.get_job_metrics("u") == []
        assert client.persist_metrics("u", "j", {"s": 1}) is False
        assert time.monotonic() - start < 0.1  # no socket attempts
        client.close()
    finally:
        retry.set_default_rpc_policy(None)


def test_brain_main_serves_and_imports_no_torch(tmp_path):
    """``python -m dlrover_tpu_torch.brain.main`` prints its address and
    serves a client over its sqlite file; the process imports no torch
    and nothing of JAX."""
    from dlrover_tpu_torch.brain import BrainClient

    db = tmp_path / "brain.sqlite"
    code = ("import runpy, sys, threading\n"
            "def guard():\n"
            "    import time; time.sleep(2)\n"
            "    bad = [m for m in sys.modules if m in ('torch', 'jax') or "
            "m.startswith('dlrover_tpu.')]\n"
            "    print('MODULES_BAD=' + ','.join(bad), flush=True)\n"
            "threading.Thread(target=guard, daemon=True).start()\n"
            "sys.argv = ['brain', '--port', '0', '--db', sys.argv[1]]\n"
            "runpy.run_module('dlrover_tpu_torch.brain.main', "
            "run_name='__main__')\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(db)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        addr = bad = None
        deadline = time.time() + 60
        while time.time() < deadline and (addr is None or bad is None):
            line = proc.stdout.readline()
            if line.startswith("DLROVER_BRAIN_ADDR="):
                addr = line.strip().split("=", 1)[1]
            elif line.startswith("MODULES_BAD="):
                bad = line.strip().split("=", 1)[1]
        assert addr and bad == "", (addr, bad)
        client = BrainClient(addr)
        assert client.persist_metrics("u1", "job", {"global_step": 5})
        assert client.get_job_metrics("u1")[0]["global_step"] == 5
        client.close()
        assert db.exists()
    finally:
        proc.kill()
        proc.wait(10)
