"""The port's cluster half held against the JAX package's on the CPU:
``scheduler/{rest_client,crd,kubernetes,operator,ray}.py``,
``master/{scaleplan_watcher,auto_scaler,resource}.py`` and
``DistributedJobMaster``.

Each scenario runs once per package against its own fake Kubernetes API
server (``tests/test_k8s_fake_api.py``'s ``FakeK8sApi``). Every request
the REST client sends is recorded as (method, path and query, JSON
body); the port must send the JAX package's requests with only these
two names mapped (``NAME_MAP``): a replica's accelerator resource
``google.com/tpu`` becomes ``nvidia.com/gpu``, and the master pod runs
``dlrover_tpu_torch.master.main``. The results the scenarios return
(pod names, parsed specs, scaling decisions) must be equal too. The
Ray backend is held only where it needs no ray: ray is not installed."""

import importlib
import json
import time
import urllib.parse
import urllib.request

import pytest

from tests.test_k8s_fake_api import FakeK8sApi

PACKAGES = ("dlrover_tpu", "dlrover_tpu_torch")
NAME_MAP = {
    "google.com/tpu": "nvidia.com/gpu",
    "dlrover_tpu.master.main": "dlrover_tpu_torch.master.main",
}


class Pkg:
    """One package's modules by short name: ``p.crd``, ``p.kubernetes``."""

    MODULES = {
        "crd": "scheduler.crd", "rest": "scheduler.rest_client",
        "kubernetes": "scheduler.kubernetes", "operator": "scheduler.operator",
        "ray": "scheduler.ray", "job": "scheduler.job",
        "watcher": "master.scaleplan_watcher", "auto": "master.auto_scaler",
        "resource": "master.resource", "jobs": "master.job_manager",
        "master": "master.master", "node": "common.node",
        "const": "common.constants", "client": "agent.master_client",
    }

    def __init__(self, name):
        self.name = name
        for attr, mod in self.MODULES.items():
            setattr(self, attr, importlib.import_module(f"{name}.{mod}"))


def as_json(obj, names=None):
    """``obj`` as decoded JSON (tuples become lists), with ``names``
    replaced: the JAX package's side takes ``NAME_MAP``."""
    text = json.dumps(obj)
    for old, new in (names or {}).items():
        text = text.replace(old, new)
    return json.loads(text)


@pytest.fixture
def recorder(monkeypatch):
    """Records every request the REST clients send, by API server."""
    calls: dict = {}
    real = urllib.request.urlopen

    def urlopen(req, *args, **kwargs):
        if isinstance(req, urllib.request.Request):
            url = urllib.parse.urlsplit(req.full_url)
            body = json.loads(req.data) if req.data else None
            path = url.path + (f"?{url.query}" if url.query else "")
            calls.setdefault(url.port, []).append(
                (req.get_method(), path, body))
        return real(req, *args, **kwargs)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return calls


def run_both(recorder, scenario, **kw):
    """``scenario(pkg, api, url)`` once per package against a fresh fake
    API; returns ``{package: (result, requests)}`` with the JAX side's
    names mapped."""
    out = {}
    for name in PACKAGES:
        api = FakeK8sApi()
        url = api.start()
        try:
            result = scenario(Pkg(name), api, url, **kw)
        finally:
            api.stop()
        requests = recorder.pop(urllib.parse.urlsplit(url).port, [])
        names = NAME_MAP if name == "dlrover_tpu" else None
        out[name] = (as_json(result, names), as_json(requests, names))
    return out


def wait(predicate, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return False


def assert_same(got, watch_gets=False):
    """Equal results and requests; with ``watch_gets`` the GETs of the
    long-poll watch and the periodic list loops (their number depends on
    timing) are compared as a set, everything else in order."""
    (jres, jreq), (pres, preq) = got["dlrover_tpu"], got["dlrover_tpu_torch"]
    assert pres == jres
    if watch_gets:
        split = [([r for r in reqs if r[0] != "GET"],
                  {(m, p) for m, p, _b in reqs if m == "GET"})
                 for reqs in (jreq, preq)]
        assert split[1] == split[0]
    else:
        assert preq == jreq
    assert preq


# ------------------------------------------------------- the REST client

def rest_and_crd(p, api, url):
    client = p.rest.RestK8sClient(base_url=url)
    out = [client.create_pod({"metadata": {"name": "p1",
                                           "labels": {"a": "b"}}})]
    out.append([i.metadata.name for i in client.list_pods("a=b").items])
    api.set_phase("p1", "Running", host_ip="10.0.0.9")
    pod = client.list_pods("a=b").items[0]
    out += [pod.status.phase, pod.status.host_ip, client.delete_pod("p1"),
            client.list_pods("a=b").items]
    spec = p.crd.ElasticJobSpec(job_name="llama", replica_specs={
        "worker": p.crd.ReplicaSpec(
            replicas=8, cpu=8, memory_mb=32768, tpu_chips=4, image="img",
            command=["tpu-run", "train.py"]),
        "master": p.crd.ReplicaSpec(cpu=2, memory_mb=4096)})
    out.append(client.create_custom_resource("elasticjobs",
                                             spec.to_manifest()))
    listed = client.list_custom_resources("elasticjobs")
    back = p.crd.ElasticJobSpec.from_manifest(listed[0])
    worker = back.replica_specs["worker"]
    out.append([worker.replicas, worker.cpu, worker.memory_mb,
                worker.tpu_chips, worker.command, spec.to_yaml()])
    out.append(client.update_custom_resource_status(
        "elasticjobs", "llama", {"phase": "Running"}))
    plan = p.crd.ScalePlanSpec(job_name="llama", name="llama-up",
                               replica_counts={"worker": 12},
                               node_resources={"worker-3": {"memory": "64Gi"}})
    out.append(client.create_custom_resource("scaleplans",
                                             plan.to_manifest()))
    out.append([client.delete_custom_resource("elasticjobs", "llama"),
                client.delete_custom_resource("elasticjobs", "llama")])
    out.append([p.crd.parse_cpu_quantity(v) for v in ("500m", "2", 4, "")])
    out.append([p.crd.parse_memory_quantity_mb(v)
                for v in ("32Gi", "512Mi", "2048Ki", 1 << 30, "")])
    return out


def test_rest_client_and_crd_send_the_jax_requests(recorder):
    got = run_both(recorder, rest_and_crd)
    assert_same(got)
    worker = got["dlrover_tpu_torch"][0][7]
    assert worker[3] == 4  # read back from the nvidia.com/gpu request
    assert '"nvidia.com/gpu": 4' in json.dumps(got["dlrover_tpu_torch"][1])


# ------------------------------------------------- pod scaler and watcher

def scale_watch_relaunch(p, api, url):
    W = p.const.NodeType.WORKER
    client = p.rest.RestK8sClient(base_url=url)
    scaler = p.kubernetes.PodScaler("job1", client)
    watcher = p.kubernetes.PodWatcher("job1", client)
    events = []
    try:
        scaler.scale({i: p.node.Node(W, i, rank_index=i) for i in range(2)})
        assert wait(lambda: len(api.pods) == 2)
        api.set_phase("job1-worker-0", "Running", "10.0.0.1")
        api.set_phase("job1-worker-1", "Running", "10.0.0.2")
        for ev in watcher.watch(timeout=1):
            events.append((ev.event_type, ev.node.id, ev.node.status,
                           ev.node.host_ip))
        api.delete("job1-worker-1")
        old = p.node.Node(W, 1, rank_index=1)
        old.name = "job1-worker-1"
        scaler.relaunch(old, p.node.Node(W, 2, rank_index=1))
        assert wait(lambda: "job1-worker-2" in api.pods)
        listed = sorted((n.name, n.id, n.rank_index, n.status)
                        for n in watcher.list())
        gone = p.node.Node(W, 0, rank_index=0)
        gone.name = "job1-worker-0"
        scaler.remove_node(gone)
        assert wait(lambda: "job1-worker-0" not in api.pods)
    finally:
        scaler.stop()
    return [events, listed, sorted(api.pods)]


def test_pod_scaler_and_watcher_send_the_jax_requests(recorder):
    assert_same(run_both(recorder, scale_watch_relaunch))


# ----------------------------------------------- ScalePlan CR -> the pods

def manual_scaleplan(p, api, url):
    W = p.const.NodeType.WORKER
    client = p.rest.RestK8sClient(base_url=url)
    scaler = p.kubernetes.PodScaler("job3", client)
    mgr = p.jobs.DistributedJobManager(
        p.job.new_job_args("local", "job3", node_num=1), scaler=scaler)
    with mgr._lock:
        mgr._job_nodes = {W: {0: p.node.Node(W, 0)}}
        mgr._next_node_id[W] = 1
    auto = p.auto.AllreduceTrainingAutoScaler(mgr, scaler=scaler,
                                              target_worker_num=1)

    def apply(plan):
        auto.execute_job_optimization_plan(plan)
        group = plan.node_group_resources.get(W)
        if group is not None:
            auto.on_group_count_applied(group.count)

    watcher = p.watcher.ScalePlanWatcher("job3", client, apply, interval=0.2)
    other = p.watcher.ScalePlanWatcher("jobA", client, lambda plan: None)
    try:
        manifest = p.crd.ScalePlanSpec(
            job_name="job3", name="job3-scale-up",
            replica_counts={W: 3}).to_manifest()
        client.create_custom_resource("scaleplans", manifest)
        client.create_custom_resource("scaleplans", p.crd.ScalePlanSpec(
            job_name="other-job", name="other-scale",
            replica_counts={W: 5}).to_manifest())
        out = [other.poll_once(), watcher.poll_once()]
        assert wait(lambda: len(api.pods) == 3)
        out += [sorted(api.pods), sorted(api.crs["scaleplans"]),
                watcher.poll_once(), auto._target_worker_num]
    finally:
        watcher.stop()
        scaler.stop()
    return out


def test_scaleplan_watcher_sends_the_jax_requests(recorder):
    got = run_both(recorder, manual_scaleplan)
    assert_same(got)
    assert got["dlrover_tpu_torch"][0][:2] == [0, 1]


# ------------------------------------------------------------ the operator

def operator_sweeps(p, api, url):
    client = p.rest.RestK8sClient(base_url=url)
    op = p.operator.ElasticJobOperator(client)
    for name, workers in (("jobA", 3), ("jobB", 2)):
        spec = p.crd.ElasticJobSpec(job_name=name, replica_specs={
            "worker": p.crd.ReplicaSpec(replicas=workers, tpu_chips=8),
            "master": p.crd.ReplicaSpec(cpu=2, memory_mb=2048)})
        client.create_custom_resource("elasticjobs", spec.to_manifest())
    out = [op.reconcile_once(), sorted(api.pods),
           api.pods["jobA-master"]["spec"]["containers"][0]["command"],
           op.reconcile_once()]
    client.update_custom_resource_status("elasticjobs", "jobB",
                                         {"phase": "Succeeded"})
    out += [op.reconcile_once(), sorted(api.pods)]
    client.delete_custom_resource("elasticjobs", "jobA")
    out += [op.reconcile_once(), sorted(api.pods)]
    return out


def test_operator_sends_the_jax_requests(recorder):
    got = run_both(recorder, operator_sweeps)
    assert_same(got)
    command = got["dlrover_tpu_torch"][0][2]
    assert command[:3] == ["python", "-m", "dlrover_tpu_torch.master.main"]


# ------------------------------------- DistributedJobMaster over REST

def distributed_master(p, api, url, monkeypatch, tmp_path):
    """``master/main.py``'s kubernetes path: the REST scheduler from
    ``DLROVER_TPU_K8S_API``, a ``DistributedJobMaster`` with a state
    store and an HTTP plane; its workers come up as pods, a worker
    reports the job's end, the supervision loop concludes and the
    master patches the ElasticJob CR's status."""
    monkeypatch.setenv("DLROVER_TPU_K8S_API", url)
    monkeypatch.setattr(p.const.JobConstant, "SECTION_LOOP_INTERVAL", 0.1)
    client = p.rest.RestK8sClient(base_url=url)
    client.create_custom_resource("elasticjobs", p.crd.ElasticJobSpec(
        job_name="djob").to_manifest())
    job_args = p.job.new_job_args("k8s", "djob", node_num=2)
    scaler, watcher = p.kubernetes.new_pod_scaler_and_watcher(job_args)
    master = p.master.DistributedJobMaster(
        0, job_args, scaler=scaler, watcher=watcher,
        state_dir=str(tmp_path / p.name), http_port=0)
    master.prepare()
    try:
        assert wait(lambda: len(api.pods) == 2)
        for i in range(2):
            api.set_phase(f"djob-worker-{i}", "Running", f"10.0.0.{i}")
        rpc = p.client.MasterClient(f"127.0.0.1:{master.port}", 0, "worker")
        rpc.report_job_end(True)
        rpc.close()
        rc = master.run()
    finally:
        scaler.stop()
    cr = api.crs["elasticjobs"]["djob"]
    return [rc, sorted(api.pods), cr["status"],
            master.scaleplan_watcher is not None, master.http_plane.port > 0,
            (tmp_path / p.name / "master_state.json").is_file()]


def test_distributed_job_master_sends_the_jax_requests(
        recorder, monkeypatch, tmp_path):
    got = run_both(recorder, distributed_master, monkeypatch=monkeypatch,
                   tmp_path=tmp_path)
    assert_same(got, watch_gets=True)
    rc, pods, status, *flags = got["dlrover_tpu_torch"][0]
    assert rc == 0 and pods == ["djob-worker-0", "djob-worker-1"]
    assert status == {"phase": "Succeeded", "reason": "Completed"}
    assert flags == [True, True, True]


# ------------------------------------------------ scaling decisions

def _manager(p, node_num, statuses=None):
    W = p.const.NodeType.WORKER
    mgr = p.jobs.DistributedJobManager(
        p.job.new_job_args("local", "scale-test", node_num=node_num))
    with mgr._lock:
        mgr._job_nodes = {W: {i: p.node.Node(W, i) for i in range(node_num)}}
        mgr._next_node_id[W] = node_num
    for node in mgr.get_job_nodes(W).values():
        node.update_status(p.const.NodeStatus.RUNNING)
    return mgr


def _alive(p, mgr):
    W, S = p.const.NodeType.WORKER, p.const.NodeStatus
    return sorted(i for i, n in mgr.get_job_nodes(W).items()
                  if not n.is_released and n.status not in S.end_states())


def _count(plan, p):
    if plan is None:
        return None
    group = plan.node_group_resources.get(p.const.NodeType.WORKER)
    return None if group is None else group.count


def _fail(p, node, fatal):
    node.update_status(p.const.NodeStatus.FAILED)
    if fatal:
        node.set_exit_reason(p.const.NodeExitReason.FATAL_ERROR)
    node.is_released = True


def plan_full(p):
    return _count(p.auto.AllreduceTrainingAutoScaler(
        _manager(p, 4), target_worker_num=4).plan(), p)


def plan_heal(p):
    mgr = _manager(p, 4)
    _fail(p, mgr.get_job_nodes(p.const.NodeType.WORKER)[3], fatal=False)
    return _count(p.auto.AllreduceTrainingAutoScaler(
        mgr, target_worker_num=4, node_unit=2).plan(), p)


def plan_fatal(p):
    mgr = _manager(p, 4)
    _fail(p, mgr.get_job_nodes(p.const.NodeType.WORKER)[3], fatal=True)
    return [_count(p.auto.AllreduceTrainingAutoScaler(
        mgr, target_worker_num=4, node_unit=unit).plan(), p)
        for unit in (2, 1)]


def plan_execute_out(p):
    mgr = _manager(p, 2)
    _fail(p, mgr.get_job_nodes(p.const.NodeType.WORKER)[1], fatal=False)
    scaler = p.auto.AllreduceTrainingAutoScaler(mgr, target_worker_num=2)
    scaler.execute_job_optimization_plan(scaler.plan())
    return _alive(p, mgr)


def plan_execute_in(p):
    mgr = _manager(p, 4)
    scaler = p.auto.AllreduceTrainingAutoScaler(mgr, target_worker_num=4)
    scaler.execute_job_optimization_plan(p.watcher.worker_count_plan(2))
    return [_alive(p, mgr), scaler._target_worker_num]


def plan_no_ratchet(p):
    mgr = _manager(p, 4)
    _fail(p, mgr.get_job_nodes(p.const.NodeType.WORKER)[3], fatal=True)
    scaler = p.auto.AllreduceTrainingAutoScaler(mgr, target_worker_num=4)
    for _ in range(5):
        plan = scaler.plan()
        if plan is not None:
            scaler.execute_job_optimization_plan(plan)
    return [scaler._target_worker_num, _alive(p, mgr)]


def plan_heuristic(p):
    R = p.resource
    out = []
    for unit, most, samples, phase in (
            (2, 8, [(4, 40.0)], R.OptimizePhase.SAMPLE),
            (4, 4, [(4, 40.0)], R.OptimizePhase.SAMPLE),
            (2, None, [(4, 100.0), (6, 80.0)], R.OptimizePhase.STABLE)):
        kw = {"node_unit": unit} if most is None else {
            "node_unit": unit, "max_nodes": most}
        opt = R.LocalHeuristicOptimizer(**kw)
        for n, speed in samples:
            opt.record_sample(n, speed)
        plan = opt.generate_opt_plan(phase, {})
        out.append(None if plan.empty() else _count(plan, p))
    node = p.node.Node(p.const.NodeType.WORKER, 0,
                       config_resource=p.node.NodeResource(memory=4096))
    node.name = "worker-0"
    oom = R.LocalHeuristicOptimizer().generate_oom_recovery_plan(
        [node], R.OptimizePhase.STABLE)
    out.append(oom.node_resources["worker-0"].memory)
    return out


def plan_ps_oom(p):
    mgr = _manager(p, 2)
    node = mgr.get_job_nodes(p.const.NodeType.WORKER)[0]
    node.name = "worker-0"
    node.config_resource = p.node.NodeResource(memory=1024)
    node.set_exit_reason(p.const.NodeExitReason.OOM)
    jro = p.resource.JobResourceOptimizer(
        p.resource.LocalHeuristicOptimizer(), sample_after_secs=1e9,
        stable_after_secs=1e9)
    scaler = p.auto.PSTrainingAutoScaler(mgr, jro)
    plan = scaler.plan()
    first = plan.node_resources["worker-0"].memory
    scaler.execute_job_optimization_plan(plan)
    return [first, node.config_resource.memory, scaler.plan().empty()]


PLANS = {f.__name__: f for f in (
    plan_full, plan_heal, plan_fatal, plan_execute_out, plan_execute_in,
    plan_no_ratchet, plan_heuristic, plan_ps_oom)}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_scaling_decisions_equal_jax(case):
    got = {name: PLANS[case](Pkg(name)) for name in PACKAGES}
    assert got["dlrover_tpu_torch"] == got["dlrover_tpu"]


def test_ray_backend_fails_as_jax_without_ray():
    errors = []
    for name in PACKAGES:
        ray = Pkg(name).ray
        assert ray.ray_available() is False
        with pytest.raises(ImportError) as err:
            ray.RayClient()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
