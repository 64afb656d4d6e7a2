"""The port's node check held against the JAX package's on the CPU.

``run_node_check`` runs its legs in child processes, one per local rank:
here on gloo because the test asks for the CPU (``device="cpu"``); on a
GPU host each child takes one card and an NCCL group. Held: the legs
run and land in the per-rank file, ``MOCK_ERR_RANK`` fails the node in
both packages, a check asked to run on a card it does not find fails
instead of falling back to the CPU, and ``NodeCheckElasticAgent``
against each package's own master gives the same verdicts (a faulty
node isolated, an all-normal round passed). ``launch_agent``'s use of
the check is held in tests/test_torch_agent.py."""

import threading

import pytest

from dlrover_tpu.agent import master_client as jax_client
from dlrover_tpu.agent import node_check as jax_check
from dlrover_tpu.agent import training_agent as jax_agent
from dlrover_tpu.master import master as jax_master
from dlrover_tpu.scheduler import job as jax_job
from dlrover_tpu_torch.agent import master_client as port_client
from dlrover_tpu_torch.agent import node_check as port_check
from dlrover_tpu_torch.agent import training_agent as port_agent
from dlrover_tpu_torch.common.constants import NodeEnv, NodeType
from dlrover_tpu_torch.master import master as port_master
from dlrover_tpu_torch.scheduler import job as port_job

PACKAGES = {
    "jax": (jax_check, jax_agent, jax_master, jax_job, jax_client),
    "port": (port_check, port_agent, port_master, port_job, port_client),
}


@pytest.fixture(autouse=True)
def _check_dirs(tmp_path, monkeypatch):
    """Each package's per-rank files in this test's own directory; no
    injected fault unless a test sets one."""
    for name, (check, *_rest) in PACKAGES.items():
        monkeypatch.setattr(check, "CHECK_TIME_DIR", str(tmp_path / name))
    monkeypatch.delenv(NodeEnv.MOCK_ERR_RANK, raising=False)
    monkeypatch.setenv("DLROVER_PROBE_DISABLE", "1")


def test_run_node_check_on_gloo_when_the_cpu_is_asked_for():
    normal, elapsed = port_check.run_node_check(device="cpu", nprocs=2)
    assert normal and elapsed > 0
    record = port_check.read_time_from_file(0)
    assert record["normal"] is True and record["elapsed"] == elapsed
    legs = record["legs"]
    assert (legs["device"], legs["backend"], legs["world"]) == (
        "cpu", "gloo", 2)
    for leg in ("matmul_ms", "all_reduce_ms", "all_gather_ms"):
        assert legs[leg] > 0, legs


def test_a_missing_card_fails_the_check_without_a_cpu_fallback(
        monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    started = []
    monkeypatch.setattr(port_check.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    normal, _elapsed = port_check.run_node_check()
    assert not normal and started == []
    assert "legs" not in port_check.read_time_from_file(0)


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_mock_err_rank_fails_the_node(name, monkeypatch):
    check = PACKAGES[name][0]
    monkeypatch.setenv(NodeEnv.MOCK_ERR_RANK, "0")
    monkeypatch.setenv(NodeEnv.NODE_RANK, "0")
    kwargs = {"device": "cpu"} if name == "port" else {}
    normal, _elapsed = check.run_node_check(**kwargs)
    assert normal is False
    assert check.read_time_from_file(0)["normal"] is False


def test_time_file_contract_equals_jax():
    got = {}
    for name, (check, *_rest) in PACKAGES.items():
        assert check.read_time_from_file(3) is None
        check.write_time_to_file(1.25, False, 3)
        record = check.read_time_from_file(3)
        got[name] = (sorted(record), record["elapsed"], record["normal"])
    assert got["port"] == got["jax"]


def _master(pkgs, nodes):
    _check, _agent, master_mod, job_mod, _client = pkgs
    master = master_mod.LocalJobMaster(
        0, job_mod.new_job_args("local", "nc-test", node_num=nodes))
    master.prepare()
    return master


def _check_nodes(name, nodes, elapsed=None, faulty=()):
    """Run one ``NodeCheckElasticAgent`` per node rank in threads
    against the package's own master; with ``elapsed`` the payload is
    replaced by a fake that reports ``(rank not in faulty, elapsed)``.
    Returns each rank's verdict."""
    check, agent_mod, _m, _j, client_mod = pkgs = PACKAGES[name]
    master = _master(pkgs, nodes)
    results = {}

    def run(rank):
        config = agent_mod.ElasticLaunchConfig(
            min_nodes=nodes, max_nodes=nodes, nproc_per_node=1,
            node_rank=rank, rdzv_timeout=30, accelerator="cpu")
        client = client_mod.MasterClient(master.addr, rank, NodeType.WORKER)
        try:
            results[rank] = agent_mod.NodeCheckElasticAgent(
                config, client, rounds=2).run()
        finally:
            client.close()

    real = check.run_node_check
    if elapsed is not None:
        def fake(*_a, **_k):
            rank = int(threading.current_thread().name.split("-")[1])
            return rank not in faulty, elapsed
        check.run_node_check = fake
    try:
        threads = [threading.Thread(target=run, args=(r,), name=f"nc-{r}")
                   for r in range(nodes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in threads)
    finally:
        check.run_node_check = real
        master.stop()
    return results


@pytest.mark.parametrize("faulty", [(), (1,), (0, 1)])
def test_node_check_agents_give_the_jax_verdicts(faulty):
    got = {name: _check_nodes(name, 2, elapsed=0.5, faulty=faulty)
           for name in PACKAGES}
    assert got["port"] == got["jax"]
    assert got["port"] == {r: r not in faulty for r in range(2)}


def test_an_all_normal_round_passes_with_the_real_payload():
    got = {name: _check_nodes(name, 1) for name in PACKAGES}
    assert got == {"jax": {0: True}, "port": {0: True}}
    legs = port_check.read_time_from_file(0)["legs"]
    assert (legs["backend"], legs["world"]) == ("gloo", 1)

