"""The port's copies of the control plane held against the JAX package's
modules on the CPU: the same call sequence goes to both packages'
objects, and the results must be equal (exactly: nothing here is
floating point). Message classes differ by package, so results are
compared as decoded fields, never as bytes."""

import dataclasses
import random

import pytest

from dlrover_tpu.agent import master_client as jax_client
from dlrover_tpu.agent import training_agent as jax_agent
from dlrover_tpu.master import kvstore as jax_kvstore
from dlrover_tpu.master import master as jax_master
from dlrover_tpu.master import rendezvous as jax_rdzv
from dlrover_tpu.master.shard import dataset_splitter as jax_splitter
from dlrover_tpu.master.shard import task_manager as jax_tasks
from dlrover_tpu.scheduler import job as jax_job
from dlrover_tpu_torch.agent import master_client as port_client
from dlrover_tpu_torch.agent import training_agent as port_agent
from dlrover_tpu_torch.common.constants import NodeType, RendezvousName
from dlrover_tpu_torch.master import kvstore as port_kvstore
from dlrover_tpu_torch.master import master as port_master
from dlrover_tpu_torch.master import rendezvous as port_rdzv
from dlrover_tpu_torch.master.shard import dataset_splitter as port_splitter
from dlrover_tpu_torch.master.shard import task_manager as port_tasks
from dlrover_tpu_torch.scheduler import job as port_job

PACKAGES = {
    "jax": dict(rdzv=jax_rdzv, kv=jax_kvstore, splitter=jax_splitter,
                tasks=jax_tasks, master=jax_master, job=jax_job,
                client=jax_client, agent=jax_agent),
    "port": dict(rdzv=port_rdzv, kv=port_kvstore, splitter=port_splitter,
                 tasks=port_tasks, master=port_master, job=port_job,
                 client=port_client, agent=port_agent),
}


def fields(obj):
    """A message or a result as plain data: dataclasses become dicts of
    their fields, so the two packages' classes compare by content."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: fields(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [fields(v) for v in obj]
    return obj


def both(run):
    """``run(package modules)`` for the JAX package and the port; the
    two results must be equal. Returns the port's."""
    got = {name: fields(run(mods)) for name, mods in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# ------------------------------------------------------------ rendezvous

# (min, max, node_unit, joins); a join is (rank, local world, verified
# checkpoint steps), and a None entry polls every joined rank's world
RDZV_CASES = {
    "one-node": (1, 1, 1, [(0, 1, [])]),
    "two-nodes-consensus": (2, 2, 1, [(0, 2, [6, 4, 2]), (1, 2, [4, 2]),
                                      None]),
    "elastic-rejoin": (1, 3, 1, [(0, 1, [2]), (1, 2, [2]), None,
                                 (2, 1, []), None, (1, 2, [8, 2]), None]),
    "node-unit-2": (2, 4, 2, [(0, 1, []), (1, 1, []), (2, 1, []),
                              None]),
}


@pytest.mark.parametrize("case", sorted(RDZV_CASES))
def test_rendezvous_forms_the_same_world(case):
    """The same joins give the same formed world, rank offsets, restore
    step consensus and verdicts."""
    lo, hi, unit, joins = RDZV_CASES[case]

    def run(m):
        mgr = m["rdzv"].ElasticTrainingRendezvousManager()
        mgr.update_rdzv_params(min_nodes=lo, max_nodes=hi,
                               waiting_timeout=0.0, node_unit=unit)
        out, joined = [], []
        for join in joins:
            if join is None:
                for rank in sorted(set(joined)):
                    rnd, group, world, coord = mgr.get_comm_world(rank)
                    out.append((rank, rnd, group, world, coord,
                                m["agent"].world_rank_offset(world, rank)
                                if world else None))
                out.append((mgr.consensus_restore_step(),
                            mgr.round_verdicts(), mgr.num_nodes_waiting()))
                continue
            rank, local, steps = join
            joined.append(rank)
            out.append(mgr.join_rendezvous(
                rank, local, "10.0.0.%d" % rank,
                verified_ckpt_step=steps[0] if steps else -1,
                verified_ckpt_steps=steps))
        return out

    both(run)


# ---------------------------------------------------------------- shards

@pytest.mark.parametrize("dataset_type", ["table", "text"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_splitter_shards_equal_for_a_seed(dataset_type, shuffle):
    def run(m):
        random.seed(1234)
        sp = m["splitter"].new_dataset_splitter(
            shuffle, 7, 50, 2, "d", dataset_type=dataset_type)
        epochs = []
        while not sp.epoch_finished():
            sp.create_shards()
            epochs.append([(s.name, s.start, s.end, s.record_indices)
                           for s in sp.get_shards()])
        return epochs

    assert len(both(run)) == 2


@pytest.mark.parametrize("dataset_type", ["table", "text"])
def test_task_manager_dispatch_and_requeue_equal(dataset_type):
    """Tasks handed out, a failed one requeued and handed out again, the
    shard checkpoint and the finished flag, for the same seed."""

    def run(m):
        random.seed(99)
        tm = m["tasks"].TaskManager()
        tm.new_dataset(batch_size=4, dataset_size=45, dataset_name="train",
                       num_epochs=2, shuffle=True,
                       num_minibatches_per_shard=2,
                       dataset_type=dataset_type)
        seen = []
        for i in range(40):
            task = tm.get_dataset_task(NodeType.WORKER, i % 2, "train")
            seen.append((task.task_id, task.shard.start, task.shard.end,
                         list(task.shard.record_indices or [])))
            if task.task_id < 0:
                break
            if i == 3:
                seen.append(tm.get_dataset_checkpoint("train"))
            # every fifth task fails once and goes back to the queue
            tm.report_dataset_task("train", task.task_id, i % 5 != 2)
        seen.append(tm.finished())
        return seen

    seen = both(run)
    assert seen[-1] is True


# ---------------------------------------------------------------- kvstore

def test_kvstore_and_sync_service_equal():
    def run(m):
        kv, sync = m["kv"].KVStoreService(), m["kv"].SyncService()
        out = [kv.get("missing")]
        kv.set("a", b"1")
        out += [kv.get("a"), kv.add("n", 3), kv.add("n", -1), kv.get("n"),
                kv.wait(["a", "n"], timeout=0.1),
                kv.wait(["a", "absent"], timeout=0.1),
                kv.delete("a"), kv.delete("a"), kv.export_state()]
        kv.clear()
        out.append(kv.export_state())
        for node in (0, 1):
            out.append(sync.join_sync("s", NodeType.WORKER, node))
        out += [sync.sync_finished("s"), sync.notify_barrier("s"),
                sync.sync_finished("s")]
        sync.remove_node(NodeType.WORKER, 1)
        out.append(sync.export_state())
        return out

    both(run)


# --------------------------------------------------------------- servicer

def test_servicer_round_trip_over_each_package_rpc():
    """A LocalJobMaster of each package behind its RpcServer, driven by
    its own MasterClient through the same calls: the decoded answers
    agree field by field."""

    def run(m):
        master = m["master"].LocalJobMaster(
            0, m["job"].new_job_args("local", "parity", node_num=1))
        master.prepare()
        client = m["client"].MasterClient(master.addr, 0, NodeType.WORKER)
        try:
            out = [client.ping()]
            client.report_dataset_shard_params(
                batch_size=4, num_epochs=1, dataset_size=32,
                dataset_name="train", num_minibatches_per_shard=2)
            task = client.get_task("train")
            out += [task, client.report_task_result("train", task.task_id,
                                                    "")]
            out.append(client.join_rendezvous(
                0, 1, RendezvousName.ELASTIC_TRAINING, verified_ckpt_step=4,
                verified_ckpt_steps=[4, 2]))
            world = client.get_comm_world(RendezvousName.ELASTIC_TRAINING, 0)
            out += [world, client.num_nodes_waiting(
                RendezvousName.ELASTIC_TRAINING)]
            out += [client.kv_store_set("k", b"v"), client.kv_store_get("k"),
                    client.kv_store_add("c", 2), client.kv_store_add("c", 5)]
            out += [client.report_elastic_run_config({"nproc_per_node": 1}),
                    client.get_elastic_run_config()]
            heartbeat = client.report_heart_beat(timestamp=1.0)
            out += [heartbeat.action, client.get_node_health(0).verdict,
                    client.report_global_step(3, timestamp=2.0),
                    client.join_sync("s"), client.sync_finished("s"),
                    client.report_job_end(True), master.servicer.job_ended,
                    master.servicer.job_success]
            return out
        finally:
            client.close()
            master.stop()

    out = both(run)
    assert out[0] is True and out[1]["shard"]["end"] == 8
    assert out[4]["world"] == {0: 1} and out[4]["restore_step"] == 4


def test_unported_master_options_name_item_6(tmp_path):
    """These options used to raise naming ROADMAP item 6; they now run
    through the port's own modules: a state store and an HTTP plane on
    each master, a ``DistributedJobMaster`` without a platform scaler,
    and the ``k8s`` platform failing as the JAX package's does where
    neither the kubernetes client nor an API endpoint exists."""
    from dlrover_tpu.master import main as jax_main
    from dlrover_tpu_torch.master import main as port_main

    args = port_job.new_job_args("local", "x", node_num=1)
    for cls in (port_master.LocalJobMaster,
                port_master.DistributedJobMaster):
        master = cls(0, args, state_dir=str(tmp_path / cls.__name__),
                     http_port=0)
        assert master.state_store is not None
        assert master.servicer.state_store is master.state_store
        master.http_plane.start()
        assert master.http_plane.port > 0
        master.stop()
        assert (tmp_path / cls.__name__ / "master_state.json").is_file()
    errors = []
    for main in (jax_main, port_main):
        with pytest.raises(RuntimeError) as err:
            main.main(["--platform", "k8s", "--port", "0"])
        errors.append(str(err.value))
    assert errors[0] == errors[1]
