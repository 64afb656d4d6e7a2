"""The port's master-served data (``IndexShardingClient`` and
``ElasticDataset``) held against the JAX package's on the CPU.

Each package's dataset reads from its own ``LocalJobMaster`` over the
real RPC plane; the shuffled shard order comes from the master's
splitter, seeded the same way (``random.seed``) for both. The index
streams, the shard boundaries the worker acknowledges, and the stream
after a mid-epoch shard checkpoint restored into a fresh master must be
equal (exactly: they are integers)."""

import random

import pytest

from dlrover_tpu.agent import master_client as jax_client
from dlrover_tpu.agent import sharding_client as jax_sharding
from dlrover_tpu.master import master as jax_master
from dlrover_tpu.scheduler import job as jax_job
from dlrover_tpu.trainer import elastic as jax_elastic
from dlrover_tpu_torch.agent import master_client as port_client
from dlrover_tpu_torch.agent import sharding_client as port_sharding
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.master import master as port_master
from dlrover_tpu_torch.scheduler import job as port_job
from dlrover_tpu_torch.trainer import elastic as port_elastic

PACKAGES = {
    "jax": (jax_master, jax_job, jax_client, jax_sharding, jax_elastic),
    "port": (port_master, port_job, port_client, port_sharding,
             port_elastic),
}
# (dataset size, batch, epochs, shuffle, minibatches per shard)
CASES = {
    "in-order": (32, 4, 1, False, 2),
    "shuffled-2-epochs": (45, 4, 2, True, 2),
    "ragged-tail": (50, 3, 1, True, 3),
}
SEED = 1234


class _Served:
    """A master and a client of one package, closed together."""

    def __init__(self, name):
        master_mod, job_mod, client_mod, self.sharding, self.elastic = (
            PACKAGES[name])
        self.master = master_mod.LocalJobMaster(
            0, job_mod.new_job_args("local", "ds-test", node_num=1))
        self.master.prepare()
        self.client = client_mod.MasterClient(self.master.addr, 0,
                                              NodeType.WORKER)

    def dataset(self, size, batch, epochs, shuffle, minibatches):
        class Rows(self.elastic.ElasticDataset):
            def read_sample(self, index):
                return index

        client = self.sharding.IndexShardingClient(
            dataset_name="train", batch_size=batch, num_epochs=epochs,
            dataset_size=size, shuffle=shuffle,
            num_minibatches_per_shard=minibatches,
            master_client=self.client)
        return Rows("train", size, batch, epochs, shuffle, minibatches,
                    client=client)

    def close(self):
        self.client.close()
        self.master.stop()


def read(ds, batch, limit=None) -> list:
    """Batches of indices until the master's stream ends (or ``limit``
    batches), acking the oldest pending shard task whenever the fetched
    rows are used up, and every pending one at the end of the stream (a
    batch may span two shards)."""
    batches = []
    while limit is None or len(batches) < limit:
        rows = []
        for _ in range(batch):
            try:
                rows.append(ds[0])
            except IndexError:
                break
        if not rows:
            ds.report_all_shards_done()
            break
        batches.append(rows)
        if ds._client._sample_queue.empty():
            ds.report_batch_done()
    return batches


@pytest.mark.parametrize("case", sorted(CASES))
def test_index_stream_equals_jax(case):
    size, batch, epochs, shuffle, minibatches = CASES[case]
    got = {}
    for name in PACKAGES:
        served = _Served(name)
        try:
            random.seed(SEED)
            ds = served.dataset(size, batch, epochs, shuffle, minibatches)
            got[name] = (read(ds, batch), len(ds),
                         served.master.task_manager.finished())
        finally:
            served.close()
    assert got["port"] == got["jax"]
    batches, length, finished = got["port"]
    rows = sorted(i for b in batches for i in b)
    assert rows == sorted(list(range(size)) * epochs)
    assert length == size and finished


@pytest.mark.parametrize("case", sorted(CASES))
def test_mid_epoch_shard_checkpoint_restores_as_jax(case):
    """Read some batches, take the shard checkpoint, restore it into a
    fresh master's dataset and read on: the same remaining stream in both
    packages, and with the rows read before it, every row of every epoch
    once."""
    size, batch, epochs, shuffle, minibatches = CASES[case]
    got = {}
    for name in PACKAGES:
        served = _Served(name)
        try:
            random.seed(SEED)
            ds = served.dataset(size, batch, epochs, shuffle, minibatches)
            head = read(ds, batch, limit=2 * minibatches)
            content = ds.get_shard_checkpoint()
        finally:
            served.close()
        fresh = _Served(name)
        try:
            random.seed(SEED + 1)
            ds = fresh.dataset(size, batch, epochs, shuffle, minibatches)
            assert ds.restore_shard_from_checkpoint(content)
            tail = read(ds, batch)
        finally:
            fresh.close()
        got[name] = (head, content, tail)
    assert got["port"] == got["jax"]
    head, _content, tail = got["port"]
    rows = sorted(i for b in head + tail for i in b)
    assert rows == sorted(list(range(size)) * epochs)
