"""The port's PS failover client against the port's master, mirroring
tests/test_elastic_ps_e2e.py: the version protocol, a sparse
KvEmbedding worker trained through a PS migration (held to the JAX
worker's losses on the same table and ids within 1e-5), and the
background monitor.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.ops.sparse_embedding import KvEmbedding as JaxKv
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.master.master import LocalJobMaster
from dlrover_tpu_torch.models.recsys import sigmoid_binary_cross_entropy
from dlrover_tpu_torch.ops.sparse_embedding import KvEmbedding
from dlrover_tpu_torch.scheduler.job import new_job_args
from dlrover_tpu_torch.trainer.elastic.ps_failover import (
    PsFailoverClient,
    PsFailoverMonitor,
)


@pytest.fixture
def master():
    m = LocalJobMaster(0, new_job_args("local", "ps-test", node_num=1))
    m.prepare()
    yield m
    m.stop()


def _client(master, node_id=0):
    return MasterClient(f"127.0.0.1:{master.port}", node_id, "worker")


def test_bump_and_resync(master):
    fo = PsFailoverClient(_client(master))
    changed, v = fo.ps_version_changed()
    assert not changed and v == 0
    master.elastic_ps_service.inc_global_cluster_version()
    changed, v = fo.ps_version_changed()
    assert changed and v == 1
    migrations = []
    assert fo.maybe_refresh(lambda old, new: migrations.append((old, new)))
    assert migrations == [(0, 1)] and fo.local_version == 1
    assert master.elastic_ps_service.all_workers_synced()
    assert not fo.maybe_refresh(lambda *a: migrations.append(a))
    assert len(migrations) == 1


DIM, CAPACITY, LR = 8, 64, 5e-2


def _jax_losses(raw_ids, labels, table0):
    """The JAX worker of test_elastic_ps_e2e.py, on ``table0``: 6 steps,
    a migration (export, re-import into a fresh table), 6 steps."""
    kv = {"kv": JaxKv(dim=DIM, capacity=CAPACITY)}
    table = {"t": jnp.asarray(table0)}
    dense = {"w": jnp.zeros((DIM, 1))}
    opt = optax.adam(LR)
    state = {"o": opt.init((table["t"], dense))}

    @jax.jit
    def step(table, dense, opt_state, slots, y):
        def loss_fn(params):
            t, d = params
            logits = (JaxKv.embed(t, slots) @ d["w"])[:, 0]
            return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, y))

        loss, grads = jax.value_and_grad(loss_fn)((table, dense))
        updates, opt_state = opt.update(grads, opt_state, (table, dense))
        table, dense = optax.apply_updates((table, dense), updates)
        return table, dense, opt_state, loss

    def train(n):
        out = []
        for _ in range(n):
            slots = kv["kv"].lookup_slots(raw_ids)
            table["t"], d, state["o"], loss = step(
                table["t"], dense, state["o"], jnp.asarray(slots),
                jnp.asarray(labels))
            dense.update(d)
            out.append(float(loss))
        return out

    first = train(6)
    ids, vecs, freqs = kv["kv"].export(table["t"])
    fresh = JaxKv(dim=DIM, capacity=CAPACITY)
    table["t"] = fresh.import_(fresh.init_table(jax.random.key(1)), ids,
                               vecs, freqs)
    kv["kv"] = fresh
    return first + train(6)


def test_worker_survives_ps_migration(master):
    """A CTR-style sparse worker trains through a version bump: the
    migration exports the embedding state and re-imports it into a fresh
    KvEmbedding (in place, into the table the optimizer holds); learned
    rows survive byte for byte, the loss keeps falling, the master sees
    every worker synced, and the losses are the JAX worker's."""
    fo = PsFailoverClient(_client(master))
    rs = np.random.RandomState(0)
    raw_ids = rs.randint(1000, 1016, size=(64,))
    labels = (raw_ids % 2).astype(np.float32)
    table0 = np.asarray(JaxKv(dim=DIM, capacity=CAPACITY).init_table(
        jax.random.key(0)))

    kv = {"kv": KvEmbedding(dim=DIM, capacity=CAPACITY)}
    table = torch.from_numpy(table0.copy()).requires_grad_()
    w = torch.zeros((DIM, 1), requires_grad=True)
    opt = torch.optim.Adam([table, w], lr=LR)
    y = torch.from_numpy(labels)

    def train_steps(n):
        out = []
        for _ in range(n):
            slots = torch.as_tensor(kv["kv"].lookup_slots(raw_ids))
            logits = (KvEmbedding.embed(table, slots) @ w)[:, 0]
            loss = sigmoid_binary_cross_entropy(logits, y).mean()
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            out.append(float(loss))
        return out

    migrated = []

    def on_migrate(old, new):
        ids, vecs, freqs = kv["kv"].export(table)
        fresh = KvEmbedding(dim=DIM, capacity=CAPACITY)
        assert fresh.import_(table, ids, vecs, freqs) is table
        kv["kv"] = fresh
        migrated.append((old, new, len(ids)))

    first = train_steps(6)
    before_ids, before_vecs, _ = kv["kv"].export(table)
    master.elastic_ps_service.inc_global_cluster_version()
    assert fo.maybe_refresh(on_migrate)
    assert migrated and migrated[0][2] == 16
    after_ids, after_vecs, _ = kv["kv"].export(table)
    order_b, order_a = np.argsort(before_ids), np.argsort(after_ids)
    np.testing.assert_array_equal(before_ids[order_b], after_ids[order_a])
    np.testing.assert_array_equal(before_vecs[order_b], after_vecs[order_a])
    second = train_steps(6)
    assert second[-1] < first[0], (first, second)
    assert master.elastic_ps_service.all_workers_synced()
    np.testing.assert_allclose(first + second,
                               _jax_losses(raw_ids, labels, table0),
                               rtol=0, atol=1e-5)


def test_background_monitor_refreshes(master):
    fo = PsFailoverClient(_client(master))
    events = []
    monitor = PsFailoverMonitor(
        fo, lambda old, new: events.append((old, new)), interval=0.1)
    monitor.start()
    try:
        master.elastic_ps_service.inc_global_cluster_version()
        deadline = time.time() + 20
        while not events and time.time() < deadline:
            time.sleep(0.05)
    finally:
        monitor.stop()
    assert events == [(0, 1)]
    assert master.elastic_ps_service.all_workers_synced()


def test_monitor_keeps_polling_after_a_failed_migration(master):
    """A migration callback that raises leaves the worker unsynced and
    is retried at the next poll."""
    fo = PsFailoverClient(_client(master))
    calls = []

    def flaky(old, new):
        calls.append((old, new))
        if len(calls) == 1:
            raise RuntimeError("placement not ready")

    monitor = PsFailoverMonitor(fo, flaky, interval=0.05)
    monitor.start()
    try:
        master.elastic_ps_service.inc_global_cluster_version()
        deadline = time.time() + 20
        while fo.local_version < 1 and time.time() < deadline:
            time.sleep(0.05)
    finally:
        monitor.stop()
    assert calls[:2] == [(0, 1), (0, 1)]
    assert master.elastic_ps_service.all_workers_synced()
