"""Parity of the port's ``ElasticSampler`` and ``ElasticDataLoader`` with
the JAX package's: the same seeded token dataset through both, for world
sizes 1, 2 and 3, shuffle on and off, ``drop_last`` on and off, a
mid-epoch ``state_dict``/``load_state_dict``, and a reshape from 2 ranks
to 3. Tolerance: none; the index sequences and the batches must be
identical, and across the reshape every sample of the epoch is served
exactly once."""

import numpy as np
import pytest

from dlrover_tpu.trainer.elastic.dataloader import (
    ElasticDataLoader as JaxLoader,
)
from dlrover_tpu.trainer.elastic.sampler import ElasticSampler as JaxSampler
from dlrover_tpu_torch.trainer.elastic import (
    ElasticDataLoader,
    ElasticSampler,
)

N = 53  # a prime: no world size or batch divides it
SEQ = 9
BATCH = 4


class TokenDataset:
    """Sample ``idx`` is RandomState(idx).randint(0, 1000, SEQ + 1), as
    the example's synthetic stream draws it."""

    def __len__(self):
        return N

    def __getitem__(self, idx):
        return np.random.RandomState(idx).randint(0, 1000, size=(SEQ + 1,),
                                                  dtype=np.int32)


def _collate(rows):
    return {"tokens": np.stack(rows)}


def _loaders(world, rank, shuffle, drop_last, seed=3):
    """(JAX loader, port loader) over the same dataset and sampler
    settings; the paral-config file is off ("")."""
    out = []
    for sampler_cls, loader_cls in ((JaxSampler, JaxLoader),
                                    (ElasticSampler, ElasticDataLoader)):
        sampler = sampler_cls(N, num_replicas=world, rank=rank,
                              shuffle=shuffle, seed=seed,
                              drop_last=drop_last)
        out.append(loader_cls(TokenDataset(), BATCH, sampler=sampler,
                              collate_fn=_collate, drop_last=drop_last,
                              config_file=""))
    return out


def _assert_same_batches(jax_batches, port_batches):
    assert len(jax_batches) == len(port_batches)
    for j, t in zip(jax_batches, port_batches):
        assert j.keys() == t.keys()
        np.testing.assert_array_equal(t["tokens"], j["tokens"])


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_indices_and_batches_match_jax(world, shuffle, drop_last):
    for epoch in (0, 1):
        for rank in range(world):
            jl, tl = _loaders(world, rank, shuffle, drop_last)
            jl.sampler.set_epoch(epoch)
            tl.sampler.set_epoch(epoch)
            assert list(tl.sampler) == list(jl.sampler)
            assert len(tl.sampler) == len(jl.sampler)
            assert len(tl) == len(jl)
            _assert_same_batches(list(jl), list(tl))
            assert tl.sampler.state_dict() == jl.sampler.state_dict()


@pytest.mark.parametrize("world", [1, 2, 3])
def test_mid_epoch_state_dict_resumes_like_jax(world):
    """Two batches on every rank, a state_dict, then a fresh loader that
    loads it: both packages continue with the same batches, and together
    with the first two they make the uninterrupted epoch."""
    for rank in range(world):
        jl, tl = _loaders(world, rank, shuffle=True, drop_last=True)
        whole = list(_loaders(world, rank, True, True)[1])
        head = []
        for loader in (jl, tl):
            it = iter(loader)
            head.append([next(it), next(it)])
        # every replica consumed 2 batches: the global count the
        # loader recorded on this rank
        assert tl.state_dict() == jl.state_dict()
        assert tl.state_dict()["sampler"]["completed_num"] == \
            2 * BATCH * world
        state = tl.state_dict()
        jl2, tl2 = _loaders(world, rank, shuffle=True, drop_last=True)
        jl2.load_state_dict(state)
        tl2.load_state_dict(state)
        tail_j, tail_t = list(jl2), list(tl2)
        _assert_same_batches(tail_j, tail_t)
        _assert_same_batches(head[0], head[1])
        _assert_same_batches(whole, head[1] + tail_t)


def test_reshape_two_to_three_serves_each_sample_once():
    """Two ranks take 3 batches each, then the world grows to 3: the
    remainder is re-sharded over the new world, the same in both
    packages, and the epoch's samples are served exactly once."""
    served = {"jax": [], "port": []}
    for name, pair_index in (("jax", 0), ("port", 1)):
        loaders = [_loaders(2, r, True, False)[pair_index] for r in range(2)]
        iters = [iter(l) for l in loaders]
        for _ in range(3):
            for it in iters:
                served[name].append(next(it)["tokens"])
        # each rank records the global consumption: 3 steps of 2
        # replicas x BATCH
        for loader in loaders:
            assert loader.sampler.completed_num == 3 * 2 * BATCH
        state = loaders[0].state_dict()
        grown = [_loaders(2, 0, True, False)[pair_index] for _ in range(3)]
        for r, loader in enumerate(grown):
            loader.load_state_dict(state)
            loader.reshape(3, r)
            served[name].extend(b["tokens"] for b in loader)
    for j, t in zip(served["jax"], served["port"]):
        np.testing.assert_array_equal(t, j)
    assert len(served["jax"]) == len(served["port"])
    rows = np.concatenate(served["port"])
    whole = np.stack([TokenDataset()[i] for i in range(N)])
    # each dataset row appears exactly once (rows are distinct draws)
    assert rows.shape == whole.shape
    keys = sorted(map(bytes, rows))
    assert keys == sorted(map(bytes, whole))
