"""Parity of the port's ops/sparse_embedding.py with the JAX package's, on
the CPU: the same seeded calls go into both packages' ``IdMapper``,
``KvEmbedding`` and ``TieredKvEmbedding``, starting from the same table
bits, and every array they keep or return must be equal bit for bit (the
mapper's ids, slots, frequencies and free stack, the table and the aux
tensors, the slots a batch maps to, the counters, the host tier, export,
import and the state dicts). The port writes the table and the aux
tensors in place; the JAX package returns new arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import sparse_embedding as jse
from dlrover_tpu_torch.models import tiered_state_from_jax
from dlrover_tpu_torch.ops import sparse_embedding as tse


def _mapper_arrays(m):
    return (m._ids, m._slots, m._freqs, m._free[:m._n_free], m.capacity)


def _assert_mappers_equal(tm, jm):
    for a, b in zip(_mapper_arrays(tm), _mapper_arrays(jm)):
        np.testing.assert_array_equal(a, b)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------ IdMapper


def _mapper_ops(m, rs):
    """A seeded sequence of every IdMapper operation; returns what each
    call gave."""
    out = []
    for _ in range(6):
        ids = rs.randint(0, 300, size=(7, 5))
        out.append(m.lookup(ids, count=bool(rs.randint(2))))
    out.append(m.frequencies(np.arange(310)))
    out.append(m.resident_slots(rs.randint(0, 320, size=40)))
    out.append(m.evict_ids(rs.randint(0, 300, size=20)))
    out.append(m.evict_ids(rs.randint(0, 300, size=10), forget=True))
    out.append(m.coldest_residents(9, exclude=rs.randint(0, 300, size=30)))
    out.append(m.resident_by_frequency())
    m.set_frequencies(rs.randint(0, 400, size=12), rs.randint(0, 9, size=12))
    out.append(m.evict_under_threshold(3))
    m.grow(m.capacity + 37)
    out.append(m.lookup(rs.randint(300, 500, size=60)))
    out.append(m.slots_of(range(0, 500, 7)))
    out.append((len(m), m.free_slots()))
    return out


def test_id_mapper_matches_jax():
    tm, jm = tse.IdMapper(200), jse.IdMapper(200)
    got = _mapper_ops(tm, np.random.RandomState(3))
    want = _mapper_ops(jm, np.random.RandomState(3))
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        elif isinstance(g, (dict, list)):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)
    _assert_mappers_equal(tm, jm)
    # the state dict round-trips, in the array and the legacy layouts
    sd = jm.state_dict()
    back, jback = tse.IdMapper(1), jse.IdMapper(1)
    back.load_state_dict(sd)
    jback.load_state_dict(sd)
    _assert_mappers_equal(back, jback)
    legacy = {"capacity": 8, "slot_of": {4: 1, 9: 0},
              "freq": {4: 3, 9: 1, 11: 5}}
    ta, ja = tse.IdMapper(1), jse.IdMapper(1)
    ta.load_state_dict(legacy)
    ja.load_state_dict(legacy)
    _assert_mappers_equal(ta, ja)


@pytest.mark.parametrize("residents", [300, 9000])
def test_coldest_residents_matches_jax(residents):
    """Victim selection, through the stable sort (small) and the O(n)
    preselect (over 4096 candidates), with and without an exclusion."""
    rs = np.random.RandomState(residents)
    ids = rs.permutation(np.unique(rs.randint(0, 1 << 30,
                                              size=2 * residents)))[:residents]
    freqs = rs.randint(0, 50, size=residents)
    maps = [mod.IdMapper(residents) for mod in (tse, jse)]
    for m in maps:
        m.lookup(ids)
        m.set_frequencies(ids, freqs)
    exclude = ids[rs.randint(0, residents, size=residents // 3)]
    for k in (1, 17, residents // 2):
        for ex in (None, exclude):
            (ti, ts), (ji, js) = [m.coldest_residents(k, exclude=ex)
                                  for m in maps]
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(ts, js)


def test_capacity_exhaustion_mutates_nothing():
    tm = tse.IdMapper(4)
    tm.lookup(np.arange(3))
    before = [a.copy() for a in _mapper_arrays(tm)[:4]]
    with pytest.raises(RuntimeError, match="evict"):
        tm.lookup(np.arange(10, 13))
    for a, b in zip(_mapper_arrays(tm), before):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- KvEmbedding


def test_kv_embedding_matches_jax():
    jkv, tkv = jse.KvEmbedding(dim=4, capacity=32), tse.KvEmbedding(
        dim=4, capacity=32)
    jt = jkv.init_table(jax.random.key(0))
    tt = _t(jt)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 40, size=(6, 3))
    js, ts = jkv.lookup_slots(ids), tkv.lookup_slots(ids)
    np.testing.assert_array_equal(ts, js)
    # the gather and its gradient: zero rows wherever nothing was looked up
    tgt = rs.randn(6, 3, 4).astype(np.float32)

    def jloss(table):
        return jnp.sum((jse.KvEmbedding.embed(table, js) - tgt) ** 2)

    tt.requires_grad_()
    tloss = ((tse.KvEmbedding.embed(tt, ts) - _t(tgt)) ** 2).sum()
    tloss.backward()
    np.testing.assert_array_equal(
        tse.KvEmbedding.embed(tt, ts).detach().numpy(),
        np.asarray(jse.KvEmbedding.embed(jt, js)))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jax.grad(jloss)(jt)),
                               rtol=1e-6, atol=1e-6)
    untouched = np.setdiff1d(np.arange(32), js)
    assert not tt.grad.numpy()[untouched].any()
    tt = tt.detach()
    # import (in place), export with a frequency floor, evict (in place)
    new_ids = np.arange(100, 104)
    vecs = rs.randn(4, 4).astype(np.float32)
    jt = jkv.import_(jt, new_ids, vecs, freqs=np.array([1, 5, 2, 7]))
    assert tkv.import_(tt, new_ids, vecs,
                       freqs=np.array([1, 5, 2, 7])) is tt
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for floor in (0, 2):
        for a, b in zip(tkv.export(tt, floor), jkv.export(jt, floor)):
            np.testing.assert_array_equal(a, b)
    jt = jkv.evict(jt, threshold=2)
    assert tkv.evict(tt, threshold=2) is tt
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _assert_mappers_equal(tkv.mapper, jkv.mapper)


def test_init_table_takes_a_generator_and_device():
    kv = tse.KvEmbedding(dim=3, capacity=5, init_scale=0.5)
    a = kv.init_table(torch.Generator().manual_seed(1), "cpu")
    b = kv.init_table(torch.Generator().manual_seed(1))
    assert a.shape == (5, 3) and a.device.type == "cpu"
    assert torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            kv.init_table(torch.Generator().manual_seed(1), "cuda")


# ---------------------------------------------------- TieredKvEmbedding


def _tier_pair(capacity=32, dim=4, seed=1, dtype=None):
    jkv = jse.TieredKvEmbedding(dim=dim, capacity=capacity, seed=seed,
                                dtype=None if dtype is None else jnp.bfloat16)
    tkv = tse.TieredKvEmbedding(dim=dim, capacity=capacity, seed=seed,
                                dtype=dtype)
    jt = jkv.init_table(jax.random.key(0))
    tt = _t(np.asarray(jt).view(np.int16)).view(torch.bfloat16) \
        if dtype is torch.bfloat16 else _t(jt)
    return jkv, tkv, jt, tt


def _assert_tiers_equal(tkv, jkv, tt, jt):
    tb = tt.view(torch.int16) if tt.dtype == torch.bfloat16 else tt
    jb = np.asarray(jt)
    jb = jb.view(np.int16) if jb.dtype.name == "bfloat16" else jb
    np.testing.assert_array_equal(tb.numpy(), jb)
    _assert_mappers_equal(tkv.mapper, jkv.mapper)
    _assert_mappers_equal(tkv._host_map, jkv._host_map)
    jh = jkv._host_data
    jh = jh.view(np.int16) if jh.dtype.name == "bfloat16" else jh
    np.testing.assert_array_equal(tkv._host_data, jh)
    assert tkv.counters == jkv.counters
    assert tkv.host_ids == jkv.host_ids
    if jkv._host_aux is None:
        assert tkv._host_aux is None
    else:
        for a, b in zip(tkv._host_aux, jkv._host_aux):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_aux", [False, True])
def test_tiered_zipf_stream_matches_jax(with_aux):
    """A Zipf stream over a vocabulary 16x the table: demotions,
    promotions and fresh inserts every batch, eval batches between
    (count=False), aux rows (GroupAdam's steps, mu, nu) riding along."""
    jkv, tkv, jt, tt = _tier_pair(capacity=32, dim=4)
    rs = np.random.RandomState(5)
    vocab = np.arange(512, dtype=np.int64) * 131 + 5
    if with_aux:
        steps = rs.randint(0, 9, size=(32, 1)).astype(np.int32)
        mu = rs.randn(32, 4).astype(np.float32)
        nu = rs.rand(32, 4).astype(np.float32)
        jaux = [jnp.asarray(a) for a in (steps, mu, nu)]
        taux = [_t(a) for a in (steps, mu, nu)]
        ids_of = [id(a) for a in taux]
    for i in range(14):
        ranks = np.minimum(rs.zipf(1.3, size=(6, 4)), 512) - 1
        count = i % 4 != 3
        if with_aux:
            jt, jslots, jaux = jkv.prepare_batch(jt, vocab[ranks], count=count,
                                                 aux=jaux)
            got = tkv.prepare_batch(tt, vocab[ranks], count=count, aux=taux)
            assert got[0] is tt and [id(a) for a in got[2]] == ids_of
            tslots = got[1]
            for a, b in zip(taux, jaux):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            jt, jslots = jkv.prepare_batch(jt, vocab[ranks], count=count)
            tt2, tslots = tkv.prepare_batch(tt, vocab[ranks], count=count)
            assert tt2 is tt
        np.testing.assert_array_equal(tslots, jslots)
        assert tslots.dtype == np.asarray(jslots).dtype
        assert (tkv.mapper.resident_slots(vocab[ranks]) >= 0).all()
        _assert_tiers_equal(tkv, jkv, tt, jt)
    assert tkv.counters["demoted_rows"] > 0
    assert tkv.counters["promoted_rows"] > 0
    assert tkv.counters["fresh_rows"] > 0
    # export, evict, export again and the state dicts: equal throughout
    for a, b in zip(tkv.export(tt, 2), jkv.export(jt, 2)):
        np.testing.assert_array_equal(a, b)
    jt = jkv.evict(jt, threshold=3)
    tkv.evict(tt, threshold=3)
    _assert_tiers_equal(tkv, jkv, tt, jt)
    for a, b in zip(tkv.export(tt), jkv.export(jt)):
        np.testing.assert_array_equal(a, b)
    ts, js = tkv.state_dict(), jkv.state_dict()
    # the port's state adds the fresh-row generator's position
    assert ts.pop("rng")[0] == "MT19937"
    assert sorted(ts) == sorted(js)
    for a, b in zip(jax.tree.leaves(ts), jax.tree.leaves(js)):
        np.testing.assert_array_equal(a, b)


def test_tier_grows_as_jax_does():
    """A host tier smaller than the spill doubles, aux stores with it."""
    kw = dict(dim=2, capacity=4, seed=0, host_capacity=3)
    jkv, tkv = jse.TieredKvEmbedding(**kw), tse.TieredKvEmbedding(**kw)
    jt = jkv.init_table(jax.random.key(0))
    tt = _t(jt)
    jmu, tmu = jnp.zeros((4, 2)), torch.zeros(4, 2)
    for start in range(0, 40, 4):
        ids = np.arange(start, start + 4)
        jt, _, (jmu,) = jkv.prepare_batch(jt, ids, aux=[jmu])
        tkv.prepare_batch(tt, ids, aux=[tmu])
    assert tkv._host_capacity == jkv._host_capacity > 3
    _assert_tiers_equal(tkv, jkv, tt, jt)


def test_import_fills_device_then_spills_like_jax():
    jkv, tkv, jt, tt = _tier_pair(capacity=4, dim=2)
    vals = np.random.RandomState(7).randn(10, 2).astype(np.float32)
    freqs = np.arange(10) + 1
    jt = jkv.import_(jt, np.arange(10), vals, freqs=freqs)
    tkv.import_(tt, np.arange(10), vals, freqs=freqs)
    assert tkv.host_ids == 6
    _assert_tiers_equal(tkv, jkv, tt, jt)
    # a tensor of vectors (on any device) imports the same
    t2 = tse.TieredKvEmbedding(dim=2, capacity=4, seed=1)
    tt2 = _t(np.zeros((4, 2), np.float32))
    t2.import_(tt2, np.arange(10), torch.from_numpy(vals), freqs=freqs)
    for a, b in zip(t2.export(tt2), tkv.export(tt)):
        np.testing.assert_array_equal(a, b)


def test_demote_promote_bit_identical():
    jkv, tkv, jt, tt = _tier_pair(capacity=4, dim=2)
    vals = np.random.RandomState(7).randn(4, 2).astype(np.float32)
    tkv.import_(tt, np.arange(4), vals)
    # a fresh batch demotes ALL residents; then promote them back
    tkv.prepare_batch(tt, np.array([900, 901, 902, 903]))
    assert tkv.host_ids == 4
    _, slots = tkv.prepare_batch(tt, np.arange(4))
    got = tse.KvEmbedding.embed(tt, slots).numpy()
    np.testing.assert_array_equal(got, vals)


def test_spill_preserves_bf16_bits():
    """A bfloat16 table's rows round-trip demote -> promote bit for bit
    (kept on the host as int16 patterns), as the JAX package's do."""
    jkv, tkv, jt, tt = _tier_pair(capacity=4, dim=4, seed=0,
                                  dtype=torch.bfloat16)
    before = tt.clone()
    for kv in (jkv, tkv):
        kv.mapper.lookup(np.arange(4))
    jt, _ = jkv.prepare_batch(jt, np.array([10, 11, 12, 13]))
    tkv.prepare_batch(tt, np.array([10, 11, 12, 13]))
    np.testing.assert_array_equal(tkv._host_data,
                                  jkv._host_data.view(np.int16))
    jt, _ = jkv.prepare_batch(jt, np.arange(4))
    _, slots = tkv.prepare_batch(tt, np.arange(4))
    assert tt.dtype == torch.bfloat16
    assert torch.equal(tse.KvEmbedding.embed(tt, slots).view(torch.int16),
                       before[:4].view(torch.int16))
    # the JAX state dict loads into the port through the converter
    back = tse.TieredKvEmbedding(dim=4, capacity=4, dtype=torch.bfloat16)
    back.load_state_dict(tiered_state_from_jax(jkv.state_dict()))
    np.testing.assert_array_equal(back.state_dict()["host_rows"],
                                  tkv.state_dict()["host_rows"])


def test_aux_rows_follow_demote_promote():
    """Slot-aligned optimizer state relocates WITH the rows: a promoted
    id gets its own spilled moments back, never the previous occupant's;
    fresh ids get zeros; the state dict round-trips the spilled aux."""
    kv = tse.TieredKvEmbedding(dim=2, capacity=4, seed=0)
    table = kv.init_table(torch.Generator().manual_seed(0), "cpu")
    mu = torch.arange(8, dtype=torch.float32).reshape(4, 2) * 10
    kv.mapper.lookup(np.arange(4))  # ids 0..3 -> slots 0..3
    mu_before = mu.clone()
    kv.prepare_batch(table, np.array([10, 11, 12, 13]), aux=[mu])
    _, slots, (mu2,) = kv.prepare_batch(table, np.arange(4), aux=[mu])
    assert mu2 is mu
    assert torch.equal(mu[torch.as_tensor(slots, dtype=torch.long)],
                       mu_before)
    _, slots2, _ = kv.prepare_batch(table, np.array([20, 21]), aux=[mu])
    assert not mu[torch.as_tensor(slots2, dtype=torch.long)].any()
    kv2 = tse.TieredKvEmbedding(dim=2, capacity=4)
    kv2.load_state_dict(kv.state_dict())
    assert kv2._host_aux is not None
    kv2.prepare_batch(table, np.array([10]), aux=[mu])


def test_preparer_relocates_optimizer_moments():
    """TieredBatchPreparer finds the [capacity, ...] tensors of the
    table's optimizer state (GroupAdam's steps, mu, nu; never another
    param's) and moves them with the rows, in place."""
    from dlrover_tpu_torch.models import (
        RecsysConfig,
        TieredBatchPreparer,
        make_tiered_embedding,
    )
    from dlrover_tpu_torch.optimizers import group_adam

    @dataclasses.dataclass
    class State:
        step: int
        params: dict
        optimizer: torch.optim.Optimizer

    cfg = RecsysConfig(dim=2, device_capacity=4, fields=1)
    kv = make_tiered_embedding(cfg)
    table = kv.init_table(torch.Generator().manual_seed(0), "cpu")
    table.requires_grad_()
    # w1's leading dim is the capacity too: only the table's state moves
    w1 = torch.zeros((4, 3), requires_grad=True)
    opt = group_adam(1e-2)([table, w1])
    st = opt.state[table]
    st["mu"].copy_(torch.arange(8, dtype=torch.float32).reshape(4, 2))
    st["nu"].copy_(st["mu"] * 100)
    st["steps"].copy_(torch.arange(4, dtype=torch.int32).reshape(4, 1) + 1)
    opt.state[w1]["mu"].fill_(1.0)
    before = {k: v.clone() for k, v in st.items()}
    state = State(step=0, params={"table": table, "w1": w1}, optimizer=opt)
    prep = TieredBatchPreparer(kv)
    assert [t is st[k] for t, k in zip(
        prep.aux_tensors(opt, table), ("steps", "mu", "nu"))] == [True] * 3
    kv.mapper.lookup(np.arange(4))  # fill slots 0..3
    state, _ = prep(state, {"ids": np.array([[10], [11], [12], [13]])})
    state, b2 = prep(state, {"ids": np.array([[2]])})
    assert state.params["table"] is table
    slot = int(np.asarray(b2["slots"]).reshape(-1)[0])
    for key in ("steps", "mu", "nu"):
        assert torch.equal(opt.state[table][key][slot], before[key][2]), key
    assert opt.state[table]["steps"].dtype == torch.int32
    assert torch.equal(opt.state[w1]["mu"], torch.ones(4, 3))


def test_preparer_matches_jax_with_adam_moments():
    """The preparer's aux choice against JAX's path rule on an optax adam
    state: torch AdamW's exp_avg/exp_avg_sq are optax's mu/nu."""
    from dlrover_tpu.models import TieredBatchPreparer as JaxPreparer
    from dlrover_tpu_torch.models import TieredBatchPreparer

    @dataclasses.dataclass
    class JState:
        step: int
        params: dict
        opt_state: tuple

    @dataclasses.dataclass
    class TState:
        step: int
        params: dict
        optimizer: torch.optim.Optimizer

    import optax

    jkv, tkv, jt, tt = _tier_pair(capacity=8, dim=2)
    tt.requires_grad_()
    jparams = {"table": jt}
    jopt = optax.adam(1e-2).init(jparams)
    topt = torch.optim.AdamW([tt], lr=1e-2, weight_decay=0.0)
    from dlrover_tpu_torch.trainer.optim import materialize_optimizer_state

    materialize_optimizer_state(topt)
    rs = np.random.RandomState(2)
    mu = rs.randn(8, 2).astype(np.float32)
    nu = rs.rand(8, 2).astype(np.float32)
    jopt = (jopt[0]._replace(mu={"table": jnp.asarray(mu)},
                             nu={"table": jnp.asarray(nu)}),) + jopt[1:]
    topt.state[tt]["exp_avg"].copy_(_t(mu))
    topt.state[tt]["exp_avg_sq"].copy_(_t(nu))
    js = JState(0, jparams, jopt)
    ts = TState(0, {"table": tt}, topt)
    jp, tp = JaxPreparer(jkv), TieredBatchPreparer(tkv)
    for _ in range(6):
        ids = rs.randint(0, 40, size=(3, 2))
        js, jb = jp(js, {"ids": ids, "labels": np.ones(3, np.float32)})
        ts, tb = tp(ts, {"ids": ids, "labels": np.ones(3, np.float32)})
        np.testing.assert_array_equal(tb["slots"], np.asarray(jb["slots"]))
        assert "ids" not in tb and tb["labels"] is not None
    np.testing.assert_array_equal(tt.detach().numpy(),
                                  np.asarray(js.params["table"]))
    np.testing.assert_array_equal(topt.state[tt]["exp_avg"].numpy(),
                                  np.asarray(js.opt_state[0].mu["table"]))
    np.testing.assert_array_equal(topt.state[tt]["exp_avg_sq"].numpy(),
                                  np.asarray(js.opt_state[0].nu["table"]))
    for a, b in zip(tkv._host_aux, jkv._host_aux):
        np.testing.assert_array_equal(a, b)


def test_legacy_dict_state_loads():
    legacy = {
        "mapper": {"capacity": 4, "slot_of": {0: 0, 1: 1},
                   "freq": {0: 5, 1: 1, 7: 2}},
        "host_store": {7: np.array([1.5, 2.5], np.float32)},
    }
    kv = tse.TieredKvEmbedding(dim=2, capacity=4)
    kv.load_state_dict(tiered_state_from_jax(legacy))
    assert kv.host_ids == 1
    assert kv.mapper.frequencies(np.array([0, 1, 7])).tolist() == [5, 1, 2]
    table = torch.zeros(4, 2)
    _, slots = kv.prepare_batch(table, np.array([7]))
    got = tse.KvEmbedding.embed(table, slots)[0]
    assert got.tolist() == [1.5, 2.5]


def test_jax_state_dict_restores_into_the_port():
    """A JAX tier's state (mapper, host rows, host aux) loaded into the
    port through the converter continues exactly as the JAX tier does."""
    jkv, tkv, jt, tt = _tier_pair(capacity=8, dim=3)
    rs = np.random.RandomState(9)
    jmu = jnp.zeros((8, 3))
    for _ in range(5):
        jt, _, (jmu,) = jkv.prepare_batch(jt, rs.randint(0, 60, size=5),
                                          aux=[jmu])
    tkv.load_state_dict(tiered_state_from_jax(jkv.state_dict()))
    tt = _t(jt)
    tmu = _t(jmu)
    jkv2 = jse.TieredKvEmbedding(dim=3, capacity=8, seed=1)
    jkv2.load_state_dict(jkv.state_dict())
    for _ in range(5):
        ids = rs.randint(0, 60, size=5)
        jt, js, (jmu,) = jkv2.prepare_batch(jt, ids, aux=[jmu])
        _, ts, _ = tkv.prepare_batch(tt, ids, aux=[tmu])
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tmu.numpy(), np.asarray(jmu))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_host_map_keys_stay_bounded():
    kv = tse.TieredKvEmbedding(dim=4, capacity=8, seed=0)
    table = kv.init_table(torch.Generator().manual_seed(0), "cpu")
    rs = np.random.RandomState(0)
    for _ in range(30):
        ids = rs.choice(64, size=6, replace=False).astype(np.int64)
        kv.prepare_batch(table, ids)
        assert kv._host_map._ids.size == kv.host_ids
    assert kv.counters["promoted_rows"] > 0
    assert kv.host_bytes() == kv._host_data.nbytes
