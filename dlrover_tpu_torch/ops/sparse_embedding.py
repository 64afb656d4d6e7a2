"""KvEmbedding: dynamic sparse embedding tables (port of
dlrover_tpu/ops/sparse_embedding.py).

The device side is a fixed-capacity ``[capacity, dim]`` table, a
parameter like any other; a lookup is ``F.embedding`` over slots, whose
backward leaves a dense gradient with zero rows wherever nothing was
looked up (what ``GroupAdam``'s row mask reads). The dynamic part lives on
the host: :class:`IdMapper` (numpy, copied from the JAX package as it is)
assigns raw feature ids to table slots on first sight, tracks per-id
frequencies and evicts cold ids to recycle slots. Export/import
round-trips (id, vector, freq) triples with under-threshold filtering.

Where the JAX package returns new arrays, the port writes the table and
the optimizer tensors that ride with it IN PLACE (``index_copy_`` under
``torch.no_grad()``): the optimizer holds the ``Parameter`` and its state
tensors by identity, and a replaced tensor would train on unseen. The
JAX package pads its gathers and scatters to powers of two to bound its
jit variants; eager torch needs no padding, so the port gathers and
scatters exactly the rows it moves (the same rows, the same bits).

A table in a dtype numpy lacks (``bfloat16``) keeps its spilled rows on
the host as their raw 16-bit patterns (``int16``), so that a demote ->
promote round-trip is bit-identical, as the JAX package's is.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.device import resolve_device

logger = get_logger(__name__)

# torch dtypes numpy has no type for: their host rows are bit patterns
_BITS = {torch.bfloat16: torch.int16}


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype the host tier stores rows of ``dtype`` in."""
    return torch.empty((), dtype=_BITS.get(dtype, dtype)).numpy().dtype


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host in their :func:`_host_dtype`."""
    t = t.detach().cpu()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.numpy()


def _to_device(a, dtype: torch.dtype, device) -> torch.Tensor:
    """Host rows (numpy in :func:`_host_dtype`, or a tensor) as a tensor
    of ``dtype`` on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    a = np.ascontiguousarray(a)
    if dtype in _BITS and a.dtype == _host_dtype(dtype):
        return torch.from_numpy(a).view(dtype).to(device)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _index(slots, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(slots, np.int64), device=device)


_EMPTY_I64 = np.zeros((0,), np.int64)
_EMPTY_I32 = np.zeros((0,), np.int32)


class IdMapper:
    """Host-side id -> slot assignment with frequencies and eviction.

    Storage is three aligned contiguous arrays — ``_ids`` (sorted int64
    keys), ``_slots`` (int32, -1 = known id without a device slot, e.g.
    demoted to a host tier) and ``_freqs`` (int64) — plus a LIFO free-
    slot stack. Every operation is a batched numpy set-op; nothing
    iterates ids in Python.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ids = _EMPTY_I64
        self._slots = _EMPTY_I32
        self._freqs = _EMPTY_I64
        # LIFO stack: _free[:_n_free] are free slots; popping from the
        # end yields ascending slot numbers on a fresh mapper
        self._free = np.arange(self.capacity - 1, -1, -1, dtype=np.int32)
        self._n_free = self.capacity

    def __len__(self):
        with self._lock:
            return int((self._slots >= 0).sum())

    # ------------------------------------------------- internal (lock held)

    def _positions(self, keys: np.ndarray):
        """(pos, found): searchsorted positions of ``keys`` in ``_ids``
        and a mask of which are present. ``keys`` need not be sorted."""
        if self._ids.size == 0:
            return np.zeros(keys.shape, np.int64), np.zeros(keys.shape, bool)
        pos = np.searchsorted(self._ids, keys)
        found = (pos < self._ids.size) & (
            self._ids[np.minimum(pos, self._ids.size - 1)] == keys
        )
        return pos, found

    def _insert_keys(self, new_keys: np.ndarray):
        """Insert sorted unique keys (none present) with slot=-1, freq=0."""
        ipos = np.searchsorted(self._ids, new_keys)
        self._ids = np.insert(self._ids, ipos, new_keys)
        self._slots = np.insert(self._slots, ipos, np.int32(-1))
        self._freqs = np.insert(self._freqs, ipos, np.int64(0))

    def _push_free(self, slots: np.ndarray):
        n = slots.size
        self._free[self._n_free:self._n_free + n] = slots
        self._n_free += n

    def _pop_free(self, k: int) -> np.ndarray:
        """Pop ``k`` slots in the same order repeated ``list.pop()`` gave."""
        take = self._free[self._n_free - k:self._n_free][::-1].copy()
        self._n_free -= k
        return take

    # ------------------------------------------------------------ queries

    def lookup(self, ids: np.ndarray, count: bool = True) -> np.ndarray:
        """Map raw ids to slots, inserting unseen ids (KvVariable's
        gather-or-insert). Raises when the table is full — callers evict
        first. Capacity is validated up front so a failed batch mutates
        nothing (safe to evict and retry the same batch)."""
        flat = np.asarray(ids).reshape(-1).astype(np.int64, copy=False)
        if flat.size == 0:
            return np.zeros(np.shape(ids), np.int32)
        uniq, inv, counts = np.unique(
            flat, return_inverse=True, return_counts=True
        )
        uslots = self.lookup_unique(uniq, counts if count else None)
        out = uslots[inv.reshape(-1)]
        return out.reshape(np.shape(ids))

    def lookup_unique(self, uniq: np.ndarray,
                      counts: np.ndarray | None = None) -> np.ndarray:
        """:meth:`lookup` for callers that ALREADY hold the sorted
        unique ids (e.g. prepare_batch, which uniques the batch once
        and reuses it) — skips the extra ``np.unique`` pass. ``counts``
        when given is added to the ids' frequencies. Returns int32
        slots aligned with ``uniq``."""
        with self._lock:
            pos, found = self._positions(uniq)
            have_slot = np.zeros(uniq.shape, bool)
            if found.any():
                have_slot[found] = self._slots[pos[found]] >= 0
            n_need = int((~have_slot).sum())
            if n_need > self._n_free:
                raise RuntimeError(
                    f"KvEmbedding capacity {self.capacity} exhausted "
                    f"({n_need} new ids, {self._n_free} free "
                    "slots); evict() first"
                )
            new = uniq[~found]
            if new.size:
                # demoted ids returning from a host tier keep their
                # frequency history (_insert_keys only runs for ids the
                # mapper has never seen; evict_ids retains the key row)
                self._insert_keys(new)
                pos = np.searchsorted(self._ids, uniq)
            slots = self._slots[pos]
            missing = slots < 0
            if n_need:
                self._slots[pos[missing]] = self._pop_free(n_need)
                slots = self._slots[pos]
            if counts is not None:
                self._freqs[pos] += counts
            return slots.astype(np.int32)

    def frequencies(self, ids) -> np.ndarray:
        flat = np.asarray(ids).reshape(-1).astype(np.int64, copy=False)
        if flat.size == 0:
            return np.zeros(np.shape(ids), np.int64)
        with self._lock:
            pos, found = self._positions(flat)
            out = np.zeros(flat.shape, np.int64)
            if found.any():
                out[found] = self._freqs[pos[found]]
        return out.reshape(np.shape(ids))

    def resident_slots(self, ids) -> np.ndarray:
        """Slots for ``ids`` as an int32 array, -1 where not device-
        resident (unknown OR demoted). The vectorized ``slots_of``."""
        flat = np.asarray(ids).reshape(-1).astype(np.int64, copy=False)
        out = np.full(flat.shape, -1, np.int32)
        if flat.size == 0:
            return out.reshape(np.shape(ids))
        with self._lock:
            pos, found = self._positions(flat)
            if found.any():
                out[found] = self._slots[pos[found]]
        return out.reshape(np.shape(ids))

    def resident_arrays(self):
        """(ids, slots, freqs) copies for every device-resident id."""
        with self._lock:
            mask = self._slots >= 0
            return (
                self._ids[mask].copy(),
                self._slots[mask].copy(),
                self._freqs[mask].copy(),
            )

    def evict_ids(self, raws, forget: bool = False) -> dict[int, int]:
        """Free specific ids' slots; returns {raw_id: freed_slot}.
        By default frequencies are kept (the id may live on in a host
        tier); ``forget=True`` drops the key rows entirely — the host
        tier's own map uses this so its key arrays stay bounded by
        occupancy instead of growing with every id ever spilled."""
        arr = np.unique(np.asarray(raws, dtype=np.int64).reshape(-1))
        if arr.size == 0:
            return {}
        with self._lock:
            pos, found = self._positions(arr)
            sp = pos[found]
            sp = sp[self._slots[sp] >= 0]
            if sp.size == 0:
                return {}
            freed_ids = self._ids[sp].copy()
            freed_slots = self._slots[sp].copy()
            self._push_free(freed_slots)
            if forget:
                keep = np.ones(self._ids.size, bool)
                keep[sp] = False
                self._ids = self._ids[keep]
                self._slots = self._slots[keep]
                self._freqs = self._freqs[keep]
            else:
                self._slots[sp] = -1
            return {
                int(i): int(s) for i, s in zip(freed_ids, freed_slots)
            }

    def coldest_residents(self, k: int, exclude=None):
        """The (ids, slots) of up to ``k`` coldest device-resident ids,
        skipping any id in ``exclude`` — the vectorized victim selection
        for tier demotion (stable argsort: ties break by ascending id).
        """
        with self._lock:
            mask = self._slots >= 0
            if exclude is not None:
                ex = np.asarray(exclude, np.int64).reshape(-1)
                if ex.size:
                    # np.isin(self._ids, ex) through the sorted keys: one
                    # searchsorted of the batch, not a sort of the vocab
                    pos, found = self._positions(ex)
                    mask[pos[found]] = False
            cand = np.flatnonzero(mask)
            if cand.size == 0:
                return _EMPTY_I64, _EMPTY_I32
            if cand.size > 4096 and 0 < k < cand.size:
                # O(n) preselect at table scale, then order the k
                # survivors coldest-first (tie order differs from the
                # stable path, which only matters at toy sizes)
                part = np.argpartition(self._freqs[cand], k - 1)[:k]
                sub = cand[np.sort(part)]
                order = np.argsort(self._freqs[sub], kind="stable")
                pick = sub[order]
            else:
                order = np.argsort(self._freqs[cand], kind="stable")
                pick = cand[order[:k]]
            return self._ids[pick].copy(), self._slots[pick].copy()

    def resident_by_frequency(self) -> list[tuple[int, int]]:
        """Resident (raw_id, freq) pairs, coldest first."""
        with self._lock:
            mask = self._slots >= 0
            ids, fr = self._ids[mask], self._freqs[mask]
            order = np.argsort(fr, kind="stable")
        return [
            (int(i), int(f)) for i, f in zip(ids[order], fr[order])
        ]

    def free_slots(self) -> int:
        with self._lock:
            return int(self._n_free)

    def slots_of(self, raws) -> dict[int, int]:
        arr = np.asarray(list(raws), np.int64).reshape(-1)
        slots = self.resident_slots(arr)
        return {
            int(r): int(s) for r, s in zip(arr, slots) if s >= 0
        }

    def set_frequencies(self, ids, freqs):
        """Overwrite frequencies for ``ids`` (import semantics),
        inserting unknown ids as slotless tracked keys."""
        flat = np.asarray(ids, np.int64).reshape(-1)
        fr = np.asarray(freqs, np.int64).reshape(-1)
        if flat.size == 0:
            return
        with self._lock:
            pos, found = self._positions(flat)
            new = np.unique(flat[~found])
            if new.size:
                self._insert_keys(new)
                pos = np.searchsorted(self._ids, flat)
            self._freqs[pos] = fr

    def evict_under_threshold(self, threshold: int) -> list[int]:
        """Free the slots of ids seen fewer than ``threshold`` times
        (the reference's under-threshold export filtering / eviction).
        Returns the freed slot indices (caller may zero those rows)."""
        with self._lock:
            cold = self._freqs < threshold
            freed = self._slots[cold & (self._slots >= 0)].copy()
            keep = ~cold
            self._ids = self._ids[keep]
            self._slots = self._slots[keep]
            self._freqs = self._freqs[keep]
            self._push_free(freed)
        out = [int(s) for s in freed]
        if out:
            logger.info("evicted %d cold ids", len(out))
        return out

    def grow(self, new_capacity: int):
        """Raise capacity, appending the new slots to the free stack
        (used by the host tier, whose vocabulary is unbounded)."""
        with self._lock:
            add = int(new_capacity) - self.capacity
            if add <= 0:
                return
            free = np.empty(int(new_capacity), np.int32)
            free[:self._n_free] = self._free[:self._n_free]
            free[self._n_free:self._n_free + add] = np.arange(
                int(new_capacity) - 1, self.capacity - 1, -1,
                dtype=np.int32,
            )
            self._free = free
            self._n_free += add
            self.capacity = int(new_capacity)

    # ------------------------------------------------------- checkpoints

    def state_dict(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "ids": self._ids.copy(),
                "slots": self._slots.copy(),
                "freqs": self._freqs.copy(),
            }

    def load_state_dict(self, state: dict):
        with self._lock:
            self.capacity = int(state["capacity"])
            if "ids" in state:
                ids = np.asarray(state["ids"], np.int64).reshape(-1)
                slots = np.asarray(state["slots"], np.int32).reshape(-1)
                freqs = np.asarray(state["freqs"], np.int64).reshape(-1)
                order = np.argsort(ids, kind="stable")
                self._ids = ids[order].copy()
                self._slots = slots[order].copy()
                self._freqs = freqs[order].copy()
            else:  # legacy dict-of-dicts layout (pre-array checkpoints)
                slot_of = {
                    int(k): int(v) for k, v in state["slot_of"].items()
                }
                freq = {int(k): int(v) for k, v in state["freq"].items()}
                ids = np.array(
                    sorted(set(slot_of) | set(freq)), np.int64
                )
                self._ids = ids
                self._slots = np.array(
                    [slot_of.get(int(i), -1) for i in ids], np.int32
                )
                self._freqs = np.array(
                    [freq.get(int(i), 0) for i in ids], np.int64
                )
            used = self._slots[self._slots >= 0]
            free_mask = np.ones(self.capacity, bool)
            free_mask[used] = False
            # descending so pops hand out ascending slot numbers
            self._free = np.flatnonzero(free_mask)[::-1].astype(
                np.int32
            ).copy()
            self._n_free = int(self._free.size)
            pad = np.empty(self.capacity - self._n_free, np.int32)
            self._free = np.concatenate([self._free, pad])


class KvEmbedding:
    """A dynamic embedding table: host mapper + device parameter rows.

    Typical flow::

        kv = KvEmbedding(dim=64, capacity=1 << 17)
        table = kv.init_table(torch.Generator("cuda").manual_seed(0))
        slots = kv.lookup_slots(raw_ids)                # host, pre-step
        vecs = KvEmbedding.embed(table, slots)          # differentiable

    ``logical_axes`` for the table is ``("vocab", "embed")``.
    """

    logical_axes = ("vocab", "embed")

    def __init__(self, dim: int, capacity: int = 1 << 16,
                 init_scale: float = 0.01, dtype: torch.dtype | None = None):
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.init_scale = init_scale
        self.dtype = dtype or torch.float32
        self.mapper = IdMapper(capacity)

    def init_table(self, generator: torch.Generator,
                   device=None) -> torch.Tensor:
        """``N(0, 1) * init_scale`` rows from ``generator``, on
        ``device`` (the generator's device when None)."""
        device = resolve_device(generator.device if device is None
                                else device)
        return torch.randn((self.capacity, self.dim), generator=generator,
                           device=device, dtype=self.dtype) * self.init_scale

    def lookup_slots(self, raw_ids) -> np.ndarray:
        return self.mapper.lookup(raw_ids)

    @staticmethod
    def embed(table: torch.Tensor, slots) -> torch.Tensor:
        """The gather, differentiable (the JAX package's ``jnp.take``)."""
        if not isinstance(slots, torch.Tensor):
            slots = torch.as_tensor(np.asarray(slots), device=table.device)
        return F.embedding(slots, table)

    # ------------------------------------------------------- ckpt/export

    def export(self, table: torch.Tensor, min_frequency: int = 0):
        """(ids, vectors, freqs), optionally dropping ids seen fewer than
        ``min_frequency`` times; one gather of the resident rows."""
        ids, slots, freqs = self.mapper.resident_arrays()
        if min_frequency:
            keep = freqs >= min_frequency
            ids, slots, freqs = ids[keep], slots[keep], freqs[keep]
        if ids.size == 0:
            return (_EMPTY_I64,
                    np.zeros((0, self.dim), _host_dtype(table.dtype)),
                    _EMPTY_I64)
        rows = _to_host(table.detach().index_select(
            0, _index(slots, table.device)))
        return ids.astype(np.int64), rows, freqs.astype(np.int64)

    def import_(self, table: torch.Tensor, ids, vectors, freqs=None):
        """Load (id, vector, freq) triples into ``table`` in place and
        return it. Ids get fresh slots in THIS mapper."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        slots = self.mapper.lookup(ids, count=False)
        if freqs is not None:
            self.mapper.set_frequencies(ids, freqs)
        with torch.no_grad():
            table.index_copy_(0, _index(slots, table.device),
                              _to_device(vectors, table.dtype, table.device))
        return table

    def evict(self, table: torch.Tensor, threshold: int):
        """Drop cold ids and zero their rows in place; returns ``table``."""
        freed = self.mapper.evict_under_threshold(threshold)
        if freed:
            with torch.no_grad():
                table.index_fill_(0, _index(freed, table.device), 0.0)
        return table


class TieredKvEmbedding(KvEmbedding):
    """KvEmbedding whose vocabulary may exceed the device table.

    The device table keeps its fixed [capacity, dim] shape; tiering
    happens on the host BETWEEN steps. ``prepare_batch`` makes every id of
    the incoming batch device-resident: when slots run short it demotes
    the least-frequently-used residents NOT in the batch (one gather of
    only those rows, and of their aux rows, read back to the host tier)
    and promotes or inserts the batch's non-resident ids with one
    scatter. Demoted rows keep their values and frequencies, so a
    returning id resumes where it left off.

    The host tier is a preallocated ``(host_capacity, dim)`` array with
    its own :class:`IdMapper` slot map (doubled when the cold set outruns
    it). ``counters`` tracks ``prepare_batch`` traffic
    (``vectorized_batches``, ``demoted_rows``, ``promoted_rows``,
    ``fresh_rows``). Fresh rows come from a numpy ``RandomState(seed)``,
    so both packages draw the same ones.
    """

    def __init__(self, dim: int, capacity: int = 1 << 16,
                 init_scale: float = 0.01, dtype: torch.dtype | None = None,
                 seed: int = 0, host_capacity: int | None = None):
        super().__init__(dim, capacity, init_scale, dtype)
        self._host_capacity = int(host_capacity or max(capacity, 1024))
        self._host_map = IdMapper(self._host_capacity)
        # spilled rows keep the table's dtype (bit patterns where numpy
        # has none): a demote/promote round-trip is bit-identical
        self._host_dtype = _host_dtype(self.dtype)
        self._host_data = np.zeros(
            (self._host_capacity, self.dim), self._host_dtype)
        # host stores for the caller's aux tensors (slot-aligned
        # optimizer state riding the same round-trip); allocated on the
        # first prepare_batch(aux=...)
        self._host_aux = None
        self._rng = np.random.RandomState(seed)
        self.counters = {
            "vectorized_batches": 0,
            "demoted_rows": 0,
            "promoted_rows": 0,
            "fresh_rows": 0,
        }

    @property
    def host_ids(self) -> int:
        return len(self._host_map)

    def host_bytes(self) -> int:
        """Bytes the host tier holds allocated (rows and aux stores)."""
        return int(self._host_data.nbytes + sum(
            a.nbytes for a in (self._host_aux or [])))

    # ------------------------------------------------------- host tier

    def _grow_host(self, min_new: int):
        new_cap = max(self._host_capacity * 2,
                      self._host_capacity + int(min_new))
        grown = np.zeros((new_cap, self.dim), self._host_data.dtype)
        grown[: self._host_capacity] = self._host_data
        self._host_data = grown
        if self._host_aux is not None:
            self._host_aux = [
                np.concatenate([
                    a,
                    np.zeros((new_cap - self._host_capacity,)
                             + a.shape[1:], a.dtype),
                ])
                for a in self._host_aux
            ]
        self._host_map.grow(new_cap)
        self._host_capacity = new_cap

    def _ensure_host_aux(self, aux):
        """Allocate (or validate) the host stores mirroring the caller's
        aux tensors; rows spilled without aux keep zeros there (fresh
        optimizer state)."""
        if self._host_aux is None:
            self._host_aux = [
                np.zeros((self._host_capacity,) + tuple(a.shape[1:]),
                         _host_dtype(a.dtype))
                for a in aux
            ]
        elif len(self._host_aux) != len(aux):
            raise ValueError(
                f"prepare_batch aux count changed: "
                f"{len(self._host_aux)} stored vs {len(aux)} passed"
            )

    def _host_put(self, ids: np.ndarray, rows: np.ndarray, aux_rows=None):
        """Store ``rows`` (and optional per-id aux rows) for ``ids`` in
        the host tier (block copies, never per-row)."""
        while True:
            try:
                hslots = self._host_map.lookup(ids, count=False)
                break
            except RuntimeError:  # host tier full: double and retry
                self._grow_host(ids.size)
        self._host_data[hslots] = rows
        if self._host_aux is not None:
            if aux_rows is None:
                # slots reused from promoted ids must not leak the
                # previous occupant's optimizer state
                for a in self._host_aux:
                    a[hslots] = 0
            else:
                for a, r in zip(self._host_aux, aux_rows):
                    a[hslots] = r

    def _host_take(self, ids: np.ndarray, n_aux: int = 0):
        """Rows for ``ids``: spilled rows leave the host tier (their
        slots free up), unseen ids get fresh random init (and zero aux =
        fresh optimizer state). Returns (rows, aux_rows_list,
        n_promoted_from_host)."""
        hs = self._host_map.resident_slots(ids)
        have = hs >= 0
        rows = np.empty((ids.size, self.dim), self._host_data.dtype)
        aux_rows = [
            np.zeros((ids.size,) + a.shape[1:], a.dtype)
            for a in (self._host_aux or [])[:n_aux]
        ]
        if have.any():
            rows[have] = self._host_data[hs[have]]
            for out, a in zip(aux_rows, self._host_aux or []):
                out[have] = a[hs[have]]
            self._host_map.evict_ids(ids[have], forget=True)
        n_fresh = int((~have).sum())
        if n_fresh:
            fresh = self._rng.randn(n_fresh, self.dim) * self.init_scale
            if self.dtype in _BITS:
                rows[~have] = _to_host(torch.from_numpy(fresh).to(self.dtype))
            else:
                rows[~have] = fresh.astype(rows.dtype)
        return rows, aux_rows, int(have.sum())

    # ------------------------------------------------------ hot path

    def prepare_batch(self, table: torch.Tensor, raw_ids, count: bool = True,
                      aux=None):
        """Make every id in ``raw_ids`` device-resident.

        Returns ``(table, slots)``: ``table`` is the same tensor, written
        in place by the demote/promote round-trip (one gather and one
        scatter per tensor), ``slots`` an int32 array aligned with
        ``raw_ids``. All id bookkeeping is batched numpy set-ops.
        ``count=False`` serves the batch without recording frequency uses
        (eval traffic).

        ``aux``: optional ``[capacity, ...]`` tensors row-aligned with the
        table (slot-aligned optimizer state). Their rows ride the same
        round-trip, in place, so a relocated id keeps its own optimizer
        state; fresh ids get zero aux rows. With aux the return is
        ``(table, slots, aux_list)``.
        """
        if aux is not None:
            aux = list(aux)
            self._ensure_host_aux(aux)
        n_aux = len(aux) if aux is not None else 0
        flat = np.asarray(raw_ids).reshape(-1).astype(np.int64, copy=False)
        # ONE unique pass serves residency check, promotion, and the
        # final slot mapping (uniq is sorted; subsets stay sorted)
        uniq, inv, ucounts = np.unique(
            flat, return_inverse=True, return_counts=True)
        incoming = uniq[self.mapper.resident_slots(uniq) < 0]
        if incoming.size > self.capacity:
            raise RuntimeError(
                f"batch needs {incoming.size} new rows but the device "
                f"table holds {self.capacity}"
            )
        need = int(incoming.size) - self.mapper.free_slots()
        with torch.no_grad():
            if need > 0:
                # demote the coldest residents that the batch doesn't use
                vic_ids, vic_slots = self.mapper.coldest_residents(
                    need, exclude=uniq)
                if vic_ids.size < need:
                    raise RuntimeError(
                        "cannot make room: batch uses the whole table")
                idx = _index(vic_slots, table.device)
                rows = _to_host(table.index_select(0, idx))
                aux_out = [_to_host(a.index_select(0, idx))
                           for a in (aux or [])]
                self._host_put(vic_ids, rows, aux_out if aux else None)
                self.mapper.evict_ids(vic_ids)
                self.counters["demoted_rows"] += int(vic_ids.size)
            if incoming.size:
                # promote/insert the batch's non-resident ids
                slots_new = self.mapper.lookup_unique(incoming)
                rows, aux_rows, n_promoted = self._host_take(incoming,
                                                             n_aux)
                idx = _index(slots_new, table.device)
                table.index_copy_(0, idx, _to_device(rows, table.dtype,
                                                    table.device))
                for a, r in zip(aux or [], aux_rows):
                    a.index_copy_(0, idx, _to_device(r, a.dtype, a.device))
                n = int(incoming.size)
                self.counters["promoted_rows"] += n_promoted
                self.counters["fresh_rows"] += n - n_promoted
        # count a use for every id in the batch and map to slots
        # (counts=None: eval traffic must not inflate the LFU stats that
        # drive demotion, eviction, and export filtering)
        uslots = self.mapper.lookup_unique(uniq, ucounts if count else None)
        slots = uslots[inv.reshape(-1)]
        self.counters["vectorized_batches"] += 1
        slots = slots.reshape(np.shape(raw_ids))
        if aux is None:
            return table, slots
        return table, slots, aux

    # ------------------------------------------------------- ckpt/export

    def export(self, table: torch.Tensor, min_frequency: int = 0):
        """(ids, vectors, freqs) across BOTH tiers."""
        ids_d, rows_d, freqs_d = super().export(table, min_frequency)
        h_ids, h_slots, _ = self._host_map.resident_arrays()
        if h_ids.size == 0:
            return ids_d, rows_d, freqs_d
        h_rows = self._host_data[h_slots]
        h_freqs = self.mapper.frequencies(h_ids).astype(np.int64)
        if min_frequency:
            keep = h_freqs >= min_frequency
            h_ids, h_rows, h_freqs = h_ids[keep], h_rows[keep], h_freqs[keep]
        if h_ids.size == 0:
            return ids_d, rows_d, freqs_d
        return (
            np.concatenate([ids_d, h_ids.astype(np.int64)]),
            np.concatenate([rows_d, h_rows]),
            np.concatenate([freqs_d, h_freqs]),
        )

    def import_(self, table: torch.Tensor, ids, vectors, freqs=None):
        """Load triples: fills the device table until full (in place),
        spills the rest to the host tier (one block copy). ``vectors``
        may be a tensor on any device or a numpy array."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if not isinstance(vectors, torch.Tensor):
            vectors = np.asarray(vectors)
        freqs_a = (None if freqs is None
                   else np.asarray(freqs, np.int64).reshape(-1))
        n_dev = min(int(ids.size), self.mapper.free_slots())
        if n_dev:
            table = super().import_(
                table, ids[:n_dev], vectors[:n_dev],
                None if freqs_a is None else freqs_a[:n_dev])
        if n_dev < ids.size:
            spill = ids[n_dev:]
            rest = vectors[n_dev:]
            if isinstance(rest, torch.Tensor):
                rest = _to_host(rest.to(self.dtype))
            self._host_put(spill, rest)
            if freqs_a is not None:
                self.mapper.set_frequencies(spill, freqs_a[n_dev:])
        return table

    def evict(self, table: torch.Tensor, threshold: int):
        """Drop cold ids from BOTH tiers (host rows freed too)."""
        h_ids, _, _ = self._host_map.resident_arrays()
        if h_ids.size:
            cold = h_ids[self.mapper.frequencies(h_ids) < threshold]
            if cold.size:
                self._host_map.evict_ids(cold, forget=True)
        return super().evict(table, threshold)

    def state_dict(self) -> dict:
        h_ids, h_slots, _ = self._host_map.resident_arrays()
        state = {
            "mapper": self.mapper.state_dict(),
            "host_ids": h_ids.astype(np.int64),
            "host_rows": self._host_data[h_slots].copy(),
        }
        if self._host_aux is not None:
            state["host_aux"] = [a[h_slots].copy() for a in self._host_aux]
        # the fresh-row generator's position: a restored tier draws the
        # rows the uninterrupted one would (the JAX package's state has
        # none, and its restored tier draws from a reseeded generator)
        state["rng"] = self._rng.get_state()
        return state

    def load_state_dict(self, state: dict):
        self.mapper.load_state_dict(state["mapper"])
        if "host_store" in state:  # legacy dict-of-rows layout
            items = sorted(
                (int(k), np.asarray(v))
                for k, v in state["host_store"].items()
            )
            h_ids = np.array([k for k, _ in items], np.int64)
            h_rows = (
                np.stack([v for _, v in items])
                if items else np.zeros((0, self.dim), self._host_dtype)
            )
        else:
            h_ids = np.asarray(state["host_ids"], np.int64).reshape(-1)
            h_rows = np.asarray(state["host_rows"])
        self._host_capacity = max(
            int(self._host_capacity), int(h_ids.size), 1024)
        self._host_map = IdMapper(self._host_capacity)
        self._host_data = np.zeros(
            (self._host_capacity, self.dim), self._host_dtype)
        saved_aux = state.get("host_aux")
        if saved_aux is not None:
            self._host_aux = [
                np.zeros((self._host_capacity,) + tuple(a.shape[1:]),
                         a.dtype)
                for a in saved_aux
            ]
        else:
            self._host_aux = None
        if h_ids.size:
            self._host_put(h_ids, h_rows, saved_aux)
        if "rng" in state:
            self._rng.set_state(state["rng"])
