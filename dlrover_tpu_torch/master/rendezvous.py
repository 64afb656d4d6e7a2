"""Master-side rendezvous managers.

Equivalent capability: reference dlrover/python/master/elastic_training/
rdzv_manager.py — ElasticTrainingRendezvousManager (:265) gathers waiting
nodes into a world once min/max/node-unit/timeout conditions hold;
NetworkCheckRendezvousManager (:311) pairs nodes over >=2 rounds of a
device/collective probe to isolate the faulty node (_group_nodes :364) and
flags stragglers at >2x median elapsed time (_detect_stragglers :505).

TPU adaptation: instead of a torch TCPStore world, the comm world carries
the JAX coordination-service address (rank-0 node ip:port) so workers can
call ``jax.distributed.initialize`` with (coordinator, num_processes,
process_id). The network check payload is an ICI/DCN mesh probe (see
agent/node_check.py) but the master-side pairing/straggler logic is
hardware-agnostic and unchanged in spirit.

The PyTorch port's copy of dlrover_tpu/master/rendezvous.py.
"""

from __future__ import annotations

import threading
import time

from dlrover_tpu_torch.common import telemetry, tracing
from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.constants import (
    JobConstant,
    NetworkFailureReason,
    RendezvousName,
)
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


class RendezvousParameters:
    def __init__(
        self,
        min_nodes: int,
        max_nodes: int,
        waiting_timeout: float = JobConstant.RDZV_JOIN_TIMEOUT_DEFAULT,
        node_unit: int = 1,
    ):
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.waiting_timeout = waiting_timeout
        self.node_unit = max(node_unit, 1)


class RendezvousManager:
    """Base: collects waiting nodes, forms rounds."""

    name = ""

    def __init__(self):
        self._lock = threading.Lock()
        self._params = RendezvousParameters(0, 0)
        # node_rank -> (local_world_size, node_ip)
        self._waiting_nodes: dict[int, tuple[int, str]] = {}
        self._rdzv_nodes: dict[int, tuple[int, str]] = {}
        self._latest_rdzv_nodes: list[int] = []
        self._rdzv_round = 0
        self._first_join_time = 0.0
        self._coordinator_port = 0
        self._node_times: dict[int, float] = {}
        # node_rank -> set of locally-restorable checkpoint steps the
        # agent reported at join; consensus = newest step COMMON to all
        # members of a formed round, broadcast so every host restores
        # the SAME step (a step any host lacks is never forced)
        self._verified_steps: dict[int, frozenset] = {}
        self._restore_step = -1
        # reshape-first elasticity: members of a dissolved round whose
        # host rode through (they were carried back into waiting by a
        # membership change, NOT by their own re-join) reshape their
        # mesh in process; everyone else restarts. The verdict is
        # per-member, computed when the next round forms.
        self._carryover: set[int] = set()
        # rank -> "dead" | "drained", accumulated between rounds
        self._departed_pending: dict[int, str] = {}
        # the latest formed round's per-member verdicts + departures
        self._verdicts: dict[int, str] = {}
        self._departed: dict[int, str] = {}

    def update_rdzv_params(
        self, min_nodes, max_nodes, waiting_timeout, node_unit
    ):
        with self._lock:
            self._params = RendezvousParameters(
                min_nodes, max_nodes, waiting_timeout, node_unit
            )

    def set_coordinator_port(self, port: int):
        # locked like every other mutation: dtsan flags the unlocked
        # write racing export_state/get_comm_world reads
        with self._lock:
            self._coordinator_port = port

    def get_min_nodes(self) -> int:
        with self._lock:
            return self._params.min_nodes

    def add_alive_node(self, node_rank: int):
        pass

    def remove_alive_node(self, node_rank: int):
        """A node died: drop it from waiting, and if it was part of the
        formed round, dissolve the round — survivors go back to waiting so
        their agents see a membership change and re-rendezvous instead of
        blocking in collectives with a dead peer."""
        self._remove_node(node_rank, reason="dead")

    def drain_node(self, node_rank: int):
        """Graceful scale-in: the node leaves the job but its host is
        alive at the drain point, so survivors can still read its
        shards device-to-device — the departed reason \"drained\" tells
        them no state was lost (vs \"dead\", where shards on that host
        are gone and must come from the checkpoint)."""
        self._remove_node(node_rank, reason="drained")

    def _remove_node(self, node_rank: int, reason: str):
        """Drop a node from waiting, and if it was part of the formed
        round, dissolve the round — survivors are carried back into
        waiting (verdict \"reshape\" for the next round: their agents
        ride through instead of restarting workers)."""
        with self._lock:
            removed = self._waiting_nodes.pop(node_rank, None) is not None
            self._verified_steps.pop(node_rank, None)
            self._carryover.discard(node_rank)
            if node_rank in self._rdzv_nodes:
                self._rdzv_nodes.pop(node_rank)
                for rank, info in self._rdzv_nodes.items():
                    self._waiting_nodes.setdefault(rank, info)
                    self._carryover.add(rank)
                self._rdzv_nodes = {}
                self._first_join_time = time.time()
                self._departed_pending[node_rank] = reason
                removed = True
            if removed:
                logger.info(
                    "%s: removed %s node %s", self.name, reason,
                    node_rank,
                )

    @staticmethod
    def _step_set(verified_ckpt_step: int, verified_ckpt_steps) -> frozenset:
        """Normalize a join's availability report: the step list wins;
        a scalar-only report (older client) is a singleton set."""
        steps = {int(s) for s in (verified_ckpt_steps or ()) if int(s) >= 0}
        if not steps and verified_ckpt_step >= 0:
            steps = {int(verified_ckpt_step)}
        return frozenset(steps)

    def join_rendezvous(
        self, node_rank: int, local_world_size: int, node_ip: str = "",
        verified_ckpt_step: int = -1, verified_ckpt_steps=None,
    ) -> int:
        # master-side span: the RPC handler attached the joining
        # agent's trace context, so this nests under its rdzv.round
        with tracing.span(
            "rdzv.join.handle", rank=node_rank, rdzv=self.name
        ):
            # master-side fault site: a dropped/delayed join is the
            # server half of a flaky control plane (client: rpc.send)
            chaos_point("rdzv.join", rank=node_rank, name=self.name)
            telemetry.event(
                "rdzv.join", rank=node_rank, name=self.name,
                verified_step=verified_ckpt_step,
            )
            with self._lock:
                if not self._waiting_nodes:
                    self._first_join_time = time.time()
                self._waiting_nodes[node_rank] = (
                    local_world_size, node_ip
                )
                self._verified_steps[node_rank] = self._step_set(
                    verified_ckpt_step, verified_ckpt_steps
                )
                # joining invalidates the current formed round; its
                # members are CARRIED into the next round's waiting set
                # (verdict "reshape": their agents ride through the
                # membership change instead of re-joining), while an
                # explicit join — this node — always means fresh worker
                # processes, so it can never be a carryover
                if self._rdzv_nodes:
                    for rank, info in self._rdzv_nodes.items():
                        if rank == node_rank:
                            continue
                        self._waiting_nodes.setdefault(rank, info)
                        self._carryover.add(rank)
                    self._first_join_time = time.time()
                self._carryover.discard(node_rank)
                self._rdzv_nodes = {}
                return self._rdzv_round

    def num_nodes_waiting(self) -> int:
        """>0 means a membership change is pending — agents restart their
        workers to re-rendezvous (reference _membership_changed)."""
        with self._lock:
            # While a round is formed and complete, nothing is "waiting".
            if self._rdzv_nodes:
                return 0
            return len(self._waiting_nodes)

    def _ready(self) -> bool:
        p = self._params
        n = len(self._waiting_nodes)
        if n < max(p.min_nodes, 1):
            return False
        if p.max_nodes and n >= p.max_nodes:
            return True
        elapsed = time.time() - self._first_join_time
        if elapsed >= p.waiting_timeout:
            return True
        return False

    def _truncate_to_unit(self, ranks: list[int]) -> list[int]:
        unit = self._params.node_unit
        usable = (len(ranks) // unit) * unit
        return sorted(ranks)[:usable]

    def _form_round(self):
        """Called under lock when ready: freeze waiting set into a world."""
        with tracing.span("rdzv.form_round", rdzv=self.name):
            self._form_round_traced()

    def _form_round_traced(self):
        ranks = self._truncate_to_unit(list(self._waiting_nodes.keys()))
        self._rdzv_nodes = {r: self._waiting_nodes[r] for r in ranks}
        self._latest_rdzv_nodes = ranks
        for r in ranks:
            self._waiting_nodes.pop(r, None)
        self._rdzv_round += 1
        # reshape-vs-restart verdict per member: a carryover (its host
        # rode through the membership change without re-joining) keeps
        # its worker processes and reshapes the mesh in process;
        # everyone else starts fresh worker processes. ``departed``
        # records who left and HOW — "drained" hosts were alive at the
        # drain point (survivors read their shards device-to-device),
        # "dead" hosts took their shards with them (checkpoint
        # fallback for anything they exclusively held).
        self._verdicts = {
            r: ("reshape" if r in self._carryover else "restart")
            for r in ranks
        }
        self._departed = {
            r: reason
            for r, reason in self._departed_pending.items()
            if r not in ranks
        }
        self._carryover = set()
        self._departed_pending = {}
        # restore-step consensus: the NEWEST step every member can
        # actually load. Forcing min-of-newest instead would pick steps
        # some hosts pruned or never persisted, and those hosts would
        # silently restore something older — the exact split-world the
        # consensus exists to prevent. No common step (or any member
        # with nothing restorable) -> no forcing.
        step_sets = [self._verified_steps.get(r) for r in ranks]
        if step_sets and all(step_sets):
            common = frozenset.intersection(*step_sets)
            self._restore_step = max(common) if common else -1
            if not common:
                logger.warning(
                    "%s: no checkpoint step is restorable on every "
                    "member (%s); hosts restore their local newest",
                    self.name,
                    {r: sorted(s) for r, s in
                     zip(ranks, step_sets)},
                )
        else:
            self._restore_step = -1
        telemetry.event(
            "rdzv.complete",
            name=self.name,
            round=self._rdzv_round,
            world=len(ranks),
            restore_step=self._restore_step,
            reshape=sum(
                1 for v in self._verdicts.values() if v == "reshape"
            ),
            departed=len(self._departed),
            dur=max(time.time() - self._first_join_time, 0.0),
        )
        logger.info(
            "%s rendezvous round %d formed with nodes %s "
            "(consensus restore step %s, verdicts %s, departed %s)",
            self.name,
            self._rdzv_round,
            ranks,
            self._restore_step,
            self._verdicts,
            self._departed,
        )

    def get_comm_world(self, node_rank: int):
        raise NotImplementedError

    def rdzv_round(self) -> int:
        # dtsan first-run finding: this read raced _form_round's
        # increment; an agent polling it could observe a half-formed
        # round's number and pair round-N verdicts with a round-N+1
        # world (the mismatch round_verdicts() guards against)
        with self._lock:
            return self._rdzv_round

    def latest_members(self) -> tuple[int, list[int]]:
        """(round, member ranks) of the latest FORMED round — the
        repair brain's picture of who is in the job when it prices an
        eviction or checks a drain plan's completion. The formed set
        wins; between dissolution and re-formation the last formed
        membership stands (the brain must not read a transient empty
        world as 'everyone left')."""
        with self._lock:
            members = (
                sorted(self._rdzv_nodes)
                if self._rdzv_nodes
                else list(self._latest_rdzv_nodes)
            )
            return self._rdzv_round, members

    def consensus_restore_step(self) -> int:
        """The NEWEST checkpoint step restorable on every member of the
        latest formed round (-1 = no forcing). Hosts restore exactly
        this step so a verified fallback can never split the world
        across steps."""
        with self._lock:
            return self._restore_step

    def round_verdicts(self, round_: int | None = None) -> tuple[dict, dict]:
        """(verdicts, departed) of the latest formed round: node_rank ->
        "reshape"|"restart", and departed node_rank -> "dead"|"drained".

        ``round_`` guards callers that read the world and its verdicts
        under SEPARATE lock acquisitions (the servicer): if the round
        dissolved and re-formed in between, attaching round-N+1
        verdicts to a round-N world would hand an agent a "reshape"
        verdict for a world it should restart into — mismatches return
        empty dicts instead (the agent's poll loop picks up the fresh
        round next tick)."""
        with self._lock:
            if round_ is not None and round_ != self._rdzv_round:
                return {}, {}
            return dict(self._verdicts), dict(self._departed)

    def clear_waiting_nodes(self):
        with self._lock:
            self._waiting_nodes.clear()

    def update_verified_steps(self, node_rank: int, steps) -> None:
        """Refresh one node's locally-restorable step set WITHOUT
        joining (a join would dissolve the formed round). Used by
        agents re-registering after a master failover: the restored
        master's persisted view may predate checkpoints persisted
        during the outage."""
        with self._lock:
            self._verified_steps[node_rank] = frozenset(
                int(s) for s in (steps or ()) if int(s) >= 0
            )

    # -------------------------------------------------- failover durability

    def export_state(self) -> dict:
        """JSON-serializable rendezvous state for the master state
        store. Covers the base-class fields every manager shares; the
        network-check manager's per-round probe results are transient
        (a probe re-runs after failover) and intentionally excluded."""
        with self._lock:
            p = self._params
            return {
                "params": [
                    p.min_nodes, p.max_nodes, p.waiting_timeout,
                    p.node_unit,
                ],
                "round": self._rdzv_round,
                "waiting": {
                    str(r): list(v)
                    for r, v in self._waiting_nodes.items()
                },
                "rdzv_nodes": {
                    str(r): list(v) for r, v in self._rdzv_nodes.items()
                },
                "latest": list(self._latest_rdzv_nodes),
                "verified_steps": {
                    str(r): sorted(s)
                    for r, s in self._verified_steps.items()
                },
                "restore_step": self._restore_step,
                "first_join_time": self._first_join_time,
                "coordinator_port": self._coordinator_port,
                # reshape-first elasticity: the verdicts of the formed
                # round (and who left, and how) must survive a master
                # failover — a surviving agent polling the restored
                # master mid-reshape still needs its "reshape" verdict
                "carryover": sorted(self._carryover),
                "departed_pending": {
                    str(r): v
                    for r, v in self._departed_pending.items()
                },
                "verdicts": {
                    str(r): v for r, v in self._verdicts.items()
                },
                "departed": {
                    str(r): v for r, v in self._departed.items()
                },
            }

    def restore_state(self, state: dict) -> None:
        with self._lock:
            p = state.get("params")
            if p:
                self._params = RendezvousParameters(*p)
            self._rdzv_round = int(state.get("round", 0))
            self._waiting_nodes = {
                int(r): tuple(v)
                for r, v in (state.get("waiting") or {}).items()
            }
            self._rdzv_nodes = {
                int(r): tuple(v)
                for r, v in (state.get("rdzv_nodes") or {}).items()
            }
            self._latest_rdzv_nodes = [
                int(r) for r in state.get("latest", [])
            ]
            self._verified_steps = {
                int(r): frozenset(int(s) for s in steps)
                for r, steps in (
                    state.get("verified_steps") or {}
                ).items()
            }
            self._restore_step = int(state.get("restore_step", -1))
            self._first_join_time = float(
                state.get("first_join_time", 0.0)
            )
            self._coordinator_port = int(
                state.get("coordinator_port", 0)
            )
            self._carryover = {
                int(r) for r in state.get("carryover", [])
            }
            self._departed_pending = {
                int(r): str(v)
                for r, v in (
                    state.get("departed_pending") or {}
                ).items()
            }
            self._verdicts = {
                int(r): str(v)
                for r, v in (state.get("verdicts") or {}).items()
            }
            self._departed = {
                int(r): str(v)
                for r, v in (state.get("departed") or {}).items()
            }
        logger.info(
            "%s: restored round %d with members %s (waiting %s)",
            self.name, self._rdzv_round,
            sorted(self._rdzv_nodes), sorted(self._waiting_nodes),
        )


class ElasticTrainingRendezvousManager(RendezvousManager):
    name = RendezvousName.ELASTIC_TRAINING

    def get_comm_world(self, node_rank: int):
        """Return (round, group, world, coordinator_addr). world is empty
        until the round forms; callers poll."""
        with self._lock:
            if not self._rdzv_nodes and self._ready():
                self._form_round()
            if not self._rdzv_nodes or node_rank not in self._rdzv_nodes:
                return self._rdzv_round, 0, {}, ""
            world = {
                r: lws for r, (lws, _ip) in sorted(self._rdzv_nodes.items())
            }
            first_rank = min(self._rdzv_nodes)
            ip = self._rdzv_nodes[first_rank][1] or "127.0.0.1"
            coordinator = f"{ip}:{self._coordinator_port or 7659}"
            return self._rdzv_round, 0, world, coordinator


class DecodePoolRendezvousManager(ElasticTrainingRendezvousManager):
    """The elastic serving arm's node group (``role=decode``): decode
    workers join the job through the same rendezvous door as trainers,
    so heartbeat-timeout removal, graceful drain, chaos kills and
    master-failover state restore all apply to the pool unmodified.
    The pool's default parameters (min 1, no max, zero wait) form a
    round per membership change — serving has no collective to
    synchronize, the round is purely the liveness/membership record
    the brain and dashboards read."""

    name = RendezvousName.DECODE_POOL

    def __init__(self):
        super().__init__()
        self.update_rdzv_params(
            min_nodes=1, max_nodes=0, waiting_timeout=0.0, node_unit=1
        )


class NetworkCheckRendezvousManager(RendezvousManager):
    """Pairs nodes over successive probe rounds to isolate faults."""

    name = RendezvousName.NETWORK_CHECK

    def __init__(self):
        super().__init__()
        # round -> {node_rank: normal}
        self._node_status: dict[int, dict[int, bool]] = {}
        # round -> {node_rank: elapsed}
        self._node_times_by_round: dict[int, dict[int, float]] = {}
        # round -> frozen grouping (stable for the round even as late
        # previous-round reports trickle in)
        self._groups_by_round: dict[int, list[list[int]]] = {}
        self._check_round = 0
        self._fault_nodes: set[int] = set()
        self._stragglers: set[int] = set()
        self._reported_leaks: set[int] = set()

    def get_comm_world(self, node_rank: int):
        with self._lock:
            if not self._rdzv_nodes and self._ready():
                self._form_round()
                self._check_round += 1
            if not self._rdzv_nodes or node_rank not in self._rdzv_nodes:
                return self._rdzv_round, 0, {}, ""
            groups = self._group_nodes(self._check_round)
            for gi, group in enumerate(groups):
                if node_rank in group:
                    world = {
                        r: self._rdzv_nodes[r][0] for r in sorted(group)
                    }
                    first = min(group)
                    ip = self._rdzv_nodes[first][1] or "127.0.0.1"
                    coordinator = f"{ip}:{(self._coordinator_port or 7659) + gi + 1}"
                    return self._rdzv_round, gi, world, coordinator
            return self._rdzv_round, 0, {}, ""

    def _group_nodes(self, check_round: int) -> list[list[int]]:
        """Pair nodes 2-by-2 (reference _group_nodes :364-409).

        First round: sequential pairs. Later rounds: sort nodes by the
        previous round's result — normal nodes first, then by measured
        elapsed time — and pair fastest-with-slowest, never re-pairing
        a node with its previous-round partner. Every strongly abnormal
        node (faulty: slow or failed hard) gets a known-good fast
        partner, while mildly abnormal nodes (victims of a faulty
        partner) pair with each other and pass, so two faulty nodes out
        of six are both pinned in two rounds (reference
        `_check_abnormal_nodes` regrouping + time-sorted round 1).

        The grouping is computed once per round and cached: the fault
        verdict intersects *consecutive* rounds, so a repeated pair
        would condemn the faulty node's healthy partner with it, and a
        late previous-round report must not re-shuffle a round already
        handed to some nodes.
        """
        cached = self._groups_by_round.get(check_round)
        if cached is not None:
            return cached
        # only rounds r and r-1 are ever read (fault intersection,
        # victim filter, pairing memory): prune older history or a
        # long-lived master leaks one grouping + two dicts per round
        for store in (
            self._groups_by_round,
            self._node_status,
            self._node_times_by_round,
        ):
            for old in [k for k in store if k < check_round - 1]:
                del store[old]
        ranks = sorted(self._rdzv_nodes.keys())
        n = len(ranks)
        if n <= 2:
            groups = [list(ranks)]
            self._groups_by_round[check_round] = groups
            return groups
        prev_times = self._node_times_by_round.get(check_round - 1, {})
        if not prev_times:
            pairs = [ranks[i : i + 2] for i in range(0, n - (n % 2), 2)]
            if n % 2:
                pairs[-1].append(ranks[-1])
            self._groups_by_round[check_round] = pairs
            return pairs
        prev_status = self._node_status.get(check_round - 1, {})
        prev_partners: dict[int, set[int]] = {}
        for group in self._groups_by_round.get(check_round - 1, []):
            for r in group:
                prev_partners[r] = {g for g in group if g != r}

        def sort_key(r):
            # abnormal nodes last, slowest-most-suspect at the very end
            failed = 0 if prev_status.get(r, False) else 1
            return (failed, prev_times.get(r, float("inf")), r)

        order = sorted(ranks, key=sort_key)
        pairs = []
        while len(order) >= 2:
            a = order.pop(0)  # fastest remaining
            # slowest remaining that was not a's previous partner
            pick = len(order) - 1
            for k in range(len(order) - 1, -1, -1):
                if order[k] not in prev_partners.get(a, ()):
                    pick = k
                    break
            pairs.append(sorted([a, order.pop(pick)]))
        if order:
            # odd count: the leftover probes alone (the reference's
            # middle node, rdzv_manager.py:395-409 while-loop tail).
            # Appending it to a pair instead would make consecutive
            # no-repeat groupings impossible by pigeonhole once a
            # previous round held a triple.
            pairs.append([order.pop()])

        # the greedy can corner itself: the last nodes placed together
        # may be previous partners. Repair by swapping one member with
        # a member of another group, accepting the first swap that
        # leaves both groups repeat-free.
        import itertools

        def conflicted(g):
            return any(
                b in prev_partners.get(a, set())
                for a, b in itertools.combinations(g, 2)
            )

        for i, g in enumerate(pairs):
            if not conflicted(g):
                continue
            done = False
            for j, q in enumerate(pairs):
                if done or j == i:
                    continue
                for xi in range(len(g)):
                    for yi in range(len(q)):
                        cand_g = sorted(
                            g[:xi] + [q[yi]] + g[xi + 1:]
                        )
                        cand_q = sorted(
                            q[:yi] + [g[xi]] + q[yi + 1:]
                        )
                        if not conflicted(cand_g) and not conflicted(
                            cand_q
                        ):
                            pairs[i], pairs[j] = cand_g, cand_q
                            done = True
                            break
                    if done:
                        break
        self._groups_by_round[check_round] = pairs
        return pairs

    def report_network_check_result(
        self, node_rank: int, normal: bool, elapsed: float
    ):
        with self._lock:
            rnd = self._check_round
            self._node_status.setdefault(rnd, {})[node_rank] = normal
            self._node_times_by_round.setdefault(rnd, {})[node_rank] = elapsed

    def join_rendezvous(
        self, node_rank: int, local_world_size: int, node_ip: str = "",
        verified_ckpt_step: int = -1, verified_ckpt_steps=None,
    ) -> int:
        with tracing.span(
            "rdzv.join.handle", rank=node_rank, rdzv=self.name
        ):
            chaos_point("rdzv.join", rank=node_rank, name=self.name)
            telemetry.event(
                "rdzv.join", rank=node_rank, name=self.name,
                verified_step=verified_ckpt_step,
            )
            with self._lock:
                if not self._waiting_nodes:
                    self._first_join_time = time.time()
                    self._fault_nodes.clear()
                    self._stragglers.clear()
                self._waiting_nodes[node_rank] = (
                    local_world_size, node_ip
                )
                self._verified_steps[node_rank] = self._step_set(
                    verified_ckpt_step, verified_ckpt_steps
                )
                self._rdzv_nodes = {}
                return self._rdzv_round

    def network_check_success(self) -> tuple[bool, str]:
        """All nodes of the round reported and none is faulty."""
        with self._lock:
            rnd = self._check_round
            statuses = self._node_status.get(rnd, {})
            if not self._latest_rdzv_nodes:
                return False, NetworkFailureReason.NO_INIT
            if len(statuses) < len(self._latest_rdzv_nodes):
                return False, NetworkFailureReason.WAITING_NODE
            if all(statuses.get(r, False) for r in self._latest_rdzv_nodes):
                return True, ""
            return False, NetworkFailureReason.NODE_FAILURE

    def check_fault_node(self) -> tuple[list[int], str]:
        """A node is faulty if its probe group failed in two consecutive
        rounds (different partners)."""
        with self._lock:
            rnd = self._check_round
            statuses = self._node_status.get(rnd, {})
            if len(statuses) < len(self._latest_rdzv_nodes):
                return (
                    sorted(self._fault_nodes),
                    NetworkFailureReason.WAITING_NODE,
                )
            abnormal = {
                r
                for r in self._latest_rdzv_nodes
                if not statuses.get(r, False)
            }
            if not abnormal:
                self._fault_nodes.clear()
                return [], ""
            prev = self._node_status.get(rnd - 1)
            if prev is None:
                # first round: every member of a failed group is suspect;
                # need another round to decide.
                return [], NetworkFailureReason.WAITING_NODE
            prev_abnormal = {
                r for r, ok in prev.items() if not ok
            }
            fault = abnormal & prev_abnormal
            fault -= self._victims(fault, (rnd - 1, rnd))
            self._fault_nodes = fault
            if not self._fault_nodes:
                return [], NetworkFailureReason.WAITING_NODE
            return (
                sorted(self._fault_nodes),
                NetworkFailureReason.NODE_FAILURE,
            )

    def _victims(self, fault: set, rounds) -> set:
        """Nodes whose every failing round is explained by a co-member
        of the same probe group that is itself in the fault set and
        exhibits an EXTREME elapsed relative to the node: collateral
        damage of a faulty partner (an unlucky node can draw a
        different faulty partner twice in a row when faulty nodes
        outnumber known-good ones), not faults. A faulty node shows up
        at one of two extremes — its probe hangs to timeout (strictly
        slower than the victim) or its device fails instantly (far
        faster than the victim, who then waits out the collective)."""

        def explained(x, rnd):
            times = self._node_times_by_round.get(rnd, {})
            tx = times.get(x)
            if tx is None:
                return False
            for group in self._groups_by_round.get(rnd, []):
                if x in group:
                    return any(
                        y != x and y in fault and (
                            times.get(y, 0.0) > tx
                            or times.get(y, tx) < 0.25 * tx
                        )
                        for y in group
                    )
            return False

        return {
            x for x in fault
            if all(explained(x, rnd) for rnd in rounds)
        }

    def get_stragglers(self) -> tuple[list[int], bool]:
        """Straggler = elapsed > 2x the fleet baseline of the round
        (reference _detect_stragglers :505; baseline convention shared
        with the runtime diagnosis via
        :func:`~dlrover_tpu_torch.common.telemetry.median_baseline`).
        Returns (stragglers, round_complete)."""
        with self._lock:
            rnd = self._check_round
            times = self._node_times_by_round.get(rnd, {})
            if len(times) < len(self._latest_rdzv_nodes) or not times:
                return sorted(self._stragglers), False
            baseline = telemetry.median_baseline(times.values())
            self._stragglers = {
                r
                for r, t in times.items()
                if baseline > 0 and t > 2 * baseline
            }
            return sorted(self._stragglers), True
