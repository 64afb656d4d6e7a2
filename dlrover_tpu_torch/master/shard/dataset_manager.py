"""Batch dataset manager: todo/doing/done task queues with recovery.

Equivalent capability: reference dlrover/python/master/shard/
batch_dataset_manager.py (BatchDatasetManager :29) + base_dataset_manager.

The PyTorch port's copy of dlrover_tpu/master/shard/dataset_manager.py.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, List

from dlrover_tpu_torch.common.constants import NodeType, TaskType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.shard.dataset_splitter import DatasetSplitter, Shard

logger = get_logger(__name__)


@dataclass
class Task:
    task_id: int
    task_type: str
    shard: Shard
    retry_count: int = 0

    @staticmethod
    def create_invalid_task() -> "Task":
        return Task(-1, TaskType.NONE, Shard())


@dataclass
class DoingTask:
    task: Task
    node_type: str
    node_id: int
    start_time: float


class DatasetManager:
    """Interface: assigns shards of one dataset to workers as tasks."""

    def __init__(self, task_type: str, batch_size: int, splitter):
        self._task_type = task_type
        self._batch_size = batch_size
        self._splitter: DatasetSplitter = splitter

    def get_task(self, node_type, node_id) -> Task:
        raise NotImplementedError

    def report_task_status(self, task_id: int, success: bool):
        raise NotImplementedError

    def completed(self) -> bool:
        raise NotImplementedError


class BatchDatasetManager(DatasetManager):
    def __init__(self, task_type: str, batch_size: int, dataset_splitter):
        super().__init__(task_type, batch_size, dataset_splitter)
        self.todo: List[Task] = []
        self.doing: Dict[int, DoingTask] = {}
        self._max_task_completed_time = 0.0
        self._task_id = 0
        self._completed_step = 0

    @property
    def completed_step(self) -> int:
        return self._completed_step

    def get_task(self, node_type, node_id) -> Task:
        if not self.todo and not self._splitter.epoch_finished():
            # Start a new epoch.
            self._splitter.create_shards()
            shards = self._splitter.get_shards()
            self._create_tasks(shards)
        if not self.todo:
            return Task.create_invalid_task()
        task = self.todo.pop(0)
        self.doing[task.task_id] = DoingTask(
            task, node_type, node_id, time.time()
        )
        return task

    def _create_tasks(self, shards: list[Shard]):
        for shard in shards:
            self.todo.append(Task(self._task_id, self._task_type, shard))
            self._task_id += 1

    def report_task_status(self, task_id: int, success: bool):
        doing_task = self.doing.pop(task_id, None)
        if doing_task is None:
            # master-failover path: a restore re-queued the worker's
            # in-flight task into todo under its ORIGINAL id, and the
            # (still-alive) worker just finished it — accept the
            # completion instead of handing the shard out a second time
            for i, task in enumerate(self.todo):
                if task.task_id == task_id:
                    doing_task = DoingTask(
                        self.todo.pop(i), "", -1, time.time()
                    )
                    break
        if doing_task is None:
            logger.warning("unknown or timed-out task %s reported", task_id)
            return False, None
        if not success:
            logger.warning(
                "task %s failed on %s-%s; requeue",
                task_id,
                doing_task.node_type,
                doing_task.node_id,
            )
            doing_task.task.retry_count += 1
            self.todo.append(doing_task.task)
            return False, doing_task
        elapsed = time.time() - doing_task.start_time
        self._max_task_completed_time = max(
            self._max_task_completed_time, elapsed
        )
        if doing_task.task.task_type == TaskType.TRAINING:
            shard_records = (
                doing_task.task.shard.end - doing_task.task.shard.start
            )
            self._completed_step += max(
                shard_records // max(self._batch_size, 1), 1
            )
        return True, doing_task

    def reset_doing_tasks_timeout(self, timeout: float | None = None):
        """Requeue tasks whose worker went silent. Default timeout is
        3x the historical max completion time (reference task recovery)."""
        if timeout is None:
            timeout = max(3 * self._max_task_completed_time, 600)
        now = time.time()
        expired = [
            tid
            for tid, dt in self.doing.items()
            if now - dt.start_time > timeout
        ]
        for tid in expired:
            doing_task = self.doing.pop(tid)
            logger.warning("task %s timed out; requeue", tid)
            self.todo.append(doing_task.task)
        return expired

    def recover_tasks_of_node(self, node_type: str, node_id: int):
        """Requeue every doing task of a failed worker."""
        ids = [
            tid
            for tid, dt in self.doing.items()
            if dt.node_type == node_type and dt.node_id == node_id
        ]
        for tid in ids:
            doing_task = self.doing.pop(tid)
            self.todo.append(doing_task.task)
        if ids:
            logger.info(
                "recovered %d tasks of %s-%s", len(ids), node_type, node_id
            )

    def completed(self) -> bool:
        return (
            not self.todo
            and not self.doing
            and self._splitter.epoch_finished()
        )

    def get_epoch(self) -> int:
        return self._splitter.get_epoch()

    # -- mid-job shard checkpoint (reference get/restore shard ckpt) -------

    def checkpoint(self) -> str:
        # the 4th element (task id) lets a failover restore preserve the
        # ids live workers still hold; pre-id checkpoints (3 elements)
        # restore fine with fresh ids
        todo_ranges = [
            [t.shard.start, t.shard.end, t.shard.record_indices,
             t.task_id]
            for t in self.todo
        ]
        doing_ranges = [
            [d.task.shard.start, d.task.shard.end,
             d.task.shard.record_indices, d.task.task_id]
            for d in self.doing.values()
        ]
        return json.dumps(
            {
                "todo": todo_ranges,
                "doing": doing_ranges,
                "epoch": self._splitter.get_epoch(),
                "completed_step": self._completed_step,
                "dataset_name": self._splitter.dataset_name,
                # ids a worker still holds across a master failover must
                # never collide with freshly assigned ones — a stale
                # completion report acking a DIFFERENT shard would break
                # exactly-once accounting
                "next_task_id": self._task_id,
            }
        )

    def restore_checkpoint(self, content: str):
        state = json.loads(content)
        self.todo.clear()
        self.doing.clear()
        self._splitter.epoch = state.get("epoch", 0)
        self._completed_step = state.get("completed_step", 0)
        self._task_id = max(
            self._task_id, int(state.get("next_task_id", 0))
        )
        # doing tasks were in flight at ckpt time -> back to todo first,
        # KEEPING their original ids where the checkpoint recorded them:
        # a live worker finishing one across a master failover reports
        # that id, and report_task_status completes it out of todo
        for entry in state.get("doing", []) + state.get("todo", []):
            start, end, indices = entry[0], entry[1], entry[2]
            task_id = entry[3] if len(entry) > 3 else None
            if task_id is None:
                task_id = self._task_id
                self._task_id += 1
            else:
                self._task_id = max(self._task_id, task_id + 1)
            self.todo.append(Task(
                task_id,
                self._task_type,
                Shard(
                    name=state.get("dataset_name", ""),
                    start=start,
                    end=end,
                    record_indices=indices,
                ),
            ))

    # -- WAL replay (master failover) --------------------------------------
    #
    # Replay records carry absolute state (task id + shard range), so
    # every method is idempotent: the state store may re-apply records
    # already reflected in the snapshot it restored.

    def replay_dispatch(
        self, task_id: int, start: int, end: int, indices,
        node_type: str = "", node_id: int = -1,
        allow_create: bool = False,
    ):
        """A task the previous master incarnation handed out: move the
        matching todo shard back into doing under its original id.

        Matched by id (an id-preserving restore) — but only when the
        range agrees, since WAL-only recovery of a shuffled dataset
        re-draws shard order and the id alone could bind a range the
        worker does not hold — else by range. ``allow_create`` is set
        ONLY for WAL-only recovery (no snapshot applied): with a
        snapshot, that state is authoritative and a dispatch that finds
        nothing was already covered by it — materializing a new epoch
        here would falsely complete a shard that was never trained."""
        if task_id in self.doing:
            self._task_id = max(self._task_id, task_id + 1)
            return
        if (
            allow_create
            and not self.todo
            and not self._splitter.epoch_finished()
        ):
            # crash before the first snapshot: materialize the epoch's
            # shards like get_task would, so the logged dispatches have
            # something to re-bind to
            self._splitter.create_shards()
            self._create_tasks(self._splitter.get_shards())
        self._task_id = max(self._task_id, task_id + 1)
        idx = next(
            (i for i, t in enumerate(self.todo)
             if t.task_id == task_id
             and t.shard.start == start and t.shard.end == end),
            None,
        )
        if idx is None:
            idx = next(
                (i for i, t in enumerate(self.todo)
                 if t.shard.start == start and t.shard.end == end),
                None,
            )
        if idx is None:
            # neither todo nor doing: the snapshot already covered the
            # completion (or the range predates it) — nothing to do
            return
        task = self.todo.pop(idx)
        task.task_id = task_id
        if indices:
            # the worker is processing the indices the ORIGINAL
            # dispatch carried; a re-shuffled re-creation may have
            # drawn different ones into this range
            task.shard.record_indices = list(indices)
        self.doing[task_id] = DoingTask(
            task, node_type, node_id, time.time()
        )

    def replay_result(self, task_id: int, success: bool):
        known = task_id in self.doing or any(
            t.task_id == task_id for t in self.todo
        )
        if known:
            self.report_task_status(task_id, success)
        # unknown id: the snapshot already covered this completion


class StreamingDatasetManager(BatchDatasetManager):
    """Unbounded stream: shards are cut as a producer reports records
    (reference streaming_dataset_manager.py). get_task returns a WAIT
    task while the stream is live but momentarily dry; the dataset only
    completes after end_stream() and a full drain."""

    def __init__(self, task_type: str, batch_size: int,
                 shard_size: int = 0, dataset_name: str = "stream"):
        # no splitter: shards come from reported records
        super().__init__(task_type, batch_size, _NullSplitter())
        self.dataset_name = dataset_name
        # never 0: a zero shard size would loop forever in _cut_shards
        self._shard_size = max(shard_size or batch_size * 2, 1)
        self._next_record = 0   # first record not yet sharded
        self._reported = 0      # total records the producer announced
        self._ended = False

    # -------------------------------------------------------- streaming

    def add_records(self, count: int) -> bool:
        """Returns False when records arrive after end-of-stream (the
        data would be silently lost otherwise)."""
        if count > 0 and self._ended:
            logger.warning(
                "streaming dataset %s: %d records fed after end-of-"
                "stream were DROPPED", self.dataset_name, count,
            )
            return False
        if count > 0:
            self._reported += int(count)
            self._cut_shards()
        return True

    def end_stream(self):
        self._ended = True
        self._cut_shards(include_tail=True)

    def _cut_shards(self, include_tail: bool = False):
        shards = []
        while self._reported - self._next_record >= self._shard_size:
            shards.append(Shard(
                name=self.dataset_name,
                start=self._next_record,
                end=self._next_record + self._shard_size,
            ))
            self._next_record += self._shard_size
        if include_tail and self._reported > self._next_record:
            shards.append(Shard(
                name=self.dataset_name,
                start=self._next_record,
                end=self._reported,
            ))
            self._next_record = self._reported
        if shards:
            self._create_tasks(shards)

    # ------------------------------------------------------- overrides

    def get_task(self, node_type, node_id) -> Task:
        if not self.todo and not self._ended:
            return Task(-1, TaskType.WAIT, Shard())
        # the base pop/doing bookkeeping applies unchanged
        # (_NullSplitter.epoch_finished() is always True)
        return super().get_task(node_type, node_id)

    def completed(self) -> bool:
        return (
            self._ended
            and not self.todo
            and not self.doing
            and self._next_record >= self._reported
        )

    def get_epoch(self) -> int:
        return 0

    def checkpoint(self) -> str:
        return json.dumps({
            "streaming": True,
            "dataset_name": self.dataset_name,
            "next_record": self._next_record,
            "reported": self._reported,
            "ended": self._ended,
            "completed_step": self._completed_step,
            "next_task_id": self._task_id,
            "todo": [
                [t.task.shard.start, t.task.shard.end, t.task.task_id]
                for t in self.doing.values()
            ] + [
                [t.shard.start, t.shard.end, t.task_id]
                for t in self.todo
            ],
        })

    def restore_checkpoint(self, content: str):
        data = json.loads(content)
        if not data.get("streaming"):
            return
        self._next_record = int(data["next_record"])
        self._reported = int(data["reported"])
        self._ended = bool(data["ended"])
        self._completed_step = int(data.get("completed_step", 0))
        self._task_id = max(
            self._task_id, int(data.get("next_task_id", 0))
        )
        self.todo.clear()
        self.doing.clear()
        for entry in data.get("todo", []):
            start, end = entry[0], entry[1]
            task_id = entry[2] if len(entry) > 2 else None
            if task_id is None:
                task_id = self._task_id
                self._task_id += 1
            else:
                self._task_id = max(self._task_id, task_id + 1)
            self.todo.append(Task(
                task_id,
                self._task_type,
                Shard(name=self.dataset_name, start=start, end=end),
            ))

    def replay_stream(self, reported: int, ended: bool):
        """Idempotent replay of producer feeds: records carry resulting
        totals, not deltas, so re-applying moves the high-water mark at
        most forward."""
        if reported > self._reported:
            self._reported = int(reported)
            self._cut_shards()
        if ended and not self._ended:
            self.end_stream()


class _NullSplitter:
    """Placeholder splitter for streaming datasets (never has epochs)."""

    def epoch_finished(self) -> bool:
        return True

    def create_shards(self):
        pass

    def get_shards(self):
        return []

    def get_epoch(self) -> int:
        return 0
