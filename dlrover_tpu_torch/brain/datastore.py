"""MetricsStore: sqlite-backed historical job metrics.

Equivalent capability: reference dlrover/go/brain MySQL datastore
(pkg/datastore/recorder/mysql/) — job metrics/node records persisted for
cross-job optimization. sqlite keeps the capability dependency-free; the
schema is one table of (job_uuid, job_name, timestamp, metrics-json).

The PyTorch port's copy of dlrover_tpu/brain/datastore.py; like the JAX
package's, it imports no torch.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time


class MetricsStore:
    def __init__(self, path: str = ":memory:"):
        if path != ":memory:":
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # one connection guarded by a lock: the brain service is
        # low-QPS control plane
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS job_metrics ("
                " id INTEGER PRIMARY KEY AUTOINCREMENT,"
                " job_uuid TEXT NOT NULL,"
                " job_name TEXT NOT NULL,"
                " timestamp REAL NOT NULL,"
                " metrics TEXT NOT NULL)"
            )
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_job_uuid ON "
                "job_metrics(job_uuid)"
            )
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_job_name ON "
                "job_metrics(job_name)"
            )
            self._conn.commit()

    def persist(self, job_uuid: str, job_name: str, metrics: dict,
                timestamp: float | None = None):
        with self._lock:
            self._conn.execute(
                "INSERT INTO job_metrics (job_uuid, job_name, timestamp,"
                " metrics) VALUES (?, ?, ?, ?)",
                (job_uuid, job_name, timestamp or time.time(),
                 json.dumps(metrics)),
            )
            self._conn.commit()

    def job_records(self, job_uuid: str, limit: int = 1000) -> list[dict]:
        """Newest-first records for one job."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT timestamp, metrics FROM job_metrics WHERE "
                "job_uuid = ? ORDER BY timestamp DESC LIMIT ?",
                (job_uuid, limit),
            ).fetchall()
        return [
            {"timestamp": ts, **json.loads(m)} for ts, m in rows
        ]

    def similar_job_records(self, job_name: str,
                            limit_jobs: int = 20) -> list[list[dict]]:
        """Latest record of each distinct recent job sharing job_name
        (the cold-create 'similar historical jobs' source)."""
        with self._lock:
            uuids = [
                r[0] for r in self._conn.execute(
                    "SELECT job_uuid, MAX(timestamp) AS t FROM "
                    "job_metrics WHERE job_name = ? GROUP BY job_uuid "
                    "ORDER BY t DESC LIMIT ?",
                    (job_name, limit_jobs),
                ).fetchall()
            ]
        return [self.job_records(u, limit=50) for u in uuids]

    def close(self):
        with self._lock:
            self._conn.close()
