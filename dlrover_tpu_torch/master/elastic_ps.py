"""ElasticPsService: PS-cluster version management.

Equivalent capability: reference dlrover/python/master/elastic_training/
elastic_ps.py:18 — when parameter-server style workers (on TPU: host-side
sparse-embedding/data workers) migrate or scale, the master bumps a
cluster version; workers poll it and rebuild their connections when it
changes (the TF_CONFIG-rebuild flow of the reference's
TensorflowFailover).

The PyTorch port's copy of dlrover_tpu/master/elastic_ps.py.
"""

from __future__ import annotations

import threading


class ElasticPsService:
    GLOBAL = "global"
    LOCAL = "local"
    RESTORED = "restored"

    def __init__(self):
        self._lock = threading.Lock()
        self._global_version = 0
        # worker id -> locally-applied version
        self._local_versions: dict[int, int] = {}
        self._restored_version = 0

    def inc_global_cluster_version(self) -> int:
        """Call on PS membership change (scale/migration)."""
        with self._lock:
            self._global_version += 1
            return self._global_version

    def get_ps_version(self, version_type: str = GLOBAL,
                       worker_id: int = 0) -> int:
        with self._lock:
            if version_type == self.LOCAL:
                return self._local_versions.get(worker_id, 0)
            if version_type == self.RESTORED:
                return self._restored_version
            return self._global_version

    def update_ps_version(self, worker_id: int, version_type: str,
                          version: int) -> None:
        with self._lock:
            if version_type == self.LOCAL:
                self._local_versions[worker_id] = version
            elif version_type == self.RESTORED:
                self._restored_version = version
            else:
                self._global_version = max(self._global_version, version)

    def all_workers_synced(self) -> bool:
        with self._lock:
            if not self._local_versions:
                return True
            return all(
                v >= self._global_version
                for v in self._local_versions.values()
            )
