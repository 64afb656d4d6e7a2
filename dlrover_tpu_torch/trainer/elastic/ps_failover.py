"""Worker-side PS failover: poll the master's PS cluster version and
re-resolve when it bumps (port of
dlrover_tpu/trainer/elastic/ps_failover.py).

The "PS" is the host-side state a sparse worker depends on (KvEmbedding
tables and their tiers). On a version bump the worker runs its
``on_migrate`` callback (typically an export and re-import of the sparse
state against the migrated placement), then reports its local version
so that the master's ``all_workers_synced`` turns true again.
"""

from __future__ import annotations

import threading

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


class PsFailoverClient:
    """Poll/refresh cycle against the master's ElasticPsService."""

    def __init__(self, master_client, worker_id: int = 0):
        self._client = master_client
        self._worker_id = worker_id
        self._local_version = 0

    @property
    def local_version(self) -> int:
        return self._local_version

    def ps_version_changed(self) -> tuple[bool, int]:
        """(changed, global_version) vs the locally-applied version."""
        version = self._client.get_ps_version("global")
        return version > self._local_version, version

    def sync(self, version: int) -> None:
        """Record ``version`` as locally applied and tell the master."""
        self._local_version = version
        self._client.report_ps_version(version, "local")

    def maybe_refresh(self, on_migrate=None) -> bool:
        """One poll: if the PS cluster version bumped, run the
        migration callback and sync. Returns True when a refresh ran.

        ``on_migrate(old_version, new_version)`` does the actual
        re-resolve (rebuild sparse tables / endpoints)."""
        changed, version = self.ps_version_changed()
        if not changed:
            return False
        logger.info(
            "PS cluster version %d -> %d: re-resolving",
            self._local_version, version,
        )
        if on_migrate is not None:
            on_migrate(self._local_version, version)
        self.sync(version)
        return True


class PsFailoverMonitor:
    """Background thread running :meth:`PsFailoverClient.maybe_refresh`
    on an interval (the reference's start_failover_monitor shape)."""

    def __init__(self, client: PsFailoverClient, on_migrate,
                 interval: float = 5.0):
        self._client = client
        self._on_migrate = on_migrate
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="ps-failover", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self):
        while not self._stopped.is_set():
            try:
                self._client.maybe_refresh(self._on_migrate)
            except Exception as err:  # noqa: BLE001
                # transient master-RPC failures are expected; a failing
                # migration callback is not — either way the operator
                # needs the trace, because an unsynced worker keeps the
                # master's all_workers_synced() false forever
                logger.warning(
                    "PS failover refresh failed (will retry): %s", err,
                    exc_info=True,
                )
            self._stopped.wait(self._interval)
