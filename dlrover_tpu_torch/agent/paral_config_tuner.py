"""ParalConfigTuner: agent-side runtime-tunable parallel config.

Equivalent capability: reference dlrover/python/elastic_agent/config/
paral_config_tuner.py:30 — polls the master every ``interval`` seconds for
the node's ``ParallelConfig`` and writes it as JSON to the path the trainer
watches (``DLROVER_PARAL_CONFIG_PATH``), so dataloader batch size /
optimizer hyperparams hot-update without a restart
(:class:`~dlrover_tpu_torch.trainer.elastic.ElasticDataLoader` reads this file).

The PyTorch port's copy of dlrover_tpu/agent/paral_config_tuner.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

from dlrover_tpu_torch.common.constants import ConfigPath
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.retry import NonCriticalGuard
from dlrover_tpu_torch.agent.master_client import MasterClient

logger = get_logger(__name__)


class ParalConfigTuner:
    def __init__(self, client: MasterClient | None = None,
                 config_path: str | None = None,
                 interval: float = 30.0):
        self._client = client or MasterClient.singleton_instance()
        self._config_path = config_path or os.getenv(
            ConfigPath.ENV_PARAL_CONFIG, ConfigPath.PARAL_CONFIG
        )
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_written: str = ""
        # tuning is best-effort: exhausted retry budgets degrade the
        # tuner to off (the trainer keeps its last config) rather than
        # hammering a dead master forever
        self._guard = NonCriticalGuard("paral-config-tuner")
        # export the path so worker processes spawned later inherit it
        os.environ[ConfigPath.ENV_PARAL_CONFIG] = self._config_path

    @property
    def degraded(self) -> bool:
        return self._guard.disabled

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="paral-config-tuner", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _run(self):
        while not self._stopped.is_set():
            try:
                self.tune_once()
            except Exception:  # noqa: BLE001
                logger.exception("paral-config poll failed")
            if self._guard.disabled:
                logger.warning(
                    "paral-config tuner degraded; stopping the poll loop"
                )
                return
            self._stopped.wait(self._interval)

    def tune_once(self) -> bool:
        """One poll+write cycle; returns True if the file was (re)written."""
        if self._client is None:
            return False
        config = self._guard.run(self._client.get_paral_config)
        if config is None:
            return False
        payload = json.dumps(dataclasses.asdict(config), sort_keys=True)
        if payload == self._last_written:
            return False
        config_dir = os.path.dirname(self._config_path)
        if config_dir:
            os.makedirs(config_dir, exist_ok=True)
        tmp = self._config_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, self._config_path)
        self._last_written = payload
        logger.info("paral config updated: %s", payload[:200])
        return True
