"""Standalone brain service entry: ``python -m dlrover_tpu_torch.brain.main``.

Equivalent capability: reference dlrover/go/brain cmd/brain service
process (one brain serves many jobs' masters).

The PyTorch port's copy of dlrover_tpu/brain/main.py; like the JAX
package's, it imports no torch.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from dlrover_tpu_torch.brain.datastore import MetricsStore
from dlrover_tpu_torch.brain.service import create_brain_service
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("dlrover-tpu-torch brain")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument(
        "--db",
        default=os.path.join(tempfile.gettempdir(), "dlrover_tpu_torch",
                             "brain.sqlite"),
        help="sqlite path (':memory:' for ephemeral)",
    )
    args = parser.parse_args(argv)
    store = MetricsStore(args.db)
    server, _service = create_brain_service(args.port, store)
    server.start()
    print(f"DLROVER_BRAIN_ADDR=127.0.0.1:{server.port}", flush=True)
    logger.info("brain serving on port %s (db=%s)", server.port, args.db)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return 0
    finally:
        server.stop()


if __name__ == "__main__":
    raise SystemExit(main())
