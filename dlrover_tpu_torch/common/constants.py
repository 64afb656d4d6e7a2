"""The env-var contract between agent and worker processes that the port
reads (a copy of the names it needs from ``NodeEnv`` in
dlrover_tpu/common/constants.py)."""


class NodeEnv:
    """Env-var names the agent sets for each worker process."""

    NODE_RANK = "NODE_RANK"
    # the rendezvous' coordinator (rank-0 host) address, host:port
    JAX_COORDINATOR_ADDR = "DLROVER_JAX_COORDINATOR_ADDR"
    LOCAL_RANK = "LOCAL_RANK"
    RANK = "RANK"
    WORLD_SIZE = "WORLD_SIZE"
