"""Shared enums, env-var contracts and defaults.

Equivalent capability: reference dlrover/python/common/constants.py
(NodeType :46, NodeStatus :70, DistributionStrategy :168, RendezvousName
:252, NodeEnv :194, ExitCode :108, CheckpointConstant :283) re-expressed
for a TPU/JAX stack.
"""

import os
import tempfile


class PlatformType:
    LOCAL = "local"
    KUBERNETES = "k8s"
    RAY = "ray"


class DistributionStrategy:
    """How training processes relate to each other."""

    LOCAL = "Local"
    # Single SPMD program over a jax device mesh (the TPU analogue of the
    # reference's AllreduceStrategy — every worker runs the same program).
    SPMD = "AllreduceStrategy"
    # Parameter-server style (kept for API parity; sparse/PS jobs).
    PS = "ParameterServerStrategy"
    CUSTOM = "CustomStrategy"


class NodeType:
    MASTER = "dlrover-master"
    CHIEF = "chief"
    WORKER = "worker"
    PS = "ps"
    EVALUATOR = "evaluator"


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    FINISHED = "finished"
    DELETED = "deleted"
    BREAKDOWN = "breakdown"
    UNKNOWN = "unknown"

    @classmethod
    def end_states(cls):
        return {cls.SUCCEEDED, cls.FAILED, cls.FINISHED, cls.DELETED}


class NodeEventType:
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


class NodeExitReason:
    SUCCEEDED = "Succeeded"
    KILLED = "Deleted"
    OOM = "OOMKilled"
    FATAL_ERROR = "Error"
    HARDWARE_ERROR = "HardwareError"
    RELAUNCHED = "Relaunched"
    # TPU-specific: the per-host agent could not initialise libtpu /
    # enumerate devices, or XLA raised a device-level runtime error.
    DEVICE_ERROR = "DeviceError"
    PENDED_TIMEOUT = "PendedTimeout"
    UNKNOWN_ERROR = "UnknownError"


class ExitCode:
    """Process exit-code taxonomy used by the agent to classify failures.

    The reference encodes hardware-vs-software failure in worker exit codes
    (constants.py:108, training.py:353-356); we keep the same taxonomy and
    add a code for TPU device/runtime failures.
    """

    SUCCEEDED = 0
    FATAL_ERROR = 1
    KILLED = 137  # SIGKILL
    TERMED = 143  # SIGTERM
    CORE_DUMP = 134  # SIGABRT, e.g. libtpu abort
    OOM = 247
    SEGV = 139
    GPU_DRIVER_ERROR = 201
    RDMA_DRIVER_ERROR = 202
    EXECUTE_TIMEOUT = 203
    # Agent-detected TPU device initialisation / runtime failure.
    DEVICE_ERROR = 205
    NETWORK_CHECK_FAILED = 206

    HARDWARE_ERRORS = (
        GPU_DRIVER_ERROR,
        RDMA_DRIVER_ERROR,
        EXECUTE_TIMEOUT,
        DEVICE_ERROR,
        NETWORK_CHECK_FAILED,
        CORE_DUMP,
    )


class JobExitReason:
    SUCCEEDED = "Completed"
    CODE_ERROR = "CodeError"
    WORKER_OOM = "WorkerOOM"
    WORKER_ERROR = "WorkerError"
    PS_OOM = "PSOOM"
    PS_ERROR = "PSError"
    EVALUATOR_OOM = "EvaluatorOOM"
    EVALUATOR_ERROR = "EvaluatorError"
    PENDING_TIMEOUT = "PendingTimeout"
    RDZV_TIMEOUT = "RendezvousTimeout"
    UNKNOWN_ERROR = "UnknownError"
    HANG_ERROR = "HangError"


class RendezvousName:
    ELASTIC_TRAINING = "elastic-training"
    NETWORK_CHECK = "network-check"
    # the elastic serving arm's decode workers join the SAME master
    # through this node group (role=decode): liveness, drain/removal,
    # failover and chaos all ride the existing rendezvous paths
    DECODE_POOL = "decode-pool"


class NetworkFailureReason:
    NO_INIT = "Not initialized"
    NODE_FAILURE = "Node failure"
    WAITING_NODE = "Waiting node"


class Accelerators:
    TPU = "tpu"
    NVIDIA_GPU = "nvidia.com/gpu"
    CPU = "cpu"


class TrainingExceptionLevel:
    RDZV_ERROR = "rdzv_error"
    PROCESS_ERROR = "process_error"
    NODE_ERROR = "node_error"
    WARNING = "warning"
    INFO = "info"
    ERROR = "error"


class NodeEnv:
    """Env-var contract between master/agent/worker processes.

    Equivalent of the reference NodeEnv (constants.py:194-221).
    """

    RELAUNCHED_POD = "RELAUNCHED_POD"
    DLROVER_MASTER_ADDR = "DLROVER_MASTER_ADDR"
    # A file holding the master's current host:port (written atomically
    # by ``master.main --addr-file``). Clients re-read it when a
    # connection dies, so a master restarted on a NEW port after a
    # failover is picked up without respawning workers.
    DLROVER_MASTER_ADDR_FILE = "DLROVER_MASTER_ADDR_FILE"
    GRPC_ENABLE_FORK = "GRPC_ENABLE_FORK_SUPPORT"
    POD_NAME = "POD_NAME"
    MONITOR_ENABLED = "MONITOR_ENABLED"
    JOB_NAME = "ELASTIC_JOB_NAME"
    JOB_UID = "JOB_UID"
    NODE_TYPE = "NODE_TYPE"
    NODE_ID = "NODE_ID"
    NODE_NUM = "NODE_NUM"
    NODE_RANK = "NODE_RANK"
    AUTO_MONITOR_WORKLOAD = "AUTO_MONITOR_WORKLOAD"
    # JAX coordination (replaces torch MASTER_ADDR/MASTER_PORT).
    JAX_COORDINATOR_ADDR = "DLROVER_JAX_COORDINATOR_ADDR"
    JAX_PROCESS_ID = "DLROVER_JAX_PROCESS_ID"
    JAX_NUM_PROCESSES = "DLROVER_JAX_NUM_PROCESSES"
    # Fault injection for node-check payloads (reference
    # node_check/utils.py:50 MOCK_ERR_RANK).
    MOCK_ERR_RANK = "MOCK_ERR_RANK"
    # Worker process-local contract.
    LOCAL_RANK = "LOCAL_RANK"
    RANK = "RANK"
    WORLD_SIZE = "WORLD_SIZE"
    LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"
    GROUP_RANK = "GROUP_RANK"
    # Master-brokered restore-step consensus (the newest checkpoint
    # step restorable on every member of the rendezvous round): when
    # set, checkpoint engines restore exactly this step instead of
    # their local newest.
    RESTORE_STEP = "DLROVER_TPU_RESTORE_STEP"
    RESTART_COUNT = "TORCHELASTIC_RESTARTS"
    # Restart-free elasticity: directory of the agent<->worker reshape
    # channel (trainer/elastic/reshape.py). When set, the Trainer
    # installs a reshape watcher and advertises readiness; the agent
    # then signals membership changes into the live worker instead of
    # restarting it.
    RESHAPE_DIR = "DLROVER_TPU_RESHAPE_DIR"


class ConfigPath:
    """Well-known runtime file paths (paral-config hot-reload contract),
    by default in a directory of the port's own under the temp dir, so a
    JAX-package agent on the same host never reads or writes them."""

    _DIR = os.path.join(tempfile.gettempdir(), "dlrover_tpu_torch")
    ENV_PARAL_CONFIG = "DLROVER_PARAL_CONFIG_PATH"
    PARAL_CONFIG = os.path.join(_DIR, "auto_paral_config.json")
    ENV_RUNTIME_METRICS = "DLROVER_RUNTIME_METRICS_PATH"
    RUNTIME_METRICS = os.path.join(_DIR, "runtime_metrics.json")
    ENV_KERNEL_METRICS = "DLROVER_KERNEL_METRICS_PATH"
    KERNEL_METRICS = os.path.join(_DIR, "kernel_metrics.json")


class CheckpointConstant:
    """Flash-checkpoint layout contract (reference constants.py:283)."""

    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    MODEL_STATES_NAME = "model_states"
    OPTIM_STATES_NAME = "optim_states"
    DONE_FILE = ".done"
    STEP_DIR_PREFIX = "checkpoint-"
    SAVE_TIMEOUT = 600


class RendezvousEnv:
    TIMEOUT = "RDZV_TIMEOUT"


class JobConstant:
    RDZV_JOIN_TIMEOUT_DEFAULT = 600
    NODE_HEARTBEAT_TIMEOUT = 180
    MASTER_CLIENT_TIMEOUT = 30
    TRAINING_AGENT_LOOP_INTERVAL = 5
    MONITOR_INTERVAL = 15
    PENDING_TIMEOUT = 900
    SECTION_LOOP_INTERVAL = 30
    # how long an agent rides out an unreachable master (workers keep
    # training) before logging the outage as lost and re-probing
    MASTER_RIDE_THROUGH_DEFAULT = 300.0


class GRPC:
    """Transport limits for the control-plane RPC."""

    MAX_SEND_MESSAGE_LENGTH = 256 * 1024 * 1024
    MAX_RECEIVE_MESSAGE_LENGTH = 256 * 1024 * 1024


class TaskType:
    """Data-shard task types handed to workers."""

    NONE = "none"
    # streaming dataset: no data available yet, client should retry
    WAIT = "wait"
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
    WAIT = "wait"
    TRAIN_END_CALLBACK = "train_end_callback"


class DatasetType:
    TEXT = "text"
    TABLE = "table"


class PriorityClass:
    LOW = "low"
    HIGH = "high"


class SchedulingLabel:
    NODE_GROUP = "node-group"


class OptimizeMode:
    MANUAL = "manual"
    SINGLE_JOB = "single-job"
    CLUSTER = "cluster"


class ReporterType:
    LOCAL = "local"
    DLROVER_BRAIN = "brain"


class MemoryUnit:
    MB = 1024 * 1024
    GB = 1024 * 1024 * 1024
