"""Wire (de)serialization for control-plane messages.

The reference ships pickled dataclasses over gRPC
(dlrover/python/common/grpc.py:115 ``deserialize_message``). We keep the
dataclass-on-the-wire model but restrict unpickling to an explicit
allowlist so an exposed control-plane endpoint cannot be used for
arbitrary code execution: only dlrover_tpu_torch message/dataclass types plus a
closed set of safe container/scalar constructors may be resolved by the
GLOBAL opcode. In particular nothing from ``builtins`` beyond plain
containers is reachable (no ``getattr``/``__import__`` gadget chain).

The PyTorch port's copy of dlrover_tpu/common/serialize.py; its
allowlist admits this package's classes (``dlrover_tpu_torch.``), never
the JAX package's.
"""

from __future__ import annotations

import io
import pickle

# module -> allowed names; None means any name in the module is allowed.
_SAFE_GLOBALS: dict[str, set | None] = {
    "builtins": {
        "list",
        "dict",
        "set",
        "frozenset",
        "tuple",
        "bytes",
        "bytearray",
        "str",
        "int",
        "float",
        "bool",
        "complex",
        "slice",
        "range",
    },
    "collections": {"OrderedDict", "defaultdict", "deque"},
    "datetime": {"datetime", "date", "time", "timedelta", "timezone"},
    "numpy": {"ndarray", "dtype", "float32", "float64", "int32", "int64"},
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},
    # numpy >= 2 pickles array data through _frombuffer (a plain
    # bytes -> ndarray constructor; no code execution surface)
    "numpy.core.numeric": {"_frombuffer"},
    "numpy._core.numeric": {"_frombuffer"},
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("dlrover_tpu_torch."):
            return super().find_class(module, name)
        allowed = _SAFE_GLOBALS.get(module)
        if allowed is not None and (name in allowed):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"global '{module}.{name}' is not in the allowlist"
        )


def serialize_message(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def deserialize_message(data: bytes):
    if not data:
        return None
    return _RestrictedUnpickler(io.BytesIO(data)).load()
