"""ctypes bindings for libdlrtpu (native runtime helpers).

Equivalent capability: the binding layer the reference gets from torch
C++ extensions / pybind (atorch/atorch/ops/op_builder JIT build + load).
Here: ``dlrtpu.cc`` beside this file is compiled on first use with g++
(plain ``extern "C"`` + ctypes), cached in ``build/`` beside it, and
every entry point has a pure-Python fallback so the framework works
without a toolchain.

Surface:
- :func:`scatter_copy` — multi-threaded GIL-released scatter memcpy for
  the flash-checkpoint HBM->shm hot path
- :func:`gather_copy` — the restore counterpart: threaded copy OUT of one
  big buffer (shm segment) into scattered destination arrays
- :func:`crc32` — zlib-compatible checksum (always zlib; see docstring)
- :func:`crc32_combine` / :func:`crc32_parallel` — GF(2) chunk-CRC merge
  and the combine-based threaded CRC built on it (zlib lacks both)
- :func:`prefault` — threaded page touch for fresh shm segments (the
  cold-save fault-in tax, paid across cores)
- :class:`TimerRing` — shared-memory timing ring (xpu_timer analogue)

The PyTorch port's copy of dlrover_tpu/native/__init__.py: it builds
and loads the copy of ``dlrtpu.cc`` in this directory, never the JAX
package's source or library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# The port's own copy of the source, built into its own directory: a
# rebuild here can never replace the library another package loads.
_SRC_DIR = os.path.dirname(os.path.abspath(__file__))

# Sanitizer selection (DLROVER_TPU_NATIVE_SANITIZE, read ONCE at
# import): each variant builds to its own suffixed filename — matching
# the Makefile's asan/ubsan/tsan targets — so a sanitized build can
# never mix with a normal one in build/, and the stale-source
# rebuild logic below applies per variant. Loading a sanitized .so
# into an unsanitized python needs the runtime preloaded (see
# the JAX package's tests/test_native_sanitized.py for the LD_PRELOAD
# recipe).
_SAN_FLAGS = {
    "asan": ["-fsanitize=address", "-fno-omit-frame-pointer", "-g"],
    "ubsan": [
        "-fsanitize=undefined", "-fno-sanitize-recover=undefined", "-g",
    ],
    "asan-ubsan": [
        "-fsanitize=address,undefined",
        "-fno-sanitize-recover=undefined",
        "-fno-omit-frame-pointer", "-g",
    ],
    "tsan": ["-fsanitize=thread", "-g"],
}
_SAN_ALIASES = {
    "address": "asan", "undefined": "ubsan", "thread": "tsan",
    "asan,ubsan": "asan-ubsan", "ubsan,asan": "asan-ubsan",
    "address,undefined": "asan-ubsan",
}


def _resolve_san_tag(raw: str) -> str:
    tag = raw.strip().lower().replace(" ", "")
    tag = _SAN_ALIASES.get(tag, tag)
    if tag and tag not in _SAN_FLAGS:
        logger.warning(
            "unknown DLROVER_TPU_NATIVE_SANITIZE=%r (want one of %s); "
            "using the normal build", raw, sorted(_SAN_FLAGS),
        )
        return ""
    return tag


_SAN_TAG = _resolve_san_tag(
    os.environ.get("DLROVER_TPU_NATIVE_SANITIZE", "")
)
_LIB_PATH = os.path.join(
    _SRC_DIR, "build",
    f"libdlrtpu.{_SAN_TAG}.so" if _SAN_TAG else "libdlrtpu.so",
)

_lib = None
_lib_lock = threading.Lock()
_load_attempted = False


def sanitize_tag() -> str:
    """The active sanitizer variant ('' = normal build)."""
    return _SAN_TAG


class _CopySeg(ctypes.Structure):
    # src is const char* on the C side; c_void_p lets us assign a raw
    # numpy data address without ctypes trying to own the string
    _fields_ = [
        ("src", ctypes.c_void_p),
        ("dst_offset", ctypes.c_uint64),
        ("size", ctypes.c_uint64),
    ]


class _Record(ctypes.Structure):
    _fields_ = [
        ("tag", ctypes.c_uint64),
        ("start_ns", ctypes.c_uint64),
        ("dur_ns", ctypes.c_uint64),
        ("seq", ctypes.c_uint64),  # seqlock word (see dlrtpu.cc)
    ]


def _try_build() -> bool:
    src = os.path.join(_SRC_DIR, "dlrtpu.cc")
    if not os.path.exists(src):
        return False
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    # compile to a per-process temp file and os.replace it in: concurrent
    # first-use builds from several worker processes each produce a
    # complete .so and atomically install it — no process can ever CDLL a
    # truncated file
    tmp_path = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        os.environ.get("CXX", "g++"), "-O3", "-shared", "-fPIC",
        "-pthread", "-std=c++17",
        *(_SAN_FLAGS.get(_SAN_TAG, ())),
        "-o", tmp_path, src,
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, timeout=120
        )
        os.replace(tmp_path, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("libdlrtpu build failed (%s); using fallbacks", e)
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        return False


def _bind(lib):
    lib.dlrtpu_scatter_copy.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_CopySeg), ctypes.c_uint64,
        ctypes.c_int,
    ]
    lib.dlrtpu_scatter_copy.restype = None
    # GatherSeg has the same {ptr, u64, u64} layout as CopySeg
    lib.dlrtpu_gather_copy.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_CopySeg), ctypes.c_uint64,
        ctypes.c_int,
    ]
    lib.dlrtpu_gather_copy.restype = None
    lib.dlrtpu_prefault.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.dlrtpu_prefault.restype = None
    lib.dlrtpu_crc32.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
    ]
    lib.dlrtpu_crc32.restype = ctypes.c_uint32
    lib.dlrtpu_crc32_combine.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
    ]
    lib.dlrtpu_crc32_combine.restype = ctypes.c_uint32
    lib.dlrtpu_crc32_parallel.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int,
    ]
    lib.dlrtpu_crc32_parallel.restype = ctypes.c_uint32
    lib.dlrtpu_ring_bytes.argtypes = [ctypes.c_uint64]
    lib.dlrtpu_ring_bytes.restype = ctypes.c_uint64
    lib.dlrtpu_ring_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.dlrtpu_ring_init.restype = None
    lib.dlrtpu_ring_push.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64
    ]
    lib.dlrtpu_ring_push.restype = None
    lib.dlrtpu_ring_drain.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_Record), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.dlrtpu_ring_drain.restype = ctypes.c_uint64
    return lib


def get_lib():
    """The loaded native library, or None (fallbacks in effect)."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("DLROVER_TPU_DISABLE_NATIVE"):
            return None
        try:
            if not os.path.exists(_LIB_PATH) or _lib_stale():
                if not _try_build() and not os.path.exists(_LIB_PATH):
                    return None
            lib = ctypes.CDLL(_LIB_PATH)
            if not hasattr(lib, "dlrtpu_gather_copy"):
                # prebuilt .so from an older source without the restore-
                # path symbols: rebuild and reload (os.replace swapped
                # the inode, so CDLL picks up the fresh file)
                if not _try_build():
                    logger.warning(
                        "libdlrtpu is stale and rebuild failed; "
                        "using fallbacks"
                    )
                    return None
                lib = ctypes.CDLL(_LIB_PATH)
            _lib = _bind(lib)
            logger.info(
                "libdlrtpu loaded from %s%s", _LIB_PATH,
                f" (sanitize={_SAN_TAG})" if _SAN_TAG else "",
            )
        except (OSError, AttributeError) as e:
            logger.warning("libdlrtpu load failed (%s); using fallbacks", e)
            _lib = None
    return _lib


def _lib_stale() -> bool:
    """True when the source is newer than the cached build."""
    src = os.path.join(_SRC_DIR, "dlrtpu.cc")
    try:
        return os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    except OSError:
        return False


def native_available() -> bool:
    return get_lib() is not None


# ------------------------------------------------------------------ copy


def scatter_copy(dst_buf, parts, nthreads: int = 8) -> bool:
    """Copy ``parts`` = [(dst_offset, ndarray), ...] into ``dst_buf``
    (a writable buffer, e.g. shm memoryview). Returns True if the native
    path ran; False means the caller must fall back.

    The C call releases the GIL and fans out over a thread pool, so
    multi-GB checkpoint copies run at memory bandwidth instead of
    single-thread numpy speed.
    """
    import numpy as np

    lib = get_lib()
    if lib is None or not parts:
        return lib is not None
    dst = (ctypes.c_char * len(dst_buf)).from_buffer(dst_buf)
    segs = (_CopySeg * len(parts))()
    keepalive = []
    for i, (offset, arr) in enumerate(parts):
        flat = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        if int(offset) + flat.nbytes > len(dst_buf):
            raise ValueError(
                f"scatter_copy overrun: offset {offset} + {flat.nbytes} "
                f"bytes exceeds buffer of {len(dst_buf)}"
            )
        keepalive.append(flat)
        segs[i].src = flat.ctypes.data
        segs[i].dst_offset = int(offset)
        segs[i].size = flat.nbytes
    lib.dlrtpu_scatter_copy(
        ctypes.addressof(dst), segs, len(parts), int(nthreads)
    )
    del dst
    return True


def gather_copy(src_buf, parts, nthreads: int = 8) -> bool:
    """Copy ``parts`` = [(src_offset, dst_ndarray), ...] OUT of
    ``src_buf`` (e.g. the shm checkpoint segment) into the destination
    arrays — the restore counterpart of :func:`scatter_copy`. Returns
    True if the native path ran; False means the caller must fall back.

    Destinations must be C-contiguous and writable (the caller owns
    allocation so restored leaves never alias pooled memory)."""
    import numpy as np

    lib = get_lib()
    if lib is None or not parts:
        return lib is not None
    src_mv = memoryview(src_buf)
    if src_mv.ndim != 1 or src_mv.itemsize != 1:
        src_mv = src_mv.cast("B")
    segs = (_CopySeg * len(parts))()
    keepalive = []
    for i, (offset, arr) in enumerate(parts):
        if not isinstance(arr, np.ndarray):
            raise TypeError("gather_copy destinations must be ndarrays")
        flat = arr.view(np.uint8).reshape(-1)
        if not flat.flags["C_CONTIGUOUS"] or not flat.flags["WRITEABLE"]:
            raise ValueError(
                "gather_copy destination must be contiguous and writable"
            )
        if int(offset) + flat.nbytes > len(src_mv):
            raise ValueError(
                f"gather_copy overrun: offset {offset} + {flat.nbytes} "
                f"bytes exceeds source of {len(src_mv)}"
            )
        keepalive.append(flat)
        segs[i].src = flat.ctypes.data  # dst pointer (GatherSeg layout)
        segs[i].dst_offset = int(offset)  # src offset
        segs[i].size = flat.nbytes
    # resolve the source base address without copying: ctypes
    # from_buffer refuses read-only buffers, but a numpy view over the
    # same memory exposes the data pointer either way
    src_arr = np.frombuffer(src_mv, dtype=np.uint8)
    keepalive.append(src_arr)
    lib.dlrtpu_gather_copy(
        src_arr.ctypes.data, segs, len(parts), int(nthreads)
    )
    return True


def prefault(buf, nthreads: int = 8) -> bool:
    """Fault in a FRESH writable buffer's pages across threads (writes a
    zero byte per page — caller guarantees the contents are garbage).
    Returns False when the native lib is unavailable (no fallback: a
    single-threaded pre-touch just moves the same cost around)."""
    lib = get_lib()
    if lib is None:
        return False
    n = len(buf)
    if n == 0:
        return True
    base = (ctypes.c_char * n).from_buffer(buf)
    lib.dlrtpu_prefault(ctypes.addressof(base), n, int(nthreads))
    del base
    return True


# ----------------------------------------------------------------- crc32


def crc32(data, seed: int = 0) -> int:
    """zlib-compatible CRC-32.

    Always zlib: its slice-by-N implementation is ~5x faster than a
    byte-at-a-time C table loop and already releases the GIL, so a
    "native" path here would be a pessimization on multi-GB shards
    (measured: 64 MiB in 0.033s zlib vs 0.170s table-loop). The seed
    argument chains chunk CRCs, which is what the streaming read/write
    paths use; :func:`crc32_parallel` fans large in-memory payloads
    across threads via the native combine."""
    import zlib

    return zlib.crc32(data, seed) & 0xFFFFFFFF


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc(A+B) from crc(A), crc(B), len(B) — zlib's crc32_combine,
    which the Python zlib module does not expose. Native when available,
    pure-Python GF(2) fallback otherwise (small fixed cost, no payload
    pass either way)."""
    if len2 == 0:
        return crc1 & 0xFFFFFFFF
    lib = get_lib()
    if lib is not None:
        return int(
            lib.dlrtpu_crc32_combine(crc1 & 0xFFFFFFFF, crc2 & 0xFFFFFFFF,
                                     len2)
        )
    return _py_crc32_combine(crc1, crc2, len2)


def _gf2_times(mat, vec):
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _py_crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    odd = [0] * 32
    odd[0] = 0xEDB88320
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    even = [_gf2_times(odd, odd[n]) for n in range(32)]
    odd = [_gf2_times(even, even[n]) for n in range(32)]
    crc1 &= 0xFFFFFFFF
    while True:
        even = [_gf2_times(odd, odd[n]) for n in range(32)]
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if len2 == 0:
            break
        odd = [_gf2_times(even, even[n]) for n in range(32)]
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if len2 == 0:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


def crc32_parallel(data, seed: int = 0, nthreads: int = 8) -> int:
    """CRC-32 of a large in-memory payload, chunked across threads and
    merged with crc32_combine. Falls back to sequential zlib (identical
    result) when the native lib is unavailable or the payload is too
    small for threading to pay."""
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    n = len(mv)
    min_chunk = 8 << 20
    lib = get_lib()
    if lib is None or n < 2 * min_chunk or nthreads <= 1:
        return crc32(mv, seed)
    import numpy as np

    # numpy view exposes the data pointer for read-only buffers too
    arr = np.frombuffer(mv, dtype=np.uint8)
    return int(
        lib.dlrtpu_crc32_parallel(
            arr.ctypes.data, n, seed & 0xFFFFFFFF, int(nthreads)
        )
    )


# ------------------------------------------------------------ timer ring


class TimerRing:
    """Shared-memory timing ring (the xpu_timer capability, TPU-style).

    Training processes :meth:`push` (tag, start_ns, dur_ns) records —
    e.g. per-step wall time, data waits and checkpoint copies
    — into a shm segment; the agent :meth:`drain`-s and exports them.
    Works without the native lib via a pure-Python layout-compatible path.
    """

    HEADER = 16  # uint64 capacity + uint64 head
    REC = 32     # tag, start_ns, dur_ns, seq

    def __init__(self, buf, capacity: int = 4096, init: bool = True,
                 lock_path: str | None = None):
        """``buf``: writable buffer of at least ring_bytes(capacity).

        ``lock_path``: advisory file lock used by the pure-Python
        fallback to make cross-process push/drain atomic (the native
        path needs no lock — per-slot seqlocks)."""
        self._buf = buf
        self._capacity = capacity
        self._cursor = ctypes.c_uint64(0)
        self._lock_path = lock_path
        self._cbuf = (ctypes.c_char * len(buf)).from_buffer(buf)
        if init:
            lib = get_lib()
            if lib is not None:
                lib.dlrtpu_ring_init(
                    ctypes.addressof(self._cbuf), capacity
                )
            else:
                self._py_init()

    @classmethod
    def ring_bytes(cls, capacity: int) -> int:
        return cls.HEADER + capacity * cls.REC

    # -- pure-python layout-compatible fallback ---------------------------
    # NOT lock-free: the head read-modify-write needs the advisory file
    # lock for multi-process safety (single-process use needs nothing).

    def _py_lock(self):
        import contextlib

        @contextlib.contextmanager
        def locked():
            if self._lock_path is None:
                yield
                return
            import fcntl

            with open(self._lock_path, "w") as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lf, fcntl.LOCK_UN)

        return locked()

    def _py_init(self):
        import struct

        self._buf[:16] = struct.pack("<QQ", self._capacity, 0)

    def _py_push(self, tag, start_ns, dur_ns):
        import struct

        with self._py_lock():
            self._py_push_locked(tag, start_ns, dur_ns, struct)

    def _py_push_locked(self, tag, start_ns, dur_ns, struct):
        cap, head = struct.unpack("<QQ", bytes(self._buf[:16]))
        slot = head % cap
        off = self.HEADER + slot * self.REC
        self._buf[off:off + self.REC] = struct.pack(
            "<QQQQ", tag, start_ns, dur_ns, 2 * head + 2
        )
        self._buf[8:16] = struct.pack("<Q", head + 1)

    def _py_drain(self, max_records):
        import struct

        cap, head = struct.unpack("<QQ", bytes(self._buf[:16]))
        cur = self._cursor.value
        if head > cur + cap:
            cur = head - cap
        out = []
        while cur < head and len(out) < max_records:
            off = self.HEADER + (cur % cap) * self.REC
            tag, start_ns, dur_ns, seq = struct.unpack(
                "<QQQQ", bytes(self._buf[off:off + self.REC])
            )
            cur += 1
            if seq != 2 * (cur - 1) + 2:
                continue  # uncommitted or overwritten slot
            out.append((tag, start_ns, dur_ns))
        self._cursor.value = cur
        return out

    # -- API ---------------------------------------------------------------

    def push(self, tag: int, start_ns: int, dur_ns: int):
        lib = get_lib()
        if lib is None:
            self._py_push(tag, start_ns, dur_ns)
            return
        lib.dlrtpu_ring_push(
            ctypes.addressof(self._cbuf), tag, start_ns, dur_ns
        )

    def drain(self, max_records: int = 1024) -> list:
        """Returns [(tag, start_ns, dur_ns), ...] since the last drain."""
        lib = get_lib()
        if lib is None:
            return self._py_drain(max_records)
        out = (_Record * max_records)()
        n = lib.dlrtpu_ring_drain(
            ctypes.addressof(self._cbuf), out, max_records,
            ctypes.byref(self._cursor),
        )
        return [
            (out[i].tag, out[i].start_ns, out[i].dur_ns)
            for i in range(n)
        ]
