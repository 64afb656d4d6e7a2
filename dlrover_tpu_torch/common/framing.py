"""Shared length-prefixed frame helpers for TCP and unix-socket planes.

One implementation for both common/rpc.py (control plane) and
common/ipc.py (local plane) so framing fixes apply everywhere.
Frame layout: [u32 little-endian body_len][body].

The PyTorch port's copy of dlrover_tpu/common/framing.py.
"""

from __future__ import annotations

import socket
import struct

HDR = struct.Struct("<I")
MAX_FRAME = 1 << 30


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        # dlint: allow-chaos(transport under the rpc.recv site: every caller reaches this through RpcClient.call / the server handler, where the chaos points live)
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, payload: bytes):
    # dlint: allow-chaos(transport under the rpc.send site — see recv_exact)
    sock.sendall(HDR.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> bytes:
    (length,) = HDR.unpack(recv_exact(sock, HDR.size))
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    return recv_exact(sock, length)
