"""Wire protocol of the serving fabric across processes, after the
reference's ``serve/wire.py``; frames are byte for byte the reference's for
the same header and arrays, so a router and a worker of either package can
talk to each other.

Stdlib and numpy only, shared by the front-end router (``serve/router.py``)
and the worker hosts (``serve/worker.py``): no pickling (a router must never
``eval`` bytes a worker sent it) and no torch at module scope, so the
protocol layer imports where the accelerator stack is broken.

One frame is::

    u32 header_len | u32 payload_len | header (JSON, utf-8) | payload

``header`` is a JSON object whose ``"type"`` field names the message;
arrays ride in ``payload`` as raw C-contiguous bytes, described by the
header's ``"_arrays"`` manifest (``[{name, dtype, shape}]``, offsets implied
by order).  fp64 sigma therefore crosses the wire bit for bit.  Arrays go
on the wire from host memory: a torch tensor (on the card or not) is read
back with ``.cpu().numpy()`` first, since ``np.asarray`` fails on a CUDA
tensor.

Sockets are used full-duplex: exactly one reader per connection end, any
number of writers serialized by the caller's send lock (``send_msg``
itself writes the frame with a single ``sendall``).
"""

from __future__ import annotations

import json
import socket
import struct

import numpy as np

__all__ = ["send_msg", "recv_msg", "host_array", "WireClosed",
           "MAX_FRAME_BYTES"]

_HDR = struct.Struct(">II")

# A frame larger than this is a protocol error, not a big matrix: refuse it
# rather than let a corrupt length prefix trigger a multi-GB allocation.
MAX_FRAME_BYTES = 1 << 31


class WireClosed(ConnectionError):
    """The peer closed (or broke) the connection mid-protocol."""


def host_array(arr) -> np.ndarray:
    """``arr`` as a C-contiguous numpy array in host memory: a torch tensor
    is detached and read back with ``.cpu().numpy()``."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    return np.ascontiguousarray(arr)


def send_msg(sock: socket.socket, header: dict,
             arrays: dict | None = None) -> None:
    """Send one frame: JSON ``header`` plus named ``arrays`` (numpy arrays
    or torch tensors).

    The caller must serialize concurrent senders on one socket (both
    router and worker keep a per-connection send lock); the frame itself
    goes out in a single ``sendall`` so a crash between writers never
    interleaves two frames.
    """
    header = dict(header)
    chunks: list[bytes] = []
    manifest = []
    for name, arr in (arrays or {}).items():
        a = host_array(arr)
        manifest.append({"name": name, "dtype": a.dtype.name,
                         "shape": list(a.shape)})
        chunks.append(a.tobytes())
    if manifest:
        header["_arrays"] = manifest
    hbytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    payload = b"".join(chunks)
    sock.sendall(_HDR.pack(len(hbytes), len(payload)) + hbytes + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError as exc:
            raise WireClosed(f"recv failed: {exc}") from exc
        if not chunk:
            raise WireClosed("peer closed the connection")
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket) -> tuple[dict, dict[str, np.ndarray]]:
    """Receive one frame; returns ``(header, arrays)``.

    Raises :class:`WireClosed` on EOF or reset: the reader loops in the
    router and worker treat that as "this peer is gone", which is the
    host-drop signal, not an error to retry.
    """
    hlen, plen = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if hlen + plen > MAX_FRAME_BYTES:
        raise WireClosed(f"oversized frame ({hlen + plen} bytes): "
                         "corrupt length prefix or misbehaving peer")
    header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    payload = _recv_exact(sock, plen) if plen else b""
    arrays: dict[str, np.ndarray] = {}
    off = 0
    for m in header.pop("_arrays", []):
        a = np.frombuffer(payload, dtype=np.dtype(m["dtype"]), offset=off,
                          count=int(np.prod(m["shape"], dtype=np.int64)))
        arrays[m["name"]] = a.reshape(m["shape"]).copy()
        off += a.nbytes
    return header, arrays
