"""Minimal framed request/response protocol for worker RPC, ported
from ``singa_tpu/serve/net/rpc.py``.

One frame = a small JSON header plus an optional opaque binary payload::

    u32 header_len | u32 payload_len | header JSON (utf-8) | payload

The header always carries ``op`` (verb) and, when a request context is
active on the sender, ``trace`` — the existing contextvar trace id
(obs.trace), so one request's timeline spans supervisor and worker
sinks under one trace id across process boundaries.  Receivers re-activate the frame's trace id around
handling, which is all the cross-process propagation there is.

Verbs (handled in :mod:`.procworker`): ``hello``, ``ready``,
``submit``, ``resubmit``, ``tick``, ``handoff`` (probe / extract /
inject), ``withdraw``, ``drain``, ``health``, ``heartbeat``
(header-only, engine-free liveness probe — the supervisor's hang
detector), ``chaos`` (install a worker-side fault plan), ``shutdown``.  Replies echo ``op`` with
``ok`` set; errors ride back as ``{"ok": false, "err": ...}`` rather
than killing the connection.

Deadlines live one layer up: the supervisor resolves a per-op timeout
from its table (``supervisor._OP_TIMEOUTS``, compile-aware) and a
timed-out socket is POISONED there — this module's ``recv_frame``
cannot tell a late reply from a fresh one (frames carry no request
id), so the supervisor-side poisoning contract is what prevents a
stale reply being misread as the answer to a newer request.

Fault seams: frames WITH a binary payload are the KV wire transport,
so both directions fire the ``serve.transport`` site before the bytes
move, and the send side passes the payload through :func:`faults.tear`
— a ``torn_frame`` spec truncates the package content while the frame
itself stays well-formed, exactly the damage the codec's digest check
must catch on the far side.  Header-only control frames (tick, health)
do not fire: control-plane chaos belongs to ``serve.router`` /
``serve.handoff``.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, Optional, Tuple

from ... import faults
from ...obs import trace as obs_trace

__all__ = ["RPCError", "send_frame", "recv_frame", "call"]

_LENS = struct.Struct(">II")
#: refuse frames beyond this (a length prefix corrupted into garbage
#: must not make recv try to allocate gigabytes)
MAX_FRAME = 1 << 30


class RPCError(ConnectionError):
    """The peer hung up mid-frame or sent an unparseable frame."""


def send_frame(sock: socket.socket, header: Dict[str, Any],
               payload: bytes = b"") -> None:
    """Write one frame.  Stamps the active trace id into the header
    (when one is active and the caller didn't already), and runs the
    transport fault seam on payload-bearing frames."""
    if "trace" not in header:
        tid = obs_trace.current_trace_id()
        if tid is not None:
            header = dict(header, trace=tid)
    if payload:
        faults.fire("serve.transport", op=header.get("op"),
                    direction="send", nbytes=len(payload))
        payload = faults.tear("serve.transport", payload)
    hj = json.dumps(header, separators=(",", ":")).encode()
    sock.sendall(_LENS.pack(len(hj), len(payload)) + hj + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise RPCError(
                f"peer closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket,
               timeout: Optional[float] = None
               ) -> Tuple[Dict[str, Any], bytes]:
    """Read one frame; returns (header, payload).  ``timeout`` bounds
    the whole read (None = block forever); expiry surfaces as
    ``socket.timeout``."""
    sock.settimeout(timeout)
    try:
        hlen, plen = _LENS.unpack(_recv_exact(sock, _LENS.size))
        if hlen > MAX_FRAME or plen > MAX_FRAME:
            raise RPCError(f"oversized frame ({hlen}+{plen} bytes)")
        try:
            header = json.loads(_recv_exact(sock, hlen).decode())
        except ValueError as e:
            raise RPCError(f"unparseable frame header: {e}") from None
        payload = _recv_exact(sock, plen) if plen else b""
    finally:
        sock.settimeout(None)
    if payload:
        faults.fire("serve.transport", op=header.get("op"),
                    direction="recv", nbytes=len(payload))
    return header, payload


def call(sock: socket.socket, header: Dict[str, Any],
         payload: bytes = b"", *, timeout: Optional[float] = None
         ) -> Tuple[Dict[str, Any], bytes]:
    """One request/response round trip on a connection the caller owns
    exclusively (the supervisor serializes per-worker traffic)."""
    send_frame(sock, header, payload)
    return recv_frame(sock, timeout=timeout)
