"""Versioned binary wire codec for :class:`HandoffPackage`, ported from
``singa_tpu/serve/net/codec.py``.

A cross-process handoff is the in-process handoff with a socket in the
middle: the source worker host-stages its package's KV (the engine's
stream synchronised, then a copy to the host), this codec serializes
the package to one length-prefixed frame payload, and the destination
worker deserializes it and feeds the result to the same
``inject_handoff`` path — the wire adds representation, not semantics.

Frame layout (all integers big-endian)::

    MAGIC "SGKV" | u8 version | u32 header_len | header JSON (utf-8)
    | tensor bytes (C-order, concatenated in manifest order)
    | blake2b-128 digest of every byte above

The header carries the request's host state (prompt, tokens so far,
budget, remaining deadline, trace id), the package metadata (pos,
n_blocks, prefix chain keys as hex) and a tensor manifest (dtype name
and shape per tensor, target KV pairs first, then draft pairs).  The
layout, the version, the dtype names and the digest are the
reference's, so one package encodes to the same bytes in both packages.
bf16 tensors travel as their 2-byte patterns under the name
``bfloat16`` (what numpy's ``ml_dtypes`` extension calls the type in
the reference); the port reads and writes them through torch, which
needs no numpy bf16.

**Torn transfers are never injected**: :func:`decode_package` checks
the trailing digest over the whole frame before it parses anything, so
a truncated or bit-flipped frame (a crash mid-send, the
``serve.transport`` site's ``torn_frame``) raises :class:`TornFrame`
and the supervisor re-routes the request by replay.

The codec produces HOST tensors; ``inject`` copies them to its device.
"""

from __future__ import annotations

import hashlib
import json
import struct
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...model import _sync
from ..disagg.handoff import HandoffPackage
from ..scheduler import Request

__all__ = ["WireError", "TornFrame", "encode_package", "decode_package",
           "probe_package", "WIRE_VERSION"]

_MAGIC = b"SGKV"
WIRE_VERSION = 1
_DIGEST_BYTES = 16
_HEAD = struct.Struct(">4sBI")   # magic, version, header_len

#: manifest dtype names: numpy's (and ml_dtypes' ``bfloat16``), as the
#: reference writes them
_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.int32: "int32", torch.int64: "int64"}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


class WireError(ValueError):
    """Structurally invalid frame: bad magic, unknown version, or a
    manifest that does not describe the payload.  Distinct from
    :class:`TornFrame` so callers can tell 'wrong protocol' from
    'right protocol, damaged in flight'."""


class TornFrame(WireError):
    """Digest mismatch: the frame was truncated or corrupted between
    encode and decode.  The package MUST NOT be injected — the caller
    re-routes the request via replay instead."""


def _digest(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=_DIGEST_BYTES).digest()


def _host_pairs(pairs, what: str) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer (k, v) views as contiguous host tensors, refusing
    anything that is not a pair of tensors of a wire dtype.  Device
    tensors are staged after one sync of their device, so the copies
    read what the engine's stream wrote."""
    for i, pair in enumerate(pairs):
        if not (isinstance(pair, (tuple, list)) and len(pair) == 2
                and all(isinstance(t, torch.Tensor) for t in pair)):
            raise WireError(f"{what}[{i}] is not a (k, v) pair of tensors")
        for t in pair:
            if t.dtype not in _DTYPE_NAMES:
                raise WireError(f"{what}[{i}] has dtype {t.dtype}, which "
                                f"the wire format does not carry")
    for dev in {t.device for pair in pairs for t in pair}:
        _sync(dev)
    return [tuple(t.detach().cpu().contiguous() for t in pair)
            for pair in pairs]


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """A contiguous host tensor's bytes in C order (bf16 as its 2-byte
    patterns)."""
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def encode_package(pkg: HandoffPackage, *, src: Optional[str] = None
                   ) -> bytes:
    """Serialize ``pkg`` to one frame payload (see module docstring).
    ``src`` overrides the package's source-worker tag (the supervisor
    stamps the worker name it extracted from)."""
    req = pkg.req
    kv = _host_pairs(pkg.kv, "kv")
    draft = (_host_pairs(pkg.draft_kv, "draft_kv")
             if pkg.draft_kv is not None else [])
    tensors: List[torch.Tensor] = []
    manifest: List[Tuple[str, List[int]]] = []
    for k, v in kv + draft:
        for t in (k, v):
            tensors.append(t)
            manifest.append((_DTYPE_NAMES[t.dtype], list(t.shape)))
    deadline_rem = (req.deadline - time.monotonic()
                    if req.deadline is not None else None)
    header = {
        "rid": req.rid,
        "prompt": np.asarray(req.prompt).tolist(),
        "tokens": list(req.tokens),
        "max_new_tokens": req.max_new_tokens,
        "deadline_rem_s": deadline_rem,
        "eos_id": req.eos_id,
        "trace": req.trace_id,
        "ttft_s": req.ttft_s,
        "pos": pkg.pos,
        "n_blocks": pkg.n_blocks,
        "prompt_keys": [k.hex() for k in pkg.prompt_keys],
        "src": src if src is not None else pkg.src,
        "n_kv": len(kv),
        "n_draft": len(draft),
        "tensors": manifest,
    }
    hj = json.dumps(header, separators=(",", ":")).encode()
    parts = [_HEAD.pack(_MAGIC, WIRE_VERSION, len(hj)), hj]
    parts.extend(_tensor_bytes(t) for t in tensors)
    body = b"".join(parts)
    return body + _digest(body)


def decode_package(data: bytes) -> HandoffPackage:
    """Parse a frame payload back into a :class:`HandoffPackage` with
    host-tensor KV views, checking the trailing digest FIRST — a torn
    or corrupted frame raises :class:`TornFrame` before any request
    state is constructed."""
    if len(data) < _HEAD.size + _DIGEST_BYTES:
        raise TornFrame(
            f"frame too short ({len(data)} bytes) — truncated in flight")
    if data[:4] != _MAGIC:
        raise WireError(f"bad magic {data[:4]!r} (want {_MAGIC!r})")
    body, tail = data[:-_DIGEST_BYTES], data[-_DIGEST_BYTES:]
    if _digest(body) != tail:
        raise TornFrame(
            "frame digest mismatch — torn transfer, refusing to inject")
    magic, version, hlen = _HEAD.unpack_from(data, 0)
    if version != WIRE_VERSION:
        raise WireError(f"unknown wire version {version} "
                        f"(this build speaks {WIRE_VERSION})")
    off = _HEAD.size
    if off + hlen > len(body):
        raise WireError("header length exceeds frame")
    header = json.loads(body[off:off + hlen].decode())
    off += hlen
    # one writable copy that the tensors view (torch.frombuffer reads
    # any dtype, bf16 included)
    buf = bytearray(body)
    tensors: List[torch.Tensor] = []
    for dtype_name, shape in header["tensors"]:
        dt = _DTYPES.get(dtype_name)
        if dt is None:
            raise WireError(f"unknown tensor dtype {dtype_name!r}")
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = n * dt.itemsize
        if off + nbytes > len(body):
            raise WireError("tensor manifest exceeds frame payload")
        t = (torch.frombuffer(buf, dtype=dt, count=n, offset=off) if n
             else torch.empty((0,), dtype=dt))
        tensors.append(t.reshape(shape))
        off += nbytes
    if off != len(body):
        raise WireError(
            f"{len(body) - off} trailing bytes after manifest tensors")
    n_kv, n_draft = int(header["n_kv"]), int(header["n_draft"])
    if len(tensors) != 2 * (n_kv + n_draft):
        raise WireError("tensor count disagrees with layer counts")
    pairs = [(tensors[2 * i], tensors[2 * i + 1])
             for i in range(n_kv + n_draft)]
    kv, draft = pairs[:n_kv], pairs[n_kv:]
    req = Request(np.asarray(header["prompt"], np.int32),
                  header["max_new_tokens"],
                  header["deadline_rem_s"], header["eos_id"], None)
    req.tokens = [int(t) for t in header["tokens"]]
    req.trace_id = header.get("trace")
    req.ttft_s = header.get("ttft_s")
    return HandoffPackage(
        req=req, kv=kv, pos=int(header["pos"]),
        n_blocks=int(header["n_blocks"]),
        prompt_keys=[bytes.fromhex(h) for h in header["prompt_keys"]],
        src=header.get("src", ""),
        draft_kv=draft if n_draft else None)


def probe_package(prompt_ids, n_blocks: int,
                  prompt_keys_hex: List[str]) -> HandoffPackage:
    """A KV-less stand-in package for capacity probes: carries exactly
    the fields ``can_accept_handoff`` reads (prompt, block count,
    prefix chain keys), so a destination worker can answer 'would this
    fit' without the source gathering or shipping a single KV byte.
    Must never be passed to inject."""
    req = Request(np.asarray(prompt_ids, np.int32), 1, None, None, None)
    return HandoffPackage(
        req=req, kv=[], pos=0, n_blocks=int(n_blocks),
        prompt_keys=[bytes.fromhex(h) for h in prompt_keys_hex])
