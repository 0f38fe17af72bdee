"""Flash attention forward, ported from ``singa_tpu/ops/flash_attention.py``.

Replaces the Pallas TPU kernel ``_fwd_kernel`` (launched by ``_fwd``) of
``singa_tpu/ops/flash_attention.py`` with a hand-written CUDA kernel for
Hopper, ``singa_tpu_torch/csrc/flash_fwd.cu``, bound through ``ctypes``.
It computes what the Pallas kernel computes, forward only: online-softmax
attention returning o and lse = m + log l; causal masking bottom-right
aligned (qpos + Tk - Tq >= kpos); an optional sliding window
(kpos > qpos - W); fully masked and below-band tiles skipped; GQA reads
kv head h // G with no head replication.  The kernel reads the public
(B, T, H, D) layout through strides, so no transposed copies are made.

What bounds it on an H100: at the Llama prefill shape (B=4, H=16, K=8,
T=1024, D=128, bf16, causal) the work is ~17 GFLOP against ~51 MB of
input and output, so it is bound by tensor-core operations (~17 us at
989 TFLOP/s) rather than by bytes (~15 us at 3.35 TB/s).  The design
keeps the (Tq, Tk) scores out of device memory (one thread block per
(b, h, 64-row q tile) walks the K/V tiles with f32 running max,
denominator and accumulator in registers) and runs QK^T and P·V on bf16
``mma.sync`` tensor-core instructions; f32 inputs take a plain-FMA
kernel.  TMA, ``wgmma`` and warp specialisation are later work.

On a CPU tensor the wrappers compute the kernel's plain version,
``_flash_fwd_reference``; on a CUDA tensor they launch the kernel or
raise.  The backward kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``)
come with the training slice; until then a CUDA call that needs a
gradient raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["flash_attention", "flash_attention_with_lse"]

_NEG_INF = -1e30
_MAX_HEAD_DIM = 256

#: kernel launches since the last reset (a plain count: chip_smoke.py
#: resets it and reads it around the serving path)
launches = 0


def _tileable(Tq, Tk, D) -> bool:
    return Tq % 128 == 0 and Tk % 128 == 0 and D >= 32 and D % 8 == 0


def _flash_fwd_reference(q, k, v, causal: bool, scale: float, window=None):
    """Plain torch version of the kernel on (B, T, H, D) inputs:
    returns (o (B, Tq, H, D) in q's dtype, lse (B, H, Tq, 1) f32).

    It follows the kernel's conventions, not `_sdpa_reference`'s: f32
    scores, masked scores filled with -1e30, p cast to v's dtype before
    P·V with f32 accumulation, and the denominator floored at 1e-30."""
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.float().reshape(B, Tq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if causal or window is not None:
        qpos = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
        kpos = torch.arange(Tk, device=q.device)[None, :]
        valid = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
        if causal:
            valid &= qpos >= kpos
        if window is not None:
            valid &= kpos > qpos - window
        s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                      # (B, K, G, Tq, 1)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    o = pv / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l)).reshape(B, H, Tq, 1)
    return o.reshape(B, Tq, H, D).to(q.dtype), lse


def _check_layout(name, t, vec_elems):
    """The kernel reads rows of D contiguous elements with 16-byte
    loads: the last dim must be contiguous and every other stride, and
    the base address, aligned to 16 bytes."""
    if t.stride(-1) != 1:
        raise ValueError(f"flash kernel needs a contiguous last dim in "
                         f"{name}; got strides {tuple(t.stride())}")
    if t.data_ptr() % 16 or any(s % vec_elems for s in t.stride()[:3]):
        raise ValueError(f"flash kernel needs 16-byte aligned rows in "
                         f"{name}; got strides {tuple(t.stride())}")


#: the built kernel's bound C entry point, set at its first launch
_fn = None


def bind(lib):
    """`singa_flash_fwd` of a loaded kernel library, with its signature."""
    fn = lib.singa_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_int64] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    return fn


def _kernel():
    global _fn
    if _fn is None:
        from .. import _build
        _fn = bind(_build.load("flash_fwd").lib)
    return _fn


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float, window=None):
    """Launch the Hopper kernel on (B, T, H, D) CUDA tensors (any
    strides with a contiguous head dim).  Returns (o, lse) like
    `_flash_fwd_reference`.  Raises on anything the kernel does not
    take; there is no fall back."""
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash kernel needs q, k, v on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes f32 or bf16 q/k/v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash kernel takes (B, T, H, D) q and matching "
                         f"k/v; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % K != 0:
        raise ValueError(f"flash kernel shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if not _tileable(Tq, Tk, D) or D > _MAX_HEAD_DIM:
        raise ValueError(f"flash kernel needs Tq, Tk % 128 == 0 and "
                         f"32 <= D <= {_MAX_HEAD_DIM}, D % 8 == 0; got "
                         f"Tq={Tq}, Tk={Tk}, D={D}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention backward on the card comes with the training "
            "slice (_bwd_dq_kernel/_bwd_dkv_kernel); run under "
            "torch.no_grad()")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t, vec)

    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), 1 if q.dtype == torch.bfloat16 else 0,
                B, H, K, Tq, Tk, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3],
                float(scale), int(bool(causal)),
                0 if window is None else int(window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {rc}")
    launches += 1
    return o, lse


def _flash_fwd(q, k, v, causal: bool, scale: float, window=None):
    """(B, T, H, D) forward: the kernel on the card, its plain version
    on the CPU."""
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, causal, scale, window)
    return _flash_fwd_reference(q, k, v, causal, scale, window)


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: float = None):
    """(B, H, T, D)-layout flash attention returning (o, lse), lse
    (B, H, Tq, 1) f32 — the per-block primitive ring attention will
    combine across cards.  No fall back: shapes that do not tile raise
    (a silent fall back here would skip tail rows)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if not _tileable(Tq, Tk, D) or H % k.shape[1] != 0:
        raise ValueError(
            f"flash_attention_with_lse needs tiling shapes "
            f"(T % 128 == 0, D >= 32, D % 8 == 0); got Tq={Tq}, Tk={Tk}, "
            f"D={D}, H={H}, K={k.shape[1]}")
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    o, lse = _flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), bool(causal), float(scale))
    return o.transpose(1, 2), lse


def flash_attention(q, k, v, causal: bool = False, scale: float = None,
                    window: int = None):
    """(B, T, H, D) attention; k/v may have fewer heads (GQA, H % K == 0)
    or a longer sequence (KV cache; causal is bottom-right aligned).
    `window`: sliding window — tiles below the band are skipped
    (requires causal=True).

    Shapes that tile go to the kernel (its plain version on the CPU);
    others to the reference math, as in the JAX package."""
    from .attention import _banded_reference, _sdpa_reference

    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (the band is "
                             "causal by definition)")
        if window < 1:
            raise ValueError(
                f"window must be >= 1, got {window} (0 would mask every "
                "key; use window=None for full causal attention)")
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    if not _tileable(Tq, Tk, D) or H % K != 0:
        if window is not None:
            return _banded_reference(q, k, v, window, scale)
        return _sdpa_reference(q, k, v, causal, None, scale)
    o, _ = _flash_fwd(q, k, v, bool(causal), float(scale),
                      None if window is None else int(window))
    return o
