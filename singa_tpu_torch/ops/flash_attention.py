"""Flash attention, forward and backward, ported from
``singa_tpu/ops/flash_attention.py``.

Replaces the three Pallas TPU kernels of ``singa_tpu/ops/flash_attention.py``
with kernels written by hand for Hopper, bound through ``ctypes``:

* ``_fwd_kernel`` (launched by ``_fwd``) by ``csrc/flash_fwd.cu``:
  online-softmax attention returning o and lse = m + log l;
* ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (both launched by ``_bwd``)
  by the two kernels of ``csrc/flash_bwd.cu``: dQ, and dK/dV, from P
  recomputed with the saved lse.

All take causal masking bottom-right aligned (qpos + Tk - Tq >= kpos);
an optional sliding window (kpos > qpos - W); fully masked and
below-band tiles skipped; GQA reading kv head h // G with no head
replication.  The kernels read the public (B, T, H, D) layout through
strides, so no transposed copies are made.

What bounds them on an H100: at the Llama prefill shape (B=4, H=16,
K=8, T=1024, D=128, bf16, causal) the forward does ~17 GFLOP against
~51 MB, at the training shape (B=8) the backward ~52 (dQ) and ~69
(dK/dV) GFLOP against ~135 MB each: tensor-core operations, not bytes.
The designs keep the (Tq, Tk) scores out of device memory.  The bf16
forward is a persistent, warp-specialised kernel: TMA loads into a ring
of K/V tiles, ``wgmma`` products with f32 accumulation, and o stored by
TMA.  The bf16 backward kernels (head dims up to 128) share that
design: dK/dV keeps a 128-key tile of K and V resident while a ring
brings each query head's Q, dO, lse and delta tiles, and takes P^T and
dS^T from registers into ``wgmma``; dQ keeps a 128-row tile of Q and dO
resident while K/V tiles stream through a ring.  bf16 head dims above 128
run the backward on ``mma.sync``; f32 inputs take plain FMA kernels.
See the sources.

`_FlashCore`, a ``torch.autograd.Function``, is the counterpart of the
reference's ``jax.custom_vjp`` ``_flash_core_lse``: its forward saves
q, k, v, o and lse, its backward folds the lse cotangent into
delta = rowsum(dO * O) - dlse in plain torch and runs the two backward
kernels.  On a CPU tensor every step computes the kernels' plain
versions (`_flash_fwd_reference`, `_flash_bwd_reference`); on a CUDA
tensor the wrappers launch the kernels or raise.

Launches are counted twice: by the wrappers on the host (`launches`,
`dq_launches`, `dkv_launches`: the launches they made, eagerly or into
a CUDA graph under capture), and by the kernels on the card
(`device_launches`: the launches that ran, replays of graphs included).
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["flash_attention", "flash_attention_with_lse",
           "device_launches", "reset_device_launches"]

_NEG_INF = -1e30
_MAX_HEAD_DIM = 256

#: the wrappers' launches since the last reset, one count per kernel:
#: each wrapper adds one where it launches its kernel, eagerly or into a
#: CUDA graph being captured.  A replay of a graph calls no wrapper and
#: moves none of these; `device_launches` counts the launches that ran
launches = 0          # flash_fwd
dq_launches = 0       # flash_bwd dQ
dkv_launches = 0      # flash_bwd dK/dV

#: the kernels, in the order of their device counters
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
#: per card, one int64 counter per kernel that the kernel itself advances
#: each time a launch of it runs (also when a graph replays the launch):
#: made at the first launch on that card, never inside a capture
_device_counts = {}


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


def _layout_ok(t, vec_elems) -> bool:
    """The kernels read rows of D contiguous elements with 16-byte
    loads: the last dim must be contiguous and every other stride, and
    the base address, aligned to 16 bytes."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any(s % vec_elems for s in t.stride()[:3]))


def _check_layout(name, t, vec_elems):
    if not _layout_ok(t, vec_elems):
        raise ValueError(f"flash kernel needs a contiguous last dim and "
                         f"16-byte aligned rows in {name}; got strides "
                         f"{tuple(t.stride())}")


def _check_inputs(q, k, v):
    """Raise on (B, T, H, D) q/k/v that the kernels do not take."""
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
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t, vec)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _card(device=None) -> int:
    device = torch.device("cuda" if device is None else device)
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _count_ptr(device, kernel: str) -> int:
    """The address of `kernel`'s device counter on `device`."""
    card = _card(device)
    counts = _device_counts.get(card)
    if counts is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the flash kernels' launch counters are made at their first "
                "eager launch on a card; run the step once before capturing")
        counts = _device_counts[card] = torch.zeros(
            len(KERNELS), dtype=torch.int64, device=torch.device("cuda", card))
    return counts.data_ptr() + 8 * KERNELS.index(kernel)


def device_launches(device=None) -> dict:
    """Launches of each kernel that ran on the card (default: the
    current one) since the last `reset_device_launches`, as the kernels
    counted them: eager launches and launches replayed from CUDA graphs
    alike.  Waits for the card."""
    counts = _device_counts.get(_card(device)) if _device_counts else None
    if counts is None:
        return dict.fromkeys(KERNELS, 0)
    torch.cuda.synchronize(counts.device)
    return dict(zip(KERNELS, counts.tolist()))


def reset_device_launches(device=None) -> None:
    """Set the card's kernel launch counters to 0 (after the launches
    already queued)."""
    counts = _device_counts.get(_card(device)) if _device_counts else None
    if counts is not None:
        torch.cuda.synchronize(counts.device)
        counts.zero_()
        torch.cuda.synchronize(counts.device)


#: the built kernels' bound C entry points, set at their first launch
_fn = None
_dq_fn = None
_dkv_fn = None


def bind(lib):
    """`singa_flash_fwd` of a loaded kernel library, with its signature."""
    fn = lib.singa_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_int64] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p])
    return fn


def bind_bwd(lib):
    """(`singa_flash_bwd_dq`, `singa_flash_bwd_dkv`) of a loaded kernel
    library, with their signatures."""
    dq, dkv = lib.singa_flash_bwd_dq, lib.singa_flash_bwd_dkv
    for fn, n_ptr in ((dq, 7), (dkv, 8)):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                       + [ctypes.c_int64] * 15
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p])
    return dq, dkv


def _kernel():
    global _fn
    if _fn is None:
        from .. import _build
        _fn = bind(_build.load("flash_fwd").lib)
    return _fn


def _bwd_kernels():
    global _dq_fn, _dkv_fn
    if _dq_fn is None:
        from .. import _build
        _dq_fn, _dkv_fn = bind_bwd(_build.load("flash_bwd").lib)
    return _dq_fn, _dkv_fn


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float, window=None):
    """Launch the Hopper kernel on (B, T, H, D) CUDA tensors (any
    strides with a contiguous head dim).  Returns (o, lse) like
    `_flash_fwd_reference`.  Raises on anything the kernel does not
    take; there is no fall back."""
    global launches
    _check_inputs(q, k, v)
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), 1 if q.dtype == torch.bfloat16 else 0,
                B, H, K, Tq, Tk, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3],
                float(scale), int(bool(causal)),
                0 if window is None else int(window),
                _count_ptr(q.device, "flash_fwd"), _stream(q))
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


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, window):
    """P and dS of the backward in (B, K, G, Tq, Tk) f32, as the kernels
    form them: p = exp(s - lse) set to 0 where masked (after the exp),
    ds = p (dO V^T - delta) scale, both rounded to the inputs' dtype
    (the A operand of the kernels' products; a no-op for f32)."""
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.float().reshape(B, Tq, K, G, D)
    dog = do.float().reshape(B, Tq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    p = torch.exp(s - lse.reshape(B, K, G, Tq, 1))
    if causal or window is not None:
        qpos = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
        kpos = torch.arange(Tk, device=q.device)[None, :]
        valid = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
        if causal:
            valid &= qpos >= kpos
        if window is not None:
            valid &= kpos > qpos - window
        p = p.masked_fill(~valid, 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta.reshape(B, K, G, Tq, 1)) * scale
    return p.to(q.dtype).float(), ds.to(q.dtype).float(), qg, dog


def _bwd_dq_reference(q, k, v, do, lse, delta, causal, scale, window=None):
    """Plain version of the dQ kernel: dq (B, Tq, H, D) in q's dtype."""
    _, ds, _, _ = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, window)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def _bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale, window=None):
    """Plain version of the dK/dV kernel: (dk, dv) (B, Tk, K, D), summed
    over each GQA group in f32 and rounded once to k's and v's dtype (the
    Pallas kernel rounds each query head's share, then sums)."""
    p, ds, qg, dog = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale,
                               window)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_reference(q, k, v, do, lse, delta, causal: bool,
                         scale: float, window=None):
    """Plain torch version of both backward kernels on (B, T, H, D)
    inputs, lse and delta (B, H, Tq, 1) f32: returns (dq, dk, dv) in the
    inputs' dtypes."""
    dq = _bwd_dq_reference(q, k, v, do, lse, delta, causal, scale, window)
    dk, dv = _bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale,
                                window)
    return dq, dk, dv


def _bwd_args(q, k, v, do, lse, delta):
    """Check the backward's inputs; returns `do` with a layout the
    kernels read (autograd may hand over any strides: copied if need
    be)."""
    _check_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash backward needs do like q; got "
                         f"{tuple(do.shape)} {do.dtype}, q {tuple(q.shape)} "
                         f"{q.dtype}")
    B, Tq, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        # the bf16 kernels copy 64 rows at a time with 16-byte bulk copies
        if t.shape != (B, H, Tq, 1) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"flash backward needs a contiguous, 16-byte "
                             f"aligned (B, H, Tq, 1) f32 {name}; got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not _layout_ok(do, 16 // do.element_size()):
        do = do.contiguous()
    return do


def _launch_dq(q, k, v, do, lse, delta, causal, scale, window=None):
    """Launch the dQ kernel on checked inputs (see `_bwd_args`)."""
    global dq_launches
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    fn, _ = _bwd_kernels()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                1 if q.dtype == torch.bfloat16 else 0, B, H, K, Tq, Tk, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *do.stride()[:3], *dq.stride()[:3],
                float(scale), int(bool(causal)),
                0 if window is None else int(window),
                _count_ptr(q.device, "flash_bwd_dq"), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_bwd dQ kernel launch failed: "
                           f"cudaError {rc}")
    dq_launches += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal, scale, window=None):
    """Launch the dK/dV kernel on checked inputs (see `_bwd_args`)."""
    global dkv_launches
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    dk = torch.empty((B, Tk, K, D), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _, fn = _bwd_kernels()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), 1 if q.dtype == torch.bfloat16 else 0,
                B, H, K, Tq, Tk, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *do.stride()[:3], *dk.stride()[:3],
                float(scale), int(bool(causal)),
                0 if window is None else int(window),
                _count_ptr(q.device, "flash_bwd_dkv"), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_bwd dK/dV kernel launch failed: "
                           f"cudaError {rc}")
    dkv_launches += 1
    return dk, dv


def _flash_bwd_cuda(q, k, v, do, lse, delta, causal: bool, scale: float,
                    window=None):
    """Launch the dQ and dK/dV kernels on (B, T, H, D) CUDA tensors.
    Returns (dq, dk, dv) like `_flash_bwd_reference`.  Raises on anything
    the kernels do not take; there is no fall back."""
    do = _bwd_args(q, k, v, do, lse, delta)
    dq = _launch_dq(q, k, v, do, lse, delta, causal, scale, window)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, scale, window)
    return dq, dk, dv


def _flash_bwd(q, k, v, do, lse, delta, causal, scale, window=None):
    """(B, T, H, D) backward: the kernels on the card, their plain
    versions on the CPU."""
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, do, lse, delta, causal, scale,
                               window)
    return _flash_bwd_reference(q, k, v, do, lse, delta, causal, scale,
                                window)


class _FlashCore(torch.autograd.Function):
    """(o, lse) of (B, T, H, D) q, k, v with lse differentiable: the
    reference's ``_flash_core_lse`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        o, lse = _flash_fwd(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, scale, window)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, window = ctx.opts
        # the lse cotangent folds into delta: ds = p (dp - delta + dlse)
        # (d lse_i / d s_ij = p_ij), so delta_eff = delta - dlse
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
        delta = (delta - dlse).contiguous()
        dq, dk, dv = _flash_bwd(q, k, v, do, lse, delta, causal, scale,
                                window)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: float = None):
    """(B, H, T, D)-layout flash attention returning (o, lse), lse
    (B, H, Tq, 1) f32 and differentiable — the per-block primitive ring
    attention will combine across cards.  No fall back: shapes that do
    not tile raise (a silent fall back here would skip tail rows)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if not _tileable(Tq, Tk, D) or H % k.shape[1] != 0:
        raise ValueError(
            f"flash_attention_with_lse needs tiling shapes "
            f"(T % 128 == 0, D >= 32, D % 8 == 0); got Tq={Tq}, Tk={Tk}, "
            f"D={D}, H={H}, K={k.shape[1]}")
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    o, lse = _FlashCore.apply(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), bool(causal), float(scale),
                              None)
    return o.transpose(1, 2), lse


def flash_attention(q, k, v, causal: bool = False, scale: float = None,
                    window: int = None):
    """(B, T, H, D) attention; k/v may have fewer heads (GQA, H % K == 0)
    or a longer sequence (KV cache; causal is bottom-right aligned).
    `window`: sliding window — tiles below the band are skipped
    (requires causal=True).  Differentiable in q, k and v.

    Shapes that tile go to the kernels (their plain versions on the
    CPU); others to the reference math, as in the JAX package."""
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
    o, _ = _FlashCore.apply(q, k, v, bool(causal), float(scale),
                            None if window is None else int(window))
    return o
