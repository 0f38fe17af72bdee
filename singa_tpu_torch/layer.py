"""Layers, ported from ``singa_tpu/layer.py``: ``Layer``, ``Linear``,
``Embedding``, ``RMSNorm``, ``MoE``, the transformer layers
``LayerNorm``, ``Gelu``, ``Softmax`` and ``MultiHeadAttention``, and the
vision layers ``Conv2d``,
``BatchNorm2d``, ``MaxPool2d``, ``AvgPool2d``, ``GlobalAvgPool2d``,
``Flatten``, ``ReLU``, ``Tanh``, ``Sigmoid``, ``Dropout``,
``Sequential`` and the loss layers ``CrossEntropyLoss``, ``MSELoss``.

Layers are ``nn.Module``s whose parameters are created at construction
(the reference initializes lazily from the first input; here the caller
gives the input width).  Parameters are f32 masters named as in the
reference (``W``, ``table``, ``gamma``), so ``get_params()`` keys are
the reference's attribute paths one to one: a list of layers is an
``nn.ModuleList`` under the reference's attribute (``layers.<i>``,
``hidden.<i>``).  Random init draws from an explicit
``torch.Generator`` on the layer's device.

Vision layers keep the reference's layouts: NHWC activations
(``data_format="NCHW"`` takes and gives NCHW) and HWIO conv kernels.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from . import autograd
from .device import Device, get_default_device
from .ops import kv_cache as kv_ops
from .ops.attention import attention
from .ops.moe import moe_forward

__all__ = ["Layer", "Linear", "Embedding", "RMSNorm", "LayerNorm", "Gelu",
           "Softmax", "MultiHeadAttention", "MoE", "Conv2d",
           "BatchNorm2d", "MaxPool2d", "AvgPool2d", "GlobalAvgPool2d",
           "Flatten", "ReLU", "Tanh", "Sigmoid", "Dropout", "Sequential",
           "CrossEntropyLoss", "MSELoss"]


class Layer(nn.Module):
    """Base layer: an ``nn.Module`` bound to a port ``Device``."""

    def __init__(self, device: Optional[Device] = None):
        super().__init__()
        self.device = device or get_default_device()

    def get_params(self) -> Dict[str, torch.Tensor]:
        """Parameters keyed by attribute path (e.g. ``blocks.0.attn.q_proj.W``);
        each parameter records its path as ``param_name`` (the optimizer's
        slot key), as the reference names its tensors here."""
        params = dict(self.named_parameters())
        for name, p in params.items():
            p.param_name = name
        return params

    def _get_buffers(self) -> Dict[str, torch.Tensor]:
        """Persistent buffers (non-trainable states) keyed by attribute
        path.  Non-persistent buffers, such as the RoPE tables a model
        rebuilds from its config, are not states."""
        params = dict(self.named_parameters())
        return {n: t for n, t in self.state_dict(keep_vars=True).items()
                if n not in params}

    def get_states(self) -> Dict[str, torch.Tensor]:
        """Everything a checkpoint holds: parameters and persistent
        buffers, keyed by attribute path."""
        out = dict(self.get_params())
        out.update(self._get_buffers())
        return out

    def set_params(self, params: Dict) -> None:
        """Copy each given array (numpy or tensor) into the parameter of
        the same name, in its existing storage: a captured step reads
        parameters by address, so a load never rebinds them.  Names this
        layer does not have are ignored, as in the reference; a shape
        that differs raises before anything is copied."""
        _copy_into(self.get_params(), params)

    def set_states(self, states: Dict) -> None:
        """`set_params` over parameters and persistent buffers."""
        _copy_into(self.get_states(), states)

    def _new_param(self, shape) -> nn.Parameter:
        return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                        device=self.device.torch_device))


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict) -> None:
    names = [n for n in dst if n in src]
    for n in names:
        if tuple(src[n].shape) != tuple(dst[n].shape):
            raise ValueError(f"{n}: shape {tuple(src[n].shape)} does not "
                             f"match the layer's {tuple(dst[n].shape)}")
    with torch.no_grad():
        for n in names:
            a = src[n]
            dst[n].copy_(a if isinstance(a, torch.Tensor)
                         else torch.tensor(np.asarray(a)))


def _generator(dev: Device, generator: Optional[torch.Generator]):
    return generator if generator is not None else dev.generator


class Linear(Layer):
    """y = x @ W (+ b) with W of shape (in, out), Xavier-uniform init."""

    def __init__(self, out_features: int, in_features: int, bias: bool = True,
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.out_features, self.in_features = out_features, in_features
        a = math.sqrt(6.0 / max(1, in_features + out_features))
        self.W = self._new_param((in_features, out_features))
        with torch.no_grad():
            self.W.uniform_(-a, a, generator=_generator(self.device, generator))
        self.b = None
        if bias:
            self.b = self._new_param((out_features,))
            with torch.no_grad():
                self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _maybe_cast(self.W, x)
        b = None if self.b is None else _maybe_cast(self.b, x)
        return autograd.linear(x, w, b)


def _maybe_cast(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cast an f32 master param to the compute dtype of x (bf16 on the card)."""
    if p.dtype == x.dtype:
        return p
    return autograd.cast(p, x.dtype)


class Embedding(Layer):
    def __init__(self, vocab_size: int, embed_dim: int,
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.vocab_size, self.embed_dim = vocab_size, embed_dim
        self.table = self._new_param((vocab_size, embed_dim))
        with torch.no_grad():
            self.table.normal_(0.0, 0.02,
                               generator=_generator(self.device, generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = autograd.embedding(self.table, ids)
        # master table is f32; activations run in the device compute
        # dtype (bf16 on the card) — cast after the gather so only
        # B*T*D elements are converted
        dt = self.device.default_dtype
        if dt != torch.float32:
            out = autograd.cast(out, dt)
        return out


class RMSNorm(Layer):
    def __init__(self, dim: int, eps: float = 1e-6,
                 device: Optional[Device] = None):
        super().__init__(device)
        self.dim, self.eps = dim, eps
        self.gamma = self._new_param((dim,))
        with torch.no_grad():
            self.gamma.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.rmsnorm(x, _maybe_cast(self.gamma, x), self.eps)


class LayerNorm(Layer):
    """LayerNorm over the last axis of width `dim`: ``gamma`` ones,
    ``beta`` zeros."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 device: Optional[Device] = None):
        super().__init__(device)
        self.dim, self.eps = dim, eps
        self.gamma = self._new_param((dim,))
        self.beta = self._new_param((dim,))
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.layernorm(x, _maybe_cast(self.gamma, x),
                                  _maybe_cast(self.beta, x), self.eps)


class MultiHeadAttention(Layer):
    """Multi-head attention over inputs of width `embed_dim`: biased
    ``q_proj``, ``k_proj``, ``v_proj`` and ``out_proj`` (D, D), through
    ``ops.attention.attention`` (the flash kernels on the card for
    sequences of 512 and more without an explicit mask).

    With a KV cache, `pos` an int 0 is the prompt: full attention
    within it, and the cache written.  Any other `pos` (an int, a 0-d
    tensor, or a (B,) tensor of per-row depths) writes the new keys at
    `pos` and attends the cache below ``pos + T`` (``cached_sdpa``); no
    branch reads a tensor `pos` on the host, so the step captures."""

    def __init__(self, num_heads: int, embed_dim: int, causal: bool = False,
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} does not split into "
                             f"{num_heads} heads")
        self.num_heads, self.embed_dim, self.causal = \
            num_heads, embed_dim, causal
        d = embed_dim
        kw = dict(device=self.device, generator=generator)
        self.q_proj = Linear(d, d, **kw)
        self.k_proj = Linear(d, d, **kw)
        self.v_proj = Linear(d, d, **kw)
        self.out_proj = Linear(d, d, **kw)

    def forward(self, x: torch.Tensor, mask=None, cache=None, pos=0):
        B, T, D = x.shape
        H = self.num_heads
        q = self.q_proj(x).reshape(B, T, H, D // H)
        k = self.k_proj(x).reshape(B, T, H, D // H)
        v = self.v_proj(x).reshape(B, T, H, D // H)
        if cache is None:
            o = attention(q, k, v, causal=self.causal, mask=mask)
            return self.out_proj(o.reshape(B, T, D))
        ck, cv = kv_ops.update_cache(cache[0], cache[1], k, v, pos)
        if isinstance(pos, int) and pos == 0:
            o = attention(q, k, v, causal=self.causal, mask=mask)
        else:
            o = kv_ops.cached_sdpa(q, ck, cv, limit=pos + T, mask=mask)
        return self.out_proj(o.reshape(B, T, D)), (ck, cv)


class MoE(Layer):
    """Top-k mixture-of-experts FFN (``ops/moe.py``, GShard/Switch static
    dispatch) over inputs of width `dim`.  Parameters: ``router`` (D, E),
    ``w_in`` and, for SwiGLU experts, ``w_gate`` (E, D, H), ``w_out``
    (E, H, D).

    The router's load-balance losses accumulate across training-mode
    calls (eval forwards do not record); `pop_aux_loss()` returns their
    sum and resets: add it to the training loss once per step."""

    # the aux-loss list is a side channel: a forward recomputed in the
    # backward (activation checkpointing) would append again, so
    # checkpointing skips any block that holds this layer
    REMAT_SAFE = False

    def __init__(self, num_experts: int, ffn_dim: int,
                 capacity_factor: float = 1.25, top_k: int = 1,
                 act: str = "relu", dispatch_mode: str = "auto", *,
                 dim: int, device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        if not 1 <= top_k <= num_experts:
            raise ValueError(
                f"top_k={top_k} outside [1, num_experts={num_experts}]")
        if act not in ("relu", "swiglu"):
            raise ValueError(f"MoE act must be relu or swiglu, got {act!r}")
        if dispatch_mode not in ("auto", "scatter", "einsum"):
            raise ValueError(f"dispatch_mode must be auto/scatter/einsum, "
                             f"got {dispatch_mode!r}")
        self.num_experts = num_experts
        self.ffn_dim = ffn_dim
        self.capacity_factor = capacity_factor
        self.top_k = top_k
        self.act = act
        self.dispatch_mode = dispatch_mode
        self._aux_losses: List[torch.Tensor] = []
        d, e, h = dim, num_experts, ffn_dim
        gen = _generator(self.device, generator)
        a = math.sqrt(6.0 / max(1, d + e))
        std = (2.0 / (d + h)) ** 0.5
        self.router = self._new_param((d, e))
        self.w_in = self._new_param((e, d, h))
        self.w_out = self._new_param((e, h, d))
        self.w_gate = self._new_param((e, d, h)) if act == "swiglu" else None
        with torch.no_grad():
            self.router.uniform_(-a, a, generator=gen)
            for w in (self.w_in, self.w_out, self.w_gate):
                if w is not None:
                    w.normal_(0.0, std, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the router keeps its own dtype: moe_forward routes in f32
        out, aux = moe_forward(x, self.router, self.w_in, self.w_out,
                               self.capacity_factor, return_aux=True,
                               top_k=self.top_k, w_gate=self.w_gate,
                               dispatch_mode=self.dispatch_mode)
        if autograd.is_training():
            self._aux_losses.append(aux)
        return out

    @property
    def aux_loss(self) -> Optional[torch.Tensor]:
        """Most recent training call's balance loss."""
        return self._aux_losses[-1] if self._aux_losses else None

    def pop_aux_loss(self) -> Optional[torch.Tensor]:
        """Sum of balance losses since the last pop; resets the store."""
        if not self._aux_losses:
            return None
        total = self._aux_losses[0]
        for a in self._aux_losses[1:]:
            total = total + a
        self._aux_losses = []
        return total


# ---------------------------------------------------------------------------
# vision layers
# ---------------------------------------------------------------------------

def _nhwc(x: torch.Tensor, data_format: str) -> torch.Tensor:
    """An NHWC view of `x` (a permuted view when x is NCHW)."""
    return x.permute(0, 2, 3, 1) if data_format == "NCHW" else x


def _from_nhwc(y: torch.Tensor, data_format: str) -> torch.Tensor:
    return y.permute(0, 3, 1, 2) if data_format == "NCHW" else y


class Conv2d(Layer):
    """Conv layer over `in_channels` inputs: HWIO kernel ``W`` (He-normal
    init over kh·kw·in/groups), zero bias ``b``."""

    def __init__(self, out_channels: int, kernel_size, in_channels: int,
                 stride=1, padding=0, bias: bool = True, groups: int = 1,
                 dilation=1, data_format: str = "NHWC",
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"channels {in_channels} -> {out_channels} do "
                             f"not split into {groups} groups")
        self.out_channels, self.in_channels = out_channels, in_channels
        self.kernel_size = autograd._pair(kernel_size)
        self.stride, self.padding = stride, padding
        self.groups, self.dilation = groups, dilation
        self.data_format = data_format
        kh, kw = self.kernel_size
        std = math.sqrt(2.0 / max(1, in_channels * kh * kw // groups))
        self.W = self._new_param((kh, kw, in_channels // groups,
                                  out_channels))
        with torch.no_grad():
            self.W.normal_(0.0, std,
                           generator=_generator(self.device, generator))
        self.b = None
        if bias:
            self.b = self._new_param((out_channels,))
            with torch.no_grad():
                self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nhwc(x, self.data_format)
        b = None if self.b is None else _maybe_cast(self.b, x)
        y = autograd.conv2d(x, _maybe_cast(self.W, x), b, self.stride,
                            self.padding, self.groups, self.dilation)
        return _from_nhwc(y, self.data_format)


class BatchNorm2d(Layer):
    """Batch normalisation over the channel axis, as the reference's:
    batch statistics in f32, the variance E[x²] − E[x]² (biased), the
    running statistics ``running = momentum·running + (1 −
    momentum)·batch`` (biased variance too), and mean, variance, γ and
    β cast to the compute dtype before normalising.

    The running statistics are updated in place, so a captured step
    (which reads and writes them by address) updates them on every
    replay."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, data_format: str = "NHWC",
                 device: Optional[Device] = None):
        super().__init__(device)
        self.num_features, self.momentum, self.eps = num_features, momentum, eps
        self.data_format = data_format
        c = num_features
        self.gamma = self._new_param((c,))
        self.beta = self._new_param((c,))
        dev = self.device.torch_device
        self.register_buffer("running_mean", torch.zeros(c, device=dev))
        self.register_buffer("running_var", torch.ones(c, device=dev))
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nchw = self.data_format == "NCHW" and x.dim() == 4
        if nchw:
            x = x.permute(0, 2, 3, 1)
        if autograd.is_training():
            axes = tuple(range(x.dim() - 1))
            # cast once: the statistics and the normalisation read one
            # f32 copy, which autograd saves once
            xf = x.float()
            mean = xf.mean(dim=axes)
            var = (xf * xf).mean(dim=axes) - mean * mean
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            xf, mean, var = x, self.running_mean, self.running_var
        y = autograd.batchnorm(xf, _maybe_cast(self.gamma, x),
                               _maybe_cast(self.beta, x),
                               _maybe_cast(mean, x), _maybe_cast(var, x),
                               self.eps).to(x.dtype)
        return y.permute(0, 3, 1, 2) if nchw else y


class _Deviceless(Layer):
    """A layer that makes no tensors of its own, so needs no device."""

    def __init__(self):
        nn.Module.__init__(self)
        self.device = None


class _Pool2d(_Deviceless):
    def __init__(self, kernel_size, stride=None, padding: int = 0,
                 data_format: str = "NHWC"):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.data_format = data_format

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._op(_nhwc(x, self.data_format), self.kernel_size,
                     self.stride, self.padding)
        return _from_nhwc(y, self.data_format)


class MaxPool2d(_Pool2d):
    _op = staticmethod(autograd.max_pool2d)


class AvgPool2d(_Pool2d):
    _op = staticmethod(autograd.avg_pool2d)


class GlobalAvgPool2d(_Deviceless):
    def __init__(self, data_format: str = "NHWC"):
        super().__init__()
        self.data_format = data_format

    def forward(self, x):
        axes = (1, 2) if self.data_format == "NHWC" else (2, 3)
        return autograd.reduce_mean(x, axes)


class Flatten(_Deviceless):
    def __init__(self, start_axis: int = 1):
        super().__init__()
        self.start_axis = start_axis

    def forward(self, x):
        return autograd.flatten(x, self.start_axis)


class ReLU(_Deviceless):
    def forward(self, x):
        return autograd.relu(x)


class Tanh(_Deviceless):
    def forward(self, x):
        return autograd.tanh(x)


class Gelu(_Deviceless):
    """GELU; ``approximate=True`` (the default, as in the reference) is
    the tanh form, False the exact erf form."""

    def __init__(self, approximate: bool = True):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return autograd.gelu(x, self.approximate)


class Softmax(_Deviceless):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return autograd.softmax(x, self.axis)


class Sigmoid(_Deviceless):
    def forward(self, x):
        return autograd.sigmoid(x)


class Dropout(Layer):
    """Dropout whose masks come from `generator` (default: the device's);
    a captured train step registers it, so each replay draws anew."""

    def __init__(self, p: float = 0.5, device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.p = p
        self.generator = _generator(self.device, generator)

    def forward(self, x):
        return autograd.dropout(x, self.p, self.generator)


class Sequential(_Deviceless):
    """Layers applied in order, named ``layers.<i>`` as in the reference."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class CrossEntropyLoss(_Deviceless):
    def forward(self, logits, target):
        return autograd.softmax_cross_entropy(logits, target)


class MSELoss(_Deviceless):
    def forward(self, x, t):
        return autograd.mse_loss(x, t)
