"""Layers, ported from ``singa_tpu/layer.py``: ``Layer``, ``Linear``,
``Embedding``, ``RMSNorm``.

Layers are ``nn.Module``s whose parameters are created at construction
(the reference initializes lazily from the first input; here the caller
gives the input width).  Parameters are f32 masters named as in the
reference (``W``, ``table``, ``gamma``), so ``get_params()`` keys are
the reference's attribute paths one to one.  Random init draws from an
explicit ``torch.Generator`` on the layer's device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from . import autograd
from .device import Device, get_default_device

__all__ = ["Layer", "Linear", "Embedding", "RMSNorm"]


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
