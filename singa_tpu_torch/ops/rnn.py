"""Recurrences over time, shared by ``layer.RNN`` / ``layer.LSTM`` and
the ONNX importer's ``RNN`` / ``LSTM`` nodes (``sonnx.backend``).

The reference runs its cells as one ``lax.scan`` that XLA fuses; no
Pallas kernel is on this path, so the port's recurrence is plain torch:
the input projection of every step is one product hoisted out of the
loop (`pre`, (T, B, G·H)), and only the (B, H) × (H, G·H) recurrent
product runs step by step, in a Python loop that a CUDA-graph capture
unrolls.  torch autograd differentiates it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .._unit import unit

__all__ = ["lstm_steps", "rnn_steps", "scan"]

#: the layer's LSTM gate blocks (i, f, g, o) in its own order; ONNX's
#: order is i, o, f, c
LAYER_GATES = (0, 1, 2, 3)
ONNX_GATES = (0, 2, 3, 1)


def _clipped(z: torch.Tensor, clip: Optional[float]) -> torch.Tensor:
    return z if clip is None else torch.clamp(z, -clip, clip)


def lstm_steps(pre: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
               r: torch.Tensor, gates: Sequence[int] = LAYER_GATES,
               f_act: Callable = torch.sigmoid, g_act: Callable = torch.tanh,
               h_act: Callable = torch.tanh, clip: Optional[float] = None):
    """The LSTM over `pre` (T, B, 4H), the input projections with both
    biases: at each step z = pre[t] + h @ r (r (H, 4H)), its gate blocks
    at positions `gates` = (i, f, g, o); c = f·c + i·g, h = o·h_act(c).
    Returns (outputs (T, B, H), last h, last c)."""
    H = h.shape[-1]
    ys = []
    for t in range(pre.shape[0]):
        z = _clipped(pre[t] + h @ r, clip)
        i, f, g, o = (z[..., k * H:(k + 1) * H] for k in gates)
        c = f_act(f) * c + f_act(i) * g_act(g)
        h = f_act(o) * h_act(c)
        ys.append(h)
    return torch.stack(ys), h, c


def rnn_steps(pre: torch.Tensor, h: torch.Tensor, r: torch.Tensor,
              act: Callable = torch.tanh, clip: Optional[float] = None):
    """The plain RNN over `pre` (T, B, H): h = act(pre[t] + h @ r).
    Returns (outputs (T, B, H), last h)."""
    ys = []
    for t in range(pre.shape[0]):
        h = act(_clipped(pre[t] + h @ r, clip))
        ys.append(h)
    return torch.stack(ys), h


@unit("rnn_scan")
def scan(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
         b: torch.Tensor, kind: str) -> torch.Tensor:
    """The reference's ``_ScanRNNOp`` for a ``layer.LSTM`` (`kind`
    "LSTM": gates i, f, g, o) or ``layer.RNN`` ("RNN": tanh): x (B, T,
    D), wx (D, G·H), wh (H, G·H), b (G·H,); the first state is zeros.
    Returns the hidden states (B, T, H).  One unit for the exporter,
    which writes a real ONNX LSTM or RNN node."""
    H = wh.shape[0]
    pre = (torch.matmul(x, wx) + b).transpose(0, 1)       # (T, B, G·H)
    h0 = x.new_zeros((x.shape[0], H))
    if kind == "LSTM":
        ys = lstm_steps(pre, h0, h0, wh)[0]
    elif kind == "RNN":
        ys = rnn_steps(pre, h0, wh)[0]
    else:
        raise ValueError(f"unknown recurrent cell {kind!r}")
    return ys.transpose(0, 1)
