"""Operators of the Llama path, ported from ``singa_tpu/autograd.py``:
the forward math of Linear, Embedding, Cast, SiLU and RMSNorm, the
train/eval flag, ``backward``, and the two losses
(``softmax_cross_entropy`` and ``fused_linear_cross_entropy``).

Plain functions on ``torch.Tensor`` with the reference's dtype rules.
torch autograd is the tape: the reference's ``Operator``/``backward``
machinery is not rebuilt, only its public surface.  A cast of an f32
master to bf16 passes its gradient back as f32, as the reference's
``Cast.backward`` does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["linear", "embedding", "cast", "silu", "rmsnorm",
           "set_training", "is_training", "train_mode", "eval_mode",
           "backward", "softmax_cross_entropy", "cross_entropy",
           "fused_linear_cross_entropy"]

# global train/eval flag (reference: autograd.training)
training: bool = False


def set_training(flag: bool) -> None:
    global training
    training = bool(flag)


def is_training() -> bool:
    return training


class _TrainingScope:
    def __init__(self, flag):
        self.flag = flag

    def __enter__(self):
        self.prev = training
        set_training(self.flag)

    def __exit__(self, *a):
        set_training(self.prev)


def train_mode():
    return _TrainingScope(True)


def eval_mode():
    return _TrainingScope(False)


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """y = x @ W (+ b), W of shape (in, out)."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup: out[i] = table[ids[i]]."""
    return F.embedding(ids.long(), table)


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """Statistics in f32, output in the input dtype (Llama style)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma).to(x.dtype)


# ---------------------------------------------------------------------------
# reverse pass
# ---------------------------------------------------------------------------

def _reachable_leaves(y: torch.Tensor) -> List[torch.Tensor]:
    """Leaves of y's graph that take a gradient, in discovery order."""
    leaves, seen = [], set()
    stack = [y.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        var = getattr(node, "variable", None)      # AccumulateGrad
        if var is not None:
            leaves.append(var)
        stack.extend(fn for fn, _ in node.next_functions)
    return leaves


def backward(y: torch.Tensor, dy: Optional[torch.Tensor] = None
             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Gradients of y with respect to every leaf its graph reaches that
    takes a gradient (the model's parameters): a list of (param, grad)
    pairs, as the reference's ``autograd.backward`` returns; also sets
    ``param.grad``.  `dy` defaults to ones."""
    if y.grad_fn is None:
        return []
    leaves = _reachable_leaves(y)
    if dy is None:
        dy = torch.ones_like(y)
    grads = torch.autograd.grad(y, leaves, grad_outputs=dy)
    for t, g in zip(leaves, grads):
        t.grad = g
    return list(zip(leaves, grads))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, target) -> torch.Tensor:
    """Mean softmax cross-entropy over the leading dims of `logits`.

    Targets: integer class ids (any leading batch dims) or one-hot /
    probabilities.  The softmax runs in f32 whatever the logits' dtype;
    out-of-range ids (e.g. -1 padding) give zero loss and zero gradient,
    and still count in the mean, as in the reference."""
    target = torch.as_tensor(target, device=logits.device)
    V = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1).reshape(-1, V)
    n = logp.shape[0]
    if not target.is_floating_point():
        tgt = target.reshape(-1).long()
        valid = (tgt >= 0) & (tgt < V)
        picked = logp.gather(1, tgt.clamp(0, V - 1)[:, None])[:, 0]
        return -torch.where(valid, picked, torch.zeros_like(picked)).sum() / n
    return -(target.float().reshape(-1, V) * logp).sum() / n


# the reference exposes this op under both names
cross_entropy = softmax_cross_entropy


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated and returned in f32: the reference's
    ``jnp.dot(..., preferred_element_type=f32)``.  bf16 operands (on the
    card) go to one cuBLAS product with an f32 output (``out_dtype``), so
    the logits are never rounded to bf16 before the lse."""
    if a.dtype == torch.float32:
        return a @ b
    return torch.mm(a, b, out_dtype=torch.float32)


class _FusedLinearCE(torch.autograd.Function):
    """lm-head matmul + softmax-CE over row chunks: the (n, V) logits
    are never materialised.  The forward keeps each row's lse; the
    backward recomputes each chunk's logits and accumulates dW in f32
    (the reference's FusedLinearCrossEntropy)."""

    @staticmethod
    def forward(ctx, h, w, target, chunk):
        n, d = h.shape
        V = w.shape[-1]
        wc = w.to(h.dtype)
        tgt = target.reshape(-1).long()
        valid = (tgt >= 0) & (tgt < V)
        tgt = tgt.clamp(0, V - 1)
        lse = torch.empty(n, dtype=torch.float32, device=h.device)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for s in range(0, n, chunk):
            lg = _mm_f32(h[s:s + chunk], wc)
            lse[s:s + chunk] = torch.logsumexp(lg, dim=-1)
            zt = lg.gather(1, tgt[s:s + chunk, None])[:, 0]
            total += torch.where(valid[s:s + chunk], lse[s:s + chunk] - zt,
                                 torch.zeros_like(zt)).sum()
        ctx.save_for_backward(h, wc, tgt, valid, lse)
        ctx.chunk, ctx.w_dtype = chunk, w.dtype
        return total / n

    @staticmethod
    def backward(ctx, dy):
        h, wc, tgt, valid, lse = ctx.saved_tensors
        n = h.shape[0]
        scale = dy.float() / n
        dw = torch.zeros(wc.shape, dtype=torch.float32, device=h.device)
        dh = torch.empty_like(h)
        rows = torch.arange(min(ctx.chunk, n), device=h.device)
        for s in range(0, n, ctx.chunk):
            hc = h[s:s + ctx.chunk]
            c = hc.shape[0]
            g = torch.exp(_mm_f32(hc, wc) - lse[s:s + c, None])
            g[rows[:c], tgt[s:s + c]] -= 1.0
            g = (g * valid[s:s + c, None] * scale).to(h.dtype)
            dw += _mm_f32(hc.t(), g)
            dh[s:s + c] = _mm_f32(g, wc.t()).to(h.dtype)
        return dh, dw.to(ctx.w_dtype), None, None


def fused_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor, target,
                               chunk_rows: int = 512) -> torch.Tensor:
    """``softmax_cross_entropy(h @ w, target)`` for integer class-id
    targets, row-chunked so the (n, V) logits are never materialised."""
    target = torch.as_tensor(target, device=h.device)
    if target.is_floating_point() or target.dtype == torch.bool:
        raise TypeError(
            "fused_linear_cross_entropy needs integer class-id targets, "
            f"got dtype {target.dtype}; use "
            "softmax_cross_entropy(linear(h, w), target) for "
            "one-hot/probability targets")
    return _FusedLinearCE.apply(h, w, target, int(chunk_rows))
