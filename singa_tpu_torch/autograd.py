"""Operators ported from ``singa_tpu/autograd.py``: the forward math of
Linear, Embedding, Cast, SiLU and RMSNorm (the Llama path); of ReLU,
Tanh, Sigmoid, Dropout, Flatten, ReduceMean, Conv2d, MaxPool2d,
AvgPool2d and BatchNorm (the CNN path); of LayerNorm, Gelu, Softmax and
LogSoftmax (the GPT-2 and BERT path); the train/eval flag,
``backward``, and the losses (``softmax_cross_entropy``,
``fused_linear_cross_entropy``, ``mse_loss``).  Functions with a
one-node ONNX form are marked ``@unit`` for the exporter (``_unit``).

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

from ._unit import unit

__all__ = ["linear", "embedding", "cast", "silu", "rmsnorm", "layernorm",
           "gelu", "softmax", "log_softmax", "relu",
           "tanh", "sigmoid", "dropout", "flatten", "reduce_mean",
           "conv2d", "max_pool2d", "avg_pool2d", "batchnorm",
           "set_training", "is_training", "train_mode", "eval_mode",
           "backward", "softmax_cross_entropy", "cross_entropy",
           "fused_linear_cross_entropy", "mse_loss"]

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


@unit("linear")
def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """y = x @ W (+ b), W of shape (in, out)."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


# a table whose rows repeat at least this many times on average in one
# batch (BERT's token types: 16,384) sums its gradient as a one-hot
# product; others (vocabularies, positions) by a sort
_ONE_HOT_REPEATS = 128


class _Embedding(torch.autograd.Function):
    """Row lookup whose backward adds each row's gradients in a fixed
    order.  torch's CUDA embedding backward adds a row that many tokens
    share (BERT's positions and token types: hundreds to thousands of
    repeats) in an order that changes from run to run, so two runs of
    one step, eager or captured, would part in the last bits.  Here the
    gradient is index_put_ with accumulate, which on the card sorts the
    ids stably and adds each row's repeats one after another; where
    every row repeats many times that serial sum would be slow, and the
    gradient is onehot(ids)ᵀ · dy, a matmul of 2·rows·N·D FLOPs, instead.
    The choice reads shapes only, so a captured step makes it too."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        ids = ids.reshape(-1)
        g = dy.reshape(-1, dy.shape[-1])
        if ids.numel() >= _ONE_HOT_REPEATS * ctx.rows:
            rows = torch.arange(ctx.rows, device=ids.device)
            return (rows[:, None] == ids).to(g.dtype) @ g, None
        dw = g.new_zeros(ctx.rows, g.shape[1])
        return dw.index_put_((ids,), g, accumulate=True), None


@unit("embedding")
def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup: out[i] = table[ids[i]]; the table's gradient is summed
    in a fixed order (`_Embedding`)."""
    return _Embedding.apply(table, ids.long())


@unit("cast")
def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


@unit("rmsnorm")
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """Statistics in f32, output in the input dtype (Llama style)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma).to(x.dtype)


@unit("layernorm")
def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * gamma + beta over the last axis:
    statistics in f32 (a bf16 variance loses rows of near-zero spread),
    output in the input dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


@unit("gelu")
def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """GELU: ``approximate=True`` is the tanh form (GPT-2's gelu_new),
    False the exact erf form (BERT)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


@unit("softmax")
def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


@unit("log_softmax")
def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=axis)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def dropout(x: torch.Tensor, p: float = 0.5,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Zero each element with probability p and scale the rest by
    1/(1-p) in training; the identity in eval or at p = 0.  The mask is
    drawn from `generator` (the reference draws from a jax key)."""
    if not training or p <= 0.0:
        return x
    keep = 1.0 - p
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=generator).bool()
    return torch.where(mask, x * (1.0 / keep), torch.zeros_like(x))


def flatten(x: torch.Tensor, start_axis: int = 0) -> torch.Tensor:
    """Keep the dims before `start_axis`, merge the rest (row-major, so
    an NHWC map flattens in (H, W, C) order)."""
    return x.reshape(tuple(x.shape[:start_axis]) + (-1,))


def reduce_mean(x: torch.Tensor, axis=None, keepdims: bool = False):
    if axis is None:
        return x.mean()
    return x.mean(dim=axis, keepdim=keepdims)


def mse_loss(x: torch.Tensor, t) -> torch.Tensor:
    """sum((x - t)^2) / x.numel()."""
    d = x - torch.as_tensor(t, device=x.device, dtype=x.dtype)
    return (d * d).sum() / float(d.numel())


# ---------------------------------------------------------------------------
# conv / pool / norm: NHWC activations, HWIO weights, as in the reference.
# The ops compute through NCHW views of NHWC tensors (channels-last
# memory, which cuDNN reads as it is), so no activation is copied into
# another layout.
# ---------------------------------------------------------------------------

def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_pads(padding, size, kernel, stride, dilation):
    """((top, bottom), (left, right)) as XLA reads `padding`: an int, a
    pair of ints, a pair of (low, high) pairs, "VALID", or "SAME"
    (output ceil(size / stride), the low side taking total // 2)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return ((0, 0), (0, 0))
        if mode != "SAME":
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        pads = []
        for n, k, s, d in zip(size, kernel, stride, dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return tuple(tuple(p) if isinstance(p, (tuple, list)) else (p, p)
                 for p in padding)


@unit("conv2d")
def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride=1, padding=0,
           groups: int = 1, dilation=1) -> torch.Tensor:
    """2-D convolution of an NHWC `x` with an HWIO `w` (I = C / groups);
    the output is NHWC in x's dtype.  `padding` as `_conv_pads`; pads
    that F.conv2d cannot express (low != high) are applied first."""
    stride, dilation = _pair(stride), _pair(dilation)
    (pt, pb), (pl, pr) = _conv_pads(padding, x.shape[1:3], w.shape[:2],
                                    stride, dilation)
    xc = x.permute(0, 3, 1, 2)
    if pt != pb or pl != pr:
        xc = F.pad(xc, (pl, pr, pt, pb))
        pt = pl = 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), b, stride, (pt, pl), dilation,
                 groups)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _pool(fn, x, kernel, stride, padding, fill):
    """Run an NCHW pool on the NCHW view of NHWC `x`; pads wider than
    half the window (which the torch pools refuse) are applied first
    with `fill`."""
    kernel = _pair(kernel)
    stride = _pair(stride or kernel)
    xc = x.permute(0, 3, 1, 2)
    if padding > min(kernel) // 2:
        xc = F.pad(xc, (padding,) * 4, value=fill)
        padding = 0
    return fn(xc, kernel, stride, padding).permute(0, 2, 3, 1)


@unit("max_pool2d")
def max_pool2d(x: torch.Tensor, kernel, stride=None, padding: int = 0):
    """Max over windows of an NHWC `x`, padded with -inf."""
    return _pool(F.max_pool2d, x, kernel, stride, padding, float("-inf"))


@unit("avg_pool2d")
def avg_pool2d(x: torch.Tensor, kernel, stride=None, padding: int = 0):
    """Mean over windows of an NHWC `x`, padded with 0 and divided by
    the full window (count_include_pad)."""
    return _pool(F.avg_pool2d, x, kernel, stride, padding, 0.0)


@unit("batchnorm")
def batchnorm(x: torch.Tensor, gamma, beta, mean, var, eps: float = 1e-5):
    """(x - mean) / sqrt(var + eps) * gamma + beta over the last axis,
    computed in f32 from whatever dtypes the statistics and affine
    parameters come in; the output is in x's dtype.  The four per-channel
    vectors fold into scale = gamma / sqrt(var + eps) and shift = beta -
    mean * scale first, so x passes through one activation-sized op (and
    autograd saves x once); their gradients flow through scale and
    shift."""
    scale = torch.rsqrt(var.float() + eps) * gamma
    shift = beta - mean * scale
    return torch.addcmul(shift, x.float(), scale).to(x.dtype)


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
