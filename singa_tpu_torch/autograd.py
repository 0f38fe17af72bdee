"""Operators ported from ``singa_tpu/autograd.py``: the forward math of
Linear, Embedding, Cast, SiLU and RMSNorm (the Llama path); of ReLU,
Tanh, Sigmoid, Dropout, Flatten, ReduceMean, Conv2d, MaxPool2d,
AvgPool2d and BatchNorm (the CNN path); of LayerNorm, Gelu, Softmax and
LogSoftmax (the GPT-2 and BERT path); the train/eval flag,
``backward``, the losses (``softmax_cross_entropy``,
``fused_linear_cross_entropy``, ``mse_loss``), and the rest of the
reference's public functions (tensor math, shapes and indexing,
activations, ``where`` and reductions, the other losses,
trigonometric, rounding, comparison and logic, ``grad_of``).  Functions
with a one-node ONNX form are marked ``@unit`` for the exporter
(``_unit``).

Plain functions on ``torch.Tensor`` with the reference's dtype rules.
torch autograd is the tape.  ``Operator``, the reference's base class
for user-defined ops, is a ``torch.autograd.Function`` underneath: a
subclass gives a hand-written ``forward``/``backward``, or only
``fwd``, which torch autograd differentiates (the reference uses
``jax.vjp``).  A cast of an f32 master to bf16 passes its gradient back
as f32, as the reference's ``Cast.backward`` does.

What switches the tape on differs from the reference, and is stated:
here it is torch's grad mode (an op records a gradient when grad mode
is on and an input requires one), for every public function and for
``Operator``; in the reference it is ``autograd.training``
(``singa_tpu/autograd.py:145-146``).  So with ``training`` False (the
default, and eval mode) and grad mode on, the reference's ``backward``
returns [] where the port records a gradient, and a fwd-only
``Operator`` takes the torch path where the reference may run its
``native_fwd``.  Under ``torch.no_grad()`` the two agree.  ``training``
still switches what the reference's flag switches beside the tape
(dropout, BatchNorm's statistics, a ``Remat``'s checkpoint).

The native CPU dispatch (``device.CppCPU(use_native=True)`` as the
default device): the reference's nine ops with a ``native_fwd`` (add,
mul, matmul, linear, relu, sigmoid, tanh, softmax, conv2d) run as
such an ``Operator`` whose forward is the host kernel of ``_core``,
under the reference's conditions (`Operator._native_candidate`):
concrete f32 CPU tensors, no trace or dispatch mode active, and a
hand-written backward or no gradient needed (so conv2d goes native
only without a gradient); each op keeps its shape conditions (equal
shapes for add and mul, 2-D for matmul and linear, symmetric pads and
no groups or dilation for conv2d).  Otherwise, and always on the card,
a public function is what it was: the check is one read of
``device._native_cpu``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import device as _device
from ._unit import unit

__all__ = ["Operator", "training", "linear", "embedding", "cast", "silu",
           "rmsnorm", "layernorm",
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


# ---------------------------------------------------------------------------
# Operator: the reference's base class for user-defined ops
# ---------------------------------------------------------------------------

def _host_f32(*ts) -> bool:
    """Whether each of `ts` is a concrete f32 tensor in host memory and
    no trace, dispatch or function mode is active: what the host kernels
    may read by address."""
    if torch._C._len_torch_dispatch_stack() or \
            torch._C._len_torch_function_stack() or torch.jit.is_tracing():
        return False
    return all(type(t) in (torch.Tensor, torch.nn.Parameter)
               and t.dtype == torch.float32 and t.device.type == "cpu"
               and not torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in ts)


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    """Sum gradient `g` back to `shape` after broadcasting."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    g = g.sum(dim=tuple(range(g.ndim - len(shape)))) if g.ndim > len(shape) \
        else g
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


class _OperatorFn(torch.autograd.Function):
    """An Operator with a hand-written backward under torch autograd."""

    @staticmethod
    def forward(ctx, op, native, *xs):
        ctx.op = op
        return op._run_forward(native, xs)

    @staticmethod
    def backward(ctx, *dys):
        grads = ctx.op.backward(*dys)
        if not isinstance(grads, tuple):
            grads = (grads,)
        return (None, None, *grads)


class Operator:
    """A differentiable op (port of ``singa_tpu/autograd.py:84-160``).

    A subclass either
      * defines ``fwd(self, *tensors)`` (torch ops), which torch autograd
        differentiates, or
      * overrides ``forward``/``backward`` for a hand-written rule:
        ``backward(*dys)`` returns one gradient per input (a tuple, or
        the tensor of a one-input op).
    It may define ``native_fwd(self, *tensors)``, a forward through the
    host kernels of ``_core`` that returns a tensor (or a numpy array),
    or None where its conditions do not hold; it runs where
    `_native_candidate` says.  Calling the op on tensors returns its
    output, with a gradient where one is needed."""

    # comparisons/logical ops set this False: their outputs take no
    # gradient
    differentiable = True

    def __init__(self):
        self.requires_grad = False

    # -- to be provided by subclasses ---------------------------------------
    def fwd(self, *xs):  # pragma: no cover - overridden
        raise NotImplementedError

    def forward(self, *xs):
        return self.fwd(*xs)

    def backward(self, *dys):
        raise NotImplementedError(
            f"{type(self).__name__} has no hand-written backward: torch "
            f"autograd differentiates its fwd")

    # -- native CPU dispatch (tensor_math_cpp parity) ------------------------
    def _hand_written(self) -> bool:
        return type(self).backward is not Operator.backward

    def _native_candidate(self, xs) -> bool:
        """The reference's rule: a `native_fwd`, the native CPU device
        as the default, concrete f32 host inputs, and a hand-written
        backward or no gradient needed (torch autograd needs the torch
        forward)."""
        if not xs or not hasattr(self, "native_fwd") or \
                not _device._native_cpu or not _host_f32(*xs):
            return False
        return self._hand_written() or not self.requires_grad

    def _run_forward(self, native: bool, xs):
        out = self.native_fwd(*xs) if native else None
        if out is None:
            return self.forward(*xs)
        if isinstance(out, np.ndarray):
            out = torch.from_numpy(out)
        return out

    def __call__(self, *inputs: torch.Tensor):
        for x in inputs:
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"{type(self).__name__} got non-tensor "
                                f"input {type(x)}")
        self.requires_grad = (torch.is_grad_enabled() and self.differentiable
                              and any(x.requires_grad for x in inputs))
        native = self._native_candidate(inputs)
        if not self.requires_grad:
            with torch.no_grad():
                return self._run_forward(native, inputs)
        if self._hand_written():
            return _OperatorFn.apply(self, native, *inputs)
        return self.forward(*inputs)


# the ops the reference's CppCPU runs natively
class _Add(Operator):
    def forward(self, a, b):
        self._sa, self._sb = a.shape, b.shape
        return a + b

    def native_fwd(self, a, b):
        if a.shape != b.shape:
            return None          # broadcast handled by the torch path
        self._sa = self._sb = a.shape
        from . import _core
        return _core.add(a, b)

    def backward(self, dy):
        return _unbroadcast(dy, self._sa), _unbroadcast(dy, self._sb)


class _Mul(Operator):
    def forward(self, a, b):
        self._a, self._b = a, b
        return a * b

    def native_fwd(self, a, b):
        if a.shape != b.shape:
            return None
        self._a, self._b = a, b
        from . import _core
        return _core.mul(a, b)

    def backward(self, dy):
        return (_unbroadcast(dy * self._b, self._a.shape),
                _unbroadcast(dy * self._a, self._b.shape))


class _Matmul(Operator):
    def forward(self, a, b):
        self._a, self._b = a, b
        return torch.matmul(a, b)

    def native_fwd(self, a, b):
        if a.ndim != 2 or b.ndim != 2:
            return None
        self._a, self._b = a, b
        from . import _core
        return _core.gemm(a, b)

    def backward(self, dy):
        a, b = self._a, self._b
        ga = torch.matmul(dy, b.transpose(-1, -2))
        gb = torch.matmul(a.transpose(-1, -2), dy)
        return _unbroadcast(ga, a.shape), _unbroadcast(gb, b.shape)


class _Linear(Operator):
    """y = x @ W (+ b)."""

    def __init__(self, has_bias: bool):
        super().__init__()
        self.has_bias = has_bias

    def forward(self, x, w, *b):
        self._x, self._w = x, w
        y = torch.matmul(x, w)
        return y + b[0] if self.has_bias else y

    def native_fwd(self, x, w, *b):
        if x.ndim != 2:
            return None
        self._x, self._w = x, w
        from . import _core
        y = _core.gemm(x, w)
        if self.has_bias:
            y += b[0]
        return y

    def backward(self, dy):
        x, w = self._x, self._w
        gx = torch.matmul(dy, w.T)
        lead = int(np.prod(x.shape[:-1]))
        dy2 = dy.reshape(lead, dy.shape[-1])
        gw = torch.matmul(x.reshape(lead, x.shape[-1]).T, dy2)
        if self.has_bias:
            return gx, gw, dy2.sum(dim=0)
        return gx, gw


class _ReLU(Operator):
    def forward(self, a):
        self._mask = a > 0
        return torch.where(self._mask, a, 0.0)

    def native_fwd(self, a):
        self._mask = a > 0
        from . import _core
        return _core.relu(a)

    def backward(self, dy):
        return torch.where(self._mask, dy, 0.0)


class _Sigmoid(Operator):
    def forward(self, a):
        self._y = torch.sigmoid(a)
        return self._y

    def native_fwd(self, a):
        from . import _core
        self._y = _core.sigmoid(a)
        return self._y

    def backward(self, dy):
        return dy * self._y * (1 - self._y)


class _Tanh(Operator):
    def forward(self, a):
        self._y = torch.tanh(a)
        return self._y

    def native_fwd(self, a):
        from . import _core
        self._y = _core.tanh(a)
        return self._y

    def backward(self, dy):
        return dy * (1 - self._y * self._y)


class _Softmax(Operator):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, a):
        self._y = torch.softmax(a, dim=self.axis)
        return self._y

    def native_fwd(self, a):
        if self.axis not in (-1, a.ndim - 1):
            return None
        from . import _core
        self._y = _core.softmax(a)
        return self._y

    def backward(self, dy):
        y = self._y
        return y * (dy - (dy * y).sum(dim=self.axis, keepdim=True))


class _Conv2d(Operator):
    """`conv2d` by its torch forward, differentiated by torch autograd;
    the host kernel serves a call that needs no gradient (as the
    reference's)."""

    def __init__(self, stride, padding, groups, dilation):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.groups, self.dilation = groups, dilation

    def fwd(self, x, w, *b):
        return _conv2d(x, w, b[0] if b else None, self.stride, self.padding,
                       self.groups, self.dilation)

    def native_fwd(self, x, w, *b):
        if self.groups != 1 or _pair(self.dilation) != (1, 1) or \
                isinstance(self.padding, str):
            return None
        stride = _pair(self.stride)
        (pt, pb), (pl, pr) = _conv_pads(self.padding, x.shape[1:3],
                                        w.shape[:2], stride, (1, 1))
        if pt != pb or pl != pr:
            return None
        from . import _core
        y = _core.conv2d_nhwc(x, w, stride, (pt, pl))
        return y + b[0] if b else y


@unit("linear")
def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """y = x @ W (+ b), W of shape (in, out)."""
    if _device._native_cpu:
        xs = (x, w) if b is None else (x, w, b)
        if _host_f32(*xs):
            return _Linear(b is not None)(*xs)
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
    if _device._native_cpu and _host_f32(x):
        return _Softmax(axis)(x)
    return torch.softmax(x, dim=axis)


@unit("log_softmax")
def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=axis)


def relu(x: torch.Tensor) -> torch.Tensor:
    if _device._native_cpu and _host_f32(x):
        return _ReLU()(x)
    return torch.relu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    if _device._native_cpu and _host_f32(x):
        return _Tanh()(x)
    return torch.tanh(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    if _device._native_cpu and _host_f32(x):
        return _Sigmoid()(x)
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
    if _device._native_cpu:
        xs = (x, w) if b is None else (x, w, b)
        if _host_f32(*xs):
            return _Conv2d(stride, padding, groups, dilation)(*xs)
    return _conv2d(x, w, b, stride, padding, groups, dilation)


def _conv2d(x, w, b, stride, padding, groups, dilation) -> torch.Tensor:
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
    are never materialised.  The forward keeps each row's lse (the steps
    of ``torch.logsumexp``); the backward recomputes each chunk's logits
    and accumulates dW in f32 (the reference's FusedLinearCrossEntropy).

    With `axis`, w holds this rank's columns of a vocabulary of `vocab`
    cut over that mesh axis (``parallel.tensor_parallel``): each row's
    max and sum of exponentials are all-reduced over it, and the
    target's logit taken on the rank that holds it; dh is then this
    rank's part, which the caller's ``copy_to_region`` sums.  On an axis
    of one rank every value is the plain function's, bit for bit.  The
    summed loss is divided by `denom` (default n, the mean)."""

    @staticmethod
    def forward(ctx, h, w, target, chunk, vocab=None, denom=None,
                axis=None):
        n = h.shape[0]
        V = w.shape[-1]
        wc = w.to(h.dtype)
        tgt = target.reshape(-1).long()
        valid = (tgt >= 0) & (tgt < (vocab or V))
        if axis is None:
            def allreduce(x, op):
                return x
        else:
            from .parallel import communicator as comm

            def allreduce(x, op):
                return comm.allreduce(x, axis, op)
            tgt = tgt - comm.axis_index(axis) * V
        mine = (tgt >= 0) & (tgt < V)
        tgt = tgt.clamp(0, V - 1)
        lse = torch.empty(n, dtype=torch.float32, device=h.device)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for s in range(0, n, chunk):
            lg = _mm_f32(h[s:s + chunk], wc)
            mx = allreduce(lg.amax(dim=-1, keepdim=True), "max")
            mx.masked_fill_(mx.abs() == float("inf"), 0.0)
            se = allreduce((lg - mx).exp_().sum(dim=-1), "sum")
            lse[s:s + chunk] = se.log_().add_(mx[:, 0])
            zt = lg.gather(1, tgt[s:s + chunk, None])[:, 0]
            zt = allreduce(torch.where(mine[s:s + chunk], zt,
                                       torch.zeros_like(zt)), "sum")
            total += torch.where(valid[s:s + chunk], lse[s:s + chunk] - zt,
                                 torch.zeros_like(zt)).sum()
        ctx.save_for_backward(h, wc, tgt, mine, valid, lse)
        ctx.chunk, ctx.w_dtype = chunk, w.dtype
        ctx.denom = float(n if denom is None else denom)
        return total / ctx.denom

    @staticmethod
    def backward(ctx, dy):
        h, wc, tgt, mine, valid, lse = ctx.saved_tensors
        n = h.shape[0]
        scale = dy.float() / ctx.denom
        dw = torch.zeros(wc.shape, dtype=torch.float32, device=h.device)
        dh = torch.empty_like(h)
        rows = torch.arange(min(ctx.chunk, n), device=h.device)
        for s in range(0, n, ctx.chunk):
            hc = h[s:s + ctx.chunk]
            c = hc.shape[0]
            g = torch.exp(_mm_f32(hc, wc) - lse[s:s + c, None])
            g[rows[:c], tgt[s:s + c]] -= mine[s:s + c].to(g.dtype)
            g = (g * valid[s:s + c, None] * scale).to(h.dtype)
            dw += _mm_f32(hc.t(), g)
            dh[s:s + c] = _mm_f32(g, wc.t()).to(h.dtype)
        return dh, dw.to(ctx.w_dtype), None, None, None, None, None


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


# ---------------------------------------------------------------------------
# the rest of the reference's surface: tensor math, shapes and indexing,
# activations, where and reductions, losses, trigonometric, rounding,
# comparison and logic.  Each computes what ``singa_tpu.autograd``
# computes and takes the gradient it gives (its hand-written backwards,
# or jax.vjp of its forward); a scalar operand takes the dtype of the
# tensor beside it, as the reference's ``_as_t`` does.  Integer and
# boolean results (comparisons, logic, ``mod``, ``onehot``,
# ``shape_of``) take no gradient, as the reference's non-differentiable
# ops.  Each is a unit ``autograd.<name>`` for the exporter.
# ---------------------------------------------------------------------------

def _as_t(v, like: torch.Tensor) -> torch.Tensor:
    """`v` as a tensor on `like`'s device; a non-tensor in `like`'s
    dtype (the reference's ``_as_t``).  A scalar is written by a fill,
    not copied from the host, so a CUDA-graph capture may take it."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (int, float, np.number, np.bool_)):
        return torch.full((), v, dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(v), device=like.device).to(like.dtype)


def _jclip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi), whose gradient is halved where
    x sits on a bound (a tie of max or min), unlike ``clamp``'s."""
    lo, hi = _as_t(lo, x), _as_t(hi, x)
    return torch.minimum(torch.maximum(x, lo), hi)


@unit("autograd.add")
def add(a, b):
    if _device._native_cpu and isinstance(b, torch.Tensor) and \
            _host_f32(a, b):
        return _Add()(a, b)
    return a + _as_t(b, a)


@unit("autograd.sub")
def sub(a, b):
    return a - _as_t(b, a)


@unit("autograd.mul")
def mul(a, b):
    if _device._native_cpu and isinstance(b, torch.Tensor) and \
            _host_f32(a, b):
        return _Mul()(a, b)
    return a * _as_t(b, a)


@unit("autograd.div")
def div(a, b):
    return a / _as_t(b, a)


@unit("autograd.neg")
def neg(a):
    return -a


@unit("autograd.pow")
def pow(a, p):
    """a ** p for a scalar p; the gradient is p·a^(p−1)."""
    return torch.pow(a, p)


@unit("autograd.abs")
def abs(a):
    """|a|; the gradient is sign(a) (0 at 0)."""
    return torch.abs(a)


@unit("autograd.exp")
def exp(a):
    return torch.exp(a)


@unit("autograd.log")
def log(a):
    return torch.log(a)


@unit("autograd.sqrt")
def sqrt(a):
    return torch.sqrt(a)


@unit("autograd.rsqrt")
def rsqrt(a):
    return torch.rsqrt(a)


@unit("autograd.clip")
def clip(a, lo, hi):
    """a clipped to [lo, hi]; the gradient passes where lo <= a <= hi,
    both bounds included (the reference's Clip mask)."""
    return torch.clamp(a, lo, hi)


@unit("autograd.erf")
def erf(a):
    return torch.erf(a)


@unit("autograd.matmul")
def matmul(a, b):
    if _device._native_cpu and _host_f32(a, b):
        return _Matmul()(a, b)
    return torch.matmul(a, b)


@unit("autograd.einsum")
def einsum(subscripts: str, *ts):
    return torch.einsum(subscripts, *ts)


@unit("autograd.tensordot")
def tensordot(a, b, axes=2):
    b = _as_t(b, a)
    if not isinstance(axes, int):
        axes = [list(np.atleast_1d(ax)) for ax in axes]
    return torch.tensordot(a, b, dims=axes)


@unit("autograd.add_bias")
def add_bias(x, b, axis: int = 1):
    """x + b with the vector b laid along `axis`."""
    shape = [1] * x.dim()
    shape[axis] = b.shape[0]
    return x + b.reshape(shape)


# -- shapes and indexing ------------------------------------------------------

def _axes(axis, nd: int) -> Tuple[int, ...]:
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    return tuple(a % nd for a in axis)


@unit("autograd.reshape")
def reshape(a, shape):
    return a.reshape(tuple(shape))


@unit("autograd.transpose")
def transpose(a, axes=None):
    """The axes permuted; None reverses them (``a.T``)."""
    if axes is None:
        axes = tuple(reversed(range(a.dim())))
    return a.permute(*axes)


@unit("autograd.squeeze")
def squeeze(a, axis=None):
    """Drop size-1 axes (all of them, or `axis`, which must be size 1,
    as ``jnp.squeeze`` requires)."""
    if axis is None:
        return a.reshape([s for s in a.shape if s != 1])
    axes = _axes(axis, a.dim())
    if any(a.shape[i] != 1 for i in axes):
        raise ValueError(f"cannot squeeze axes {axis} of shape "
                         f"{tuple(a.shape)}: not of size one")
    return a.reshape([s for i, s in enumerate(a.shape) if i not in axes])


@unit("autograd.unsqueeze")
def unsqueeze(a, axis):
    """New size-1 axes at `axis` (an int or a list, inserted in sorted
    order)."""
    for ax in sorted(axis if isinstance(axis, (list, tuple)) else [axis]):
        a = a.unsqueeze(ax)
    return a


@unit("autograd.cat")
def cat(ts, axis: int = 0):
    return torch.cat(list(ts), dim=axis)


@unit("autograd.stack")
def stack(ts, axis: int = 0):
    return torch.stack(list(ts), dim=axis)


@unit("autograd.split")
def split(a, parts, axis: int = 0):
    """An int: that many equal sections (``jnp.split``; a length that
    does not divide raises).  A list: sections of those sizes, cut at
    their running sums, the last section taking whatever remains (the
    reference cuts at ``cumsum(parts)[:-1]``).  Returns a tuple."""
    if isinstance(parts, int):
        n = a.shape[axis]
        if n % parts:
            raise ValueError(f"array split does not result in an equal "
                             f"division: {n} into {parts}")
        return tuple(torch.tensor_split(a, parts, dim=axis))
    cuts = np.cumsum(parts)[:-1].tolist()
    return tuple(torch.tensor_split(a, cuts, dim=axis))


def _wrap(i: torch.Tensor, n: int):
    """(index wrapped from the end, whether it lies in [0, n))."""
    w = torch.where(i < 0, i + n, i)
    return w, (w >= 0) & (w < n)


def _as_index(s, device: torch.device) -> torch.Tensor:
    """An integer or boolean index as a tensor on `device`.  A Python or
    numpy integer is written by a fill, not copied from the host, so a
    CUDA-graph capture may take it."""
    if isinstance(s, torch.Tensor):
        return s.to(device)
    if isinstance(s, (int, np.integer)) and not isinstance(s, (bool, np.bool_)):
        return torch.full((), int(s), dtype=torch.long, device=device)
    return torch.as_tensor(np.asarray(s), device=device)


@unit("autograd.index")
def index(a, idx):
    """a[idx] (ints, slices, None, Ellipsis and integer or boolean
    arrays, as numpy indexing).  An integer index past either end reads
    the edge, as jax's indexing clamps; its gradient is dropped, as the
    reference's ``.at[idx].add`` drops it.  Nothing is read back to the
    host, so a captured step may call it."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    if any(s is Ellipsis for s in idx):
        i = next(k for k, s in enumerate(idx) if s is Ellipsis)
        used = sum(1 if s is not None else 0 for s in idx) - 1
        for s in idx:
            if isinstance(s, (np.ndarray, torch.Tensor)) and \
                    s.dtype in (np.bool_, torch.bool):
                used += s.ndim - 1
        idx = idx[:i] + (slice(None),) * (a.dim() - used) + idx[i + 1:]
    parts = [s if s is None or isinstance(s, slice)
             else _as_index(s, a.device) for s in idx]
    arrays = [k for k, t in enumerate(parts) if isinstance(t, torch.Tensor)]
    # torch reads a 0-dim integer index back to the host (it selects), so
    # a scalar goes in as a 1-element array: beside an array index that
    # is numpy's reading of it too; with scalars only, the one axis they
    # add is squeezed where numpy's basic indexing would have dropped it
    squeeze = None
    if arrays and all(parts[k].dim() == 0 and parts[k].dtype != torch.bool
                      for k in arrays):
        apart = any(not isinstance(t, torch.Tensor)
                    for t in parts[arrays[0]:arrays[-1] + 1])
        squeeze = 0 if apart else arrays[0]

    def take(x, index):
        x = x[tuple(index)]
        return x if squeeze is None else x.squeeze(squeeze)

    # `valid` is read from a grid of 2 per integer-indexed axis (slot 1:
    # out of range), a's size per boolean-indexed axis and 1 elsewhere
    # (broadcast over y), True only at slot 0 of every integer axis
    clamped, sentinel, grid, at_zero = [], [], [], []
    dim = 0
    for t in parts:
        if t is None or isinstance(t, slice):
            clamped.append(t)
            sentinel.append(None if t is None else slice(None))
            if t is not None:
                grid.append(1)
                at_zero.append(slice(None))
                dim += 1
            continue
        if t.dtype == torch.bool:
            clamped.append(t)
            sentinel.append(t)
            grid.extend(a.shape[dim:dim + t.dim()])
            at_zero.extend([slice(None)] * t.dim())
            dim += t.dim()
            continue
        n = a.shape[dim]
        w, ok = _wrap(t.long().reshape(t.shape or (1,)), n)
        clamped.append(w.clamp(0, n - 1))
        sentinel.append((~ok).long())
        grid.append(2)
        at_zero.append(0)
        dim += 1
    y = take(a, clamped)
    if 0 not in at_zero:
        return y
    grid = torch.zeros(grid + [1] * (a.dim() - dim), dtype=torch.bool,
                       device=a.device)
    grid[tuple(at_zero)] = True
    return torch.where(take(grid, sentinel), y, y.detach())


def _fill_value(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min


@unit("autograd.gather")
def gather(a, axis: int, indices):
    """``jnp.take(a, indices, axis)``: negative indices count from the
    end; one outside [-n, n) reads the fill value (NaN for floats) and
    takes no gradient.  Not ``torch.gather``."""
    axis = axis % a.dim()
    n = a.shape[axis]
    i = _as_index(indices, a.device).long()
    w, ok = _wrap(i, n)
    y = torch.index_select(a, axis, w.clamp(0, n - 1).reshape(-1))
    shape = tuple(a.shape[:axis]) + tuple(i.shape) + tuple(a.shape[axis + 1:])
    y = y.reshape(shape)
    mask = ok.reshape((1,) * axis + tuple(i.shape)
                      + (1,) * (a.dim() - axis - 1))
    return torch.where(mask, y, torch.full((), _fill_value(a.dtype),
                                           dtype=a.dtype, device=a.device))


@unit("autograd.pad")
def pad(a, pad_width, value=0.0):
    """``jnp.pad`` in constant mode: `pad_width` an int, one (low, high)
    pair for every axis, or a pair per axis."""
    pw = np.broadcast_to(np.asarray(pad_width, np.int64), (a.dim(), 2))
    flat = [int(v) for lo, hi in reversed(pw.tolist()) for v in (lo, hi)]
    return F.pad(a, flat, value=value)


@unit("autograd.tile")
def tile(a, reps):
    reps = tuple(reps) if hasattr(reps, "__len__") else (reps,)
    return torch.tile(a, reps)


@unit("autograd.repeat")
def repeat(a, repeats, axis=None):
    """``jnp.repeat``: each element `repeats` times along `axis` (the
    flattened array when None)."""
    return torch.repeat_interleave(a, repeats, dim=axis)


@unit("autograd.expand")
def expand(a, shape):
    return torch.broadcast_to(a, tuple(shape))


@unit("autograd.onehot")
def onehot(ids, depth: int, axis: int = -1):
    """f32 one-hot rows of `ids` along a new axis `axis`; an id outside
    [0, depth) gives a row of zeros (``jax.nn.one_hot``; ``F.one_hot``
    would raise)."""
    ids = torch.as_tensor(ids)
    nd = ids.dim() + 1
    axis = axis % nd
    shape = [1] * nd
    shape[axis] = depth
    classes = torch.arange(depth, device=ids.device).reshape(shape)
    return (ids.unsqueeze(axis) == classes).to(torch.float32)


@unit("autograd.cumsum")
def cumsum(a, axis: int = 0):
    return torch.cumsum(a, dim=axis)


@unit("autograd.shape_of")
def shape_of(a):
    """The shape as an int32 vector."""
    return torch.tensor(list(a.shape), dtype=torch.int32, device=a.device)


# -- activations --------------------------------------------------------------

@unit("autograd.softplus")
def softplus(a):
    """log(1 + e^a) as ``jax.nn.softplus`` (logaddexp(a, 0)), with no
    linear threshold as ``F.softplus`` has."""
    return torch.logaddexp(a, torch.zeros((), dtype=a.dtype,
                                          device=a.device))


@unit("autograd.leakyrelu")
def leakyrelu(a, slope: float = 0.01):
    return torch.where(a > 0, a, slope * a)


@unit("autograd.elu")
def elu(a, alpha: float = 1.0):
    return F.elu(a, alpha)


@unit("autograd.prelu")
def prelu(a, slope):
    """Parametric ReLU: `slope` is a learned tensor (or a scalar)."""
    return torch.where(a > 0, a, _as_t(slope, a) * a)


@unit("autograd.selu")
def selu(a):
    return F.selu(a)


@unit("autograd.hardsigmoid")
def hardsigmoid(a, alpha: float = 0.2, beta: float = 0.5):
    return _jclip(alpha * a + beta, 0.0, 1.0)


@unit("autograd.hardswish")
def hardswish(a):
    return a * _jclip(a / 6.0 + 0.5, 0.0, 1.0)


@unit("autograd.mish")
def mish(a):
    return a * torch.tanh(softplus(a))


# -- where and reductions -----------------------------------------------------

@unit("autograd.where")
def where(cond, a, b):
    """a where `cond`, else b (a scalar b takes a's dtype); `cond` takes
    no gradient."""
    cond = torch.as_tensor(np.asarray(cond) if not isinstance(
        cond, torch.Tensor) else cond, device=a.device).bool()
    return torch.where(cond, a, _as_t(b, a))


def _reduce(fn, a, axis, keepdims):
    if axis is None:
        axis = tuple(range(a.dim()))
    return fn(a, dim=_axes(axis, a.dim()), keepdim=keepdims)


@unit("autograd.reduce_sum")
def reduce_sum(a, axis=None, keepdims: bool = False):
    return _reduce(torch.sum, a, axis, keepdims)


@unit("autograd.reduce_max")
def reduce_max(a, axis=None, keepdims: bool = False):
    """Max over `axis`; tied maxima share the gradient evenly (jax's
    VJP; ``amax``, not ``max(dim)``)."""
    return _reduce(torch.amax, a, axis, keepdims)


@unit("autograd.reduce_min")
def reduce_min(a, axis=None, keepdims: bool = False):
    return _reduce(torch.amin, a, axis, keepdims)


@unit("autograd.reduce_prod")
def reduce_prod(a, axis=None, keepdims: bool = False):
    if axis is None:
        axis = tuple(range(a.dim()))
    for ax in sorted(_axes(axis, a.dim()), reverse=True):
        a = torch.prod(a, dim=ax, keepdim=keepdims)
    return a


# -- losses -------------------------------------------------------------------

@unit("autograd.binary_cross_entropy")
def binary_cross_entropy(p, t):
    """-mean(t·log p + (1 − t)·log(1 − p)) with p clipped to
    [1e-7, 1 − 1e-7] first (not ``F.binary_cross_entropy``'s clamp of
    the log)."""
    t = _as_t(t, p)
    eps = 1e-7
    p = _jclip(p, eps, 1 - eps)
    return -torch.mean(t * torch.log(p) + (1 - t) * torch.log(1 - p))


@unit("autograd.nll_loss")
def nll_loss(logp, target):
    """-sum(onehot(target) · logp) / target.numel(): integer targets
    over the last axis of log-probabilities; an id out of range adds
    nothing and still counts."""
    target = torch.as_tensor(np.asarray(target) if not isinstance(
        target, torch.Tensor) else target, device=logp.device)
    hot = onehot(target, logp.shape[-1]).to(logp.dtype)
    return -(hot * logp).sum() / float(target.numel())


@unit("autograd.cossim")
def cossim(a, b):
    """Cosine similarity over the last axis, num / (‖a‖·‖b‖ + 1e-8) (not
    ``F.cosine_similarity``'s clamped denominator)."""
    num = (a * b).sum(dim=-1)
    den = torch.sqrt((a * a).sum(dim=-1)) * torch.sqrt((b * b).sum(dim=-1))
    return num / (den + 1e-8)


# -- trigonometric, hyperbolic, rounding --------------------------------------

@unit("autograd.sin")
def sin(a):
    return torch.sin(a)


@unit("autograd.cos")
def cos(a):
    return torch.cos(a)


@unit("autograd.tan")
def tan(a):
    return torch.tan(a)


@unit("autograd.asin")
def asin(a):
    return torch.asin(a)


@unit("autograd.acos")
def acos(a):
    return torch.acos(a)


@unit("autograd.atan")
def atan(a):
    return torch.atan(a)


@unit("autograd.sinh")
def sinh(a):
    return torch.sinh(a)


@unit("autograd.cosh")
def cosh(a):
    return torch.cosh(a)


@unit("autograd.asinh")
def asinh(a):
    return torch.asinh(a)


@unit("autograd.acosh")
def acosh(a):
    return torch.acosh(a)


@unit("autograd.atanh")
def atanh(a):
    return torch.atanh(a)


@unit("autograd.ceil")
def ceil(a):
    return torch.ceil(a)


@unit("autograd.floor")
def floor(a):
    return torch.floor(a)


@unit("autograd.round")
def round(a):                   # noqa: A001 - reference op name
    """Round half to even; the gradient is 0."""
    return torch.round(a)


@unit("autograd.sign")
def sign(a):
    return torch.sign(a)


@unit("autograd.reciprocal")
def reciprocal(a):
    return 1.0 / a


# -- comparison and logic -----------------------------------------------------

@unit("autograd.minimum")
def minimum(a, b):
    """Elementwise min; a tie sends half the gradient to each side."""
    return torch.minimum(a, _as_t(b, a))


@unit("autograd.maximum")
def maximum(a, b):
    """Elementwise max; a tie sends half the gradient to each side."""
    return torch.maximum(a, _as_t(b, a))


@unit("autograd.mod")
def mod(a, b):
    """Floor-mod (``jnp.mod``, the sign of b: ``remainder``, not
    ``fmod``); no gradient, as the reference's."""
    return torch.remainder(a, _as_t(b, a)).detach()

@unit("autograd.equal")
def equal(a, b):
    return torch.eq(a, _as_t(b, a)).detach()


@unit("autograd.greater")
def greater(a, b):
    return torch.gt(a, _as_t(b, a)).detach()


@unit("autograd.greater_equal")
def greater_equal(a, b):
    return torch.ge(a, _as_t(b, a)).detach()


@unit("autograd.less")
def less(a, b):
    return torch.lt(a, _as_t(b, a)).detach()


@unit("autograd.less_equal")
def less_equal(a, b):
    return torch.le(a, _as_t(b, a)).detach()


@unit("autograd.logical_and")
def logical_and(a, b):
    return torch.logical_and(a, _as_t(b, a)).detach()


@unit("autograd.logical_or")
def logical_or(a, b):
    return torch.logical_or(a, _as_t(b, a)).detach()


@unit("autograd.logical_xor")
def logical_xor(a, b):
    return torch.logical_xor(a, _as_t(b, a)).detach()


@unit("autograd.logical_not")
def logical_not(a):
    return torch.logical_not(a).detach()


def grad_of(t: torch.Tensor) -> Optional[torch.Tensor]:
    """The gradient `backward` stored on `t` (None before one)."""
    return t.grad


__all__ += [
    "add", "sub", "mul", "div", "neg", "pow", "abs", "exp", "log", "sqrt",
    "rsqrt", "clip", "erf", "matmul", "einsum", "tensordot", "add_bias",
    "reshape", "transpose", "squeeze", "unsqueeze", "cat", "stack",
    "split", "index", "gather", "pad", "tile", "repeat", "expand",
    "onehot", "cumsum", "shape_of", "softplus", "leakyrelu", "elu",
    "prelu", "selu", "hardsigmoid", "hardswish", "mish", "where",
    "reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
    "binary_cross_entropy", "nll_loss", "cossim", "sin", "cos", "tan",
    "asin", "acos", "atan", "sinh", "cosh", "asinh", "acosh", "atanh",
    "ceil", "floor", "round", "sign", "reciprocal", "minimum", "maximum",
    "mod", "equal", "greater", "greater_equal", "less", "less_equal",
    "logical_and", "logical_or", "logical_xor", "logical_not", "grad_of",
]
