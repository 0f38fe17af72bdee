"""Layers, ported from ``singa_tpu/layer.py``: ``Layer``, ``Linear``,
``Embedding``, ``RMSNorm``, ``MoE``, the transformer layers
``LayerNorm``, ``Gelu``, ``Softmax`` and ``MultiHeadAttention``, the
recurrent layers ``RNN`` and ``LSTM``, activation checkpointing
(``Remat``), the vision layers ``Conv2d``, ``SeparableConv2d``,
``BatchNorm2d``, ``MaxPool2d``, ``AvgPool2d``, ``GlobalAvgPool2d``,
``Flatten``, ``ReLU``, ``Tanh``, ``Sigmoid``, ``SiLU``, ``LeakyReLU``,
``Dropout``, ``Sequential`` and the loss layers ``CrossEntropyLoss``,
``MSELoss``, and ``PipelineStack`` (a block stack over the ``pipe``
mesh axis).

Tensor parallelism: a parameter that ``parallel.tensor_parallel.
shard_params`` cut to its rank's block carries its spec (``tp_spec``),
and ``Linear`` and ``Embedding`` run their Megatron forms from it:
column-parallel (W ``(None, 'model')``, b ``('model',)``), row-parallel
(W ``('model', None)``, the bias added once after the reduce) and an
embedding table ``(None, 'model')`` looked up, then gathered on the
hidden dim.

Layers are ``nn.Module``s whose parameters are created at construction
(the reference initializes lazily from the first input; here the caller
gives the input width).  Parameters are f32 masters named as in the
reference (``W``, ``table``, ``gamma``), so ``get_params()`` keys are
the reference's attribute paths one to one: a list of layers is an
``nn.ModuleList`` under the reference's attribute (``layers.<i>``,
``hidden.<i>``).  Random init draws from an explicit
``torch.Generator`` on the layer's device.  Each layer takes the
reference's `name` (automatic names count per class, ``linear``,
``linear_1``, ...) before its `device`, and the state methods its
`prefix`.

Vision layers keep the reference's layouts: NHWC activations
(``data_format="NCHW"`` takes and gives NCHW) and HWIO conv kernels.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import autograd
from .device import Device, get_default_device
from .parallel import tensor_parallel as tp
from .ops import kv_cache as kv_ops
from .ops import rnn as rnn_ops
from .ops.attention import attention
from .ops.moe import moe_forward
from .ops.ring_attention import ring_attention, seq_parallel

__all__ = ["Layer", "Linear", "Embedding", "RMSNorm", "LayerNorm", "Gelu",
           "Softmax", "MultiHeadAttention", "MoE", "RNN", "LSTM", "Remat",
           "Conv2d", "SeparableConv2d", "BatchNorm2d", "MaxPool2d",
           "AvgPool2d", "GlobalAvgPool2d", "Flatten", "ReLU", "Tanh",
           "Sigmoid", "SiLU", "LeakyReLU", "Dropout", "Sequential",
           "CrossEntropyLoss", "MSELoss", "PipelineStack"]


_name_counter: Dict[str, int] = {}


def _auto_name(prefix: str) -> str:
    n = _name_counter.get(prefix, 0)
    _name_counter[prefix] = n + 1
    return f"{prefix}_{n}" if n else prefix


def _layer_name(layer: nn.Module, name: Optional[str]) -> str:
    """`name`, or the reference's automatic one: the class name in lower
    case, then ``_1``, ``_2`` ... for later layers of the class.  Any
    other type raises, so a device passed where `name` stands fails at
    construction."""
    if name is not None and not isinstance(name, str):
        raise TypeError(f"{type(layer).__name__}: name must be a str or "
                        f"None, got {type(name).__name__} (pass the device "
                        f"as device=)")
    return name or _auto_name(type(layer).__name__.lower())


class Layer(nn.Module):
    """Base layer: an ``nn.Module`` bound to a port ``Device``, named as
    in the reference (`name`, or an automatic one).

    The state methods take the reference's `prefix`: keys are ``prefix
    + path``, where the path is the attribute path
    (``blocks.0.attn.q_proj.W``)."""

    def __init__(self, name: Optional[str] = None,
                 device: Optional[Device] = None):
        super().__init__()
        self.name = _layer_name(self, name)
        self.device = device or get_default_device()

    def _named_params(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        """Parameters keyed by ``prefix + path``.  A recorded
        ``param_name`` is left as it is; a parameter without one gets
        its path, as every reference tensor is named from its creation.
        Blocks of a ``PipelineStack`` that another pipe rank holds are
        left out."""
        out = {}
        for n, p in self.named_parameters():
            if getattr(p, "pipe_held", True):
                if not getattr(p, "param_name", None):
                    p.param_name = n
                out[prefix + n] = p
        return out

    def get_params(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        """Parameters keyed by ``prefix + path``; each parameter records
        its key as ``param_name`` (the optimizer's slot key), as the
        reference names its tensors here.  A traversal that only needs
        the tensors does not pass a prefix."""
        params = self._named_params(prefix)
        for name, p in params.items():
            p.param_name = name
        return params

    def _get_buffers(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        """Persistent buffers (non-trainable states) keyed by ``prefix +
        path``.  Non-persistent buffers, such as the RoPE tables a model
        rebuilds from its config, are not states."""
        params = dict(self.named_parameters())
        return {prefix + n: t
                for n, t in self.state_dict(keep_vars=True).items()
                if n not in params}

    def get_states(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        """Everything a checkpoint holds: parameters and persistent
        buffers, keyed by ``prefix + path``."""
        out = dict(self.get_params(prefix))
        out.update(self._get_buffers(prefix))
        return out

    def set_params(self, params: Dict, prefix: str = "") -> None:
        """Copy each given array (numpy or tensor) into the parameter
        keyed ``prefix + path``, in its existing storage: a captured step
        reads parameters by address, so a load never rebinds them.  Keys
        this layer does not have are ignored, as in the reference; a
        shape that differs raises before anything is copied."""
        _copy_into(self._named_params(prefix), params)

    def set_states(self, states: Dict, prefix: str = "") -> None:
        """`set_params` over parameters and persistent buffers."""
        _copy_into({**self._named_params(prefix),
                    **self._get_buffers(prefix)}, states)

    def _new_param(self, shape) -> nn.Parameter:
        return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                        device=self.device.torch_device))

    @property
    def remat_safe(self) -> bool:
        """Whether `Remat` can recompute this layer in the backward: no
        layer with a side channel inside it and no buffers."""
        return _remat_blocker(self) is None


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict) -> None:
    """Copy src's arrays into dst's tensors of the same names; an array
    at the full shape of a parameter cut over the mesh (tensor
    parallelism) gives it this rank's block."""
    names = [n for n in dst if n in src]
    src = {n: tp.to_local(dst[n], src[n]) for n in names}
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


def _xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                     generator: torch.Generator) -> None:
    a = math.sqrt(6.0 / max(1, fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-a, a, generator=generator)


class Linear(Layer):
    """y = x @ W (+ b) with W of shape (in, out), Xavier-uniform init."""

    def __init__(self, out_features: int, in_features: int, bias: bool = True,
                 name: Optional[str] = None, device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name, device)
        self.out_features, self.in_features = out_features, in_features
        self.W = self._new_param((in_features, out_features))
        _xavier_uniform_(self.W, in_features, out_features,
                         _generator(self.device, generator))
        self.b = None
        if bias:
            self.b = self._new_param((out_features,))
            with torch.no_grad():
                self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _maybe_cast(self.W, x)
        b = None if self.b is None else _maybe_cast(self.b, x)
        cut = tp.sharded_dim(self.W)
        if cut == 1:                       # column-parallel
            return autograd.linear(tp.copy_to_region(x), w, b)
        if cut == 0:                       # row-parallel
            y = tp.reduce_from_region(autograd.linear(x, w))
            return y if b is None else y + b
        return autograd.linear(x, w, b)


def head_units(layer: Layer, columns, rows, head_dim: int) -> None:
    """Declare that the named Linear sublayers shard by whole heads of
    `head_dim`: W's columns for `columns` (q, k, v projections), W's rows
    for `rows` (the output projection); see ``tensor_parallel``."""
    for name in columns:
        getattr(layer, name).shard_units = {"W": (1, head_dim),
                                            "b": (head_dim,)}
    for name in rows:
        getattr(layer, name).shard_units = {"W": (head_dim, 1)}


def _maybe_cast(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cast an f32 master param to the compute dtype of x (bf16 on the card)."""
    if p.dtype == x.dtype:
        return p
    return autograd.cast(p, x.dtype)


class Embedding(Layer):
    def __init__(self, vocab_size: int, embed_dim: int,
                 name: Optional[str] = None, device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name, device)
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
        if tp.sharded_dim(self.table) == 1:     # hidden-dim shards
            out = tp.gather_from_region(out)
        return out


class RMSNorm(Layer):
    def __init__(self, dim: int, eps: float = 1e-6,
                 name: Optional[str] = None, device: Optional[Device] = None):
        super().__init__(name, device)
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
                 name: Optional[str] = None, device: Optional[Device] = None):
        super().__init__(name, device)
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
                 name: Optional[str] = None, device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name, device)
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
        head_units(self, ("q_proj", "k_proj", "v_proj"), ("out_proj",),
                   d // num_heads)

    def forward(self, x: torch.Tensor, mask=None, cache=None, pos=0):
        B, T, D = x.shape
        hd = D // self.num_heads
        # this rank's heads (all of them without a model axis)
        q = self.q_proj(x).reshape(B, T, -1, hd)
        k = self.k_proj(x).reshape(B, T, -1, hd)
        v = self.v_proj(x).reshape(B, T, -1, hd)
        if cache is None:
            if seq_parallel()[0] > 1:
                if mask is not None:
                    raise NotImplementedError(
                        "an attention mask under a 'seq' mesh axis: ring "
                        "attention takes the causal mask only")
                o = ring_attention(q, k, v, causal=self.causal)
            else:
                o = attention(q, k, v, causal=self.causal, mask=mask)
            return self.out_proj(o.reshape(B, T, -1))
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
    sum and resets: add it to the training loss once per step.

    Under an ``expert`` mesh axis the executor cuts the expert weights
    by `SHARD_RULES` (E/ep experts a rank) and ``dispatch_mode='auto'``
    is the einsum dispatch; the router and the aux loss stay whole on
    every rank (``ops.moe.moe_partial``)."""

    # expert parallelism over an 'expert' axis, as the reference declares
    # it (spmd.collect_shard_rules merges it): each expert rank holds E/ep
    # experts and ops.moe sums their partial outputs over the axis
    SHARD_RULES = [
        (r"\.(w_in|w_out|w_gate)$", ("expert", None, None)),
    ]
    # the aux-loss list is a side channel: a forward recomputed in the
    # backward (activation checkpointing) would append again, so
    # checkpointing skips any block that holds this layer
    REMAT_SAFE = False

    def __init__(self, num_experts: int, ffn_dim: int,
                 capacity_factor: float = 1.25, top_k: int = 1,
                 act: str = "relu", dispatch_mode: str = "auto", *,
                 dim: int, name: Optional[str] = None,
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name, device)
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
# recurrent layers: the reference's lax.scan is ops.rnn's loop
# ---------------------------------------------------------------------------

class _Recurrent(Layer):
    """A cell over inputs (B, T, `input_size`) with ``Wx`` (D, G·H),
    ``Wh`` (H, G·H) and ``b`` (G·H,), as the reference's: Xavier-uniform
    weights, zero bias, a zero first state; returns the hidden states
    (B, T, H)."""

    KIND, GATES = "", 1

    def __init__(self, hidden_size: int, input_size: int,
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None, *,
                 name: Optional[str] = None):
        super().__init__(name, device)
        self.hidden_size, self.input_size = hidden_size, input_size
        d, gh = input_size, self.GATES * hidden_size
        gen = _generator(self.device, generator)
        self.Wx = self._new_param((d, gh))
        self.Wh = self._new_param((hidden_size, gh))
        self.b = self._new_param((gh,))
        _xavier_uniform_(self.Wx, d, gh, gen)
        _xavier_uniform_(self.Wh, hidden_size, gh, gen)
        with torch.no_grad():
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rnn_ops.scan(x, _maybe_cast(self.Wx, x),
                            _maybe_cast(self.Wh, x), _maybe_cast(self.b, x),
                            self.KIND)


class RNN(_Recurrent):
    """Vanilla tanh RNN: h = tanh(x_t Wx + h Wh + b)."""

    KIND, GATES = "RNN", 1


class LSTM(_Recurrent):
    """LSTM with gate blocks i, f, g, o (the reference's order) in
    ``Wx``, ``Wh`` and ``b``."""

    KIND, GATES = "LSTM", 4


# ---------------------------------------------------------------------------
# activation checkpointing
# ---------------------------------------------------------------------------

def _remat_blocker(layer: nn.Module) -> Optional[str]:
    """Why `layer`'s forward cannot be replayed in the backward (None
    when it can): a layer with a side channel (``REMAT_SAFE = False``,
    such as MoE's aux losses) or buffers (BatchNorm's running
    statistics), which a second forward would write again."""
    unsafe = [type(m).__name__ for m in layer.modules()
              if not getattr(type(m), "REMAT_SAFE", True)]
    if unsafe:
        return f"side-channel layers ({', '.join(unsafe)})"
    if isinstance(layer, Layer) and layer._get_buffers():
        return "non-trainable buffers"
    return None


class Remat(Layer):
    """Activation checkpointing: `Remat(block)` runs the block under
    ``torch.utils.checkpoint`` (non-reentrant) in training, so the
    backward recomputes its internals from the block's input instead of
    keeping them: one more forward for O(block) less activation memory.

    The wrapper is transparent: it shares the block's tables of
    parameters, buffers and sublayers, so ``get_params()``,
    ``get_states()``, ``state_dict()`` and `set_params` name everything
    as the bare block does (a checkpoint loads either way), and its
    sublayers are its attributes (``Remat(blk).attn``).

    In eval, or with gradients off, the block runs as it is.  A block
    that cannot be replayed (`_remat_blocker`) runs plain with the
    reference's warning, as does a call whose extra arguments are not
    None or tensors without gradients (a KV cache, an int position).
    The recompute draws the forward's dropout masks again
    (`_RngReplay`): loss, gradients and each generator's state equal
    those of the bare block bit for bit."""

    def __init__(self, inner: nn.Module, name: Optional[str] = None):
        nn.Module.__init__(self)
        self.name = _layer_name(self, name)
        d = self.__dict__
        d["inner"] = inner                 # not a child: no path segment
        d["_parameters"] = inner._parameters
        d["_buffers"] = inner._buffers
        d["_non_persistent_buffers_set"] = inner._non_persistent_buffers_set
        d["_modules"] = inner._modules
        self.device = getattr(inner, "device", None)

    @property
    def remat_safe(self) -> bool:
        return _remat_blocker(self.inner) is None

    def forward(self, x: torch.Tensor, *rest):
        inner = self.inner
        if not (autograd.is_training() and torch.is_grad_enabled()):
            return inner(x, *rest)          # nothing to save
        name = getattr(inner, "name", type(inner).__name__)
        why = _remat_blocker(inner)
        if why:
            warnings.warn(
                f"Remat({name}) skipped: wrapped layer has {why} (the "
                f"forward replayed in backward must be side-effect free)",
                stacklevel=2)
            return inner(x, *rest)
        for r in rest:
            if not (r is None or (isinstance(r, torch.Tensor)
                                  and not r.requires_grad)):
                warnings.warn(
                    f"Remat({name}) bypassed for a call with unsupported "
                    f"extra arg {type(r).__name__}", stacklevel=2)
                return inner(x, *rest)
        rng = _RngReplay(inner, x)
        return checkpoint(inner, x, *rest, use_reentrant=False,
                          preserve_rng_state=False, context_fn=rng.contexts)


class _RngReplay:
    """The random state of one call that `Remat` checkpoints: the state
    of every generator the block may draw from (each layer's
    ``generator``, such as Dropout's, and the default generator of x's
    device), taken as the forward starts.  The recompute sets them back
    to it, runs with the forward's train flag, then restores the states
    it found, so it draws the forward's masks again and each generator
    ends the step where it would without remat.
    ``torch.utils.checkpoint``'s ``preserve_rng_state`` keeps the
    default generators only.  ``get_state`` / ``set_state`` are also
    right inside a CUDA-graph capture: there they read and move the
    captured offset (a card test,
    ``test_generator_state_rewinds_inside_a_capture``).  Both contexts
    may be entered again (a second backward) and nest."""

    def __init__(self, inner: nn.Module, x: torch.Tensor):
        gens = {id(m.generator): m.generator for m in inner.modules()
                if isinstance(getattr(m, "generator", None), torch.Generator)}
        default = (torch.cuda.default_generators[x.device.index]
                   if x.is_cuda else torch.default_generator)
        gens.setdefault(id(default), default)
        self.gens = list(gens.values())
        self.training = autograd.is_training()
        self.states: List[torch.Tensor] = []
        self._stack: List = []

    def contexts(self):
        return _RngContext(self, replay=False), _RngContext(self, replay=True)


class _RngContext:
    def __init__(self, rng: _RngReplay, replay: bool):
        self.rng, self.replay = rng, replay

    def __enter__(self):
        r = self.rng
        if not self.replay:
            r.states = [g.get_state() for g in r.gens]
            return
        r._stack.append(([g.get_state() for g in r.gens],
                         autograd.is_training()))
        for g, st in zip(r.gens, r.states):
            g.set_state(st)
        autograd.set_training(r.training)

    def __exit__(self, *exc):
        if self.replay:
            states, flag = self.rng._stack.pop()
            for g, st in zip(self.rng.gens, states):
                g.set_state(st)
            autograd.set_training(flag)


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
                 name: Optional[str] = None, device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name, device)
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


class SeparableConv2d(Layer):
    """A depthwise conv (`kernel_size`, one filter a channel: groups =
    in_channels) then a pointwise 1×1 conv to `out_channels`, each a
    `Conv2d` with ``bias`` (default none), at ``depthwise.W`` and
    ``pointwise.W``.  Without `in_channels` both are built at the first
    call from its channels, as the reference's ``initialize``."""

    def __init__(self, out_channels: int, kernel_size,
                 in_channels: Optional[int] = None, stride=1, padding=0,
                 bias: bool = False, data_format: str = "NHWC",
                 name: Optional[str] = None, device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name, device)
        self.out_channels, self.kernel_size = out_channels, kernel_size
        self.stride, self.padding, self.bias = stride, padding, bias
        self.data_format = data_format
        self.generator = generator
        self.depthwise = self.pointwise = None
        if in_channels is not None:
            self._build(in_channels)

    def _build(self, c: int) -> None:
        kw = dict(bias=self.bias, data_format=self.data_format,
                  device=self.device, generator=self.generator)
        self.depthwise = Conv2d(c, self.kernel_size, c, stride=self.stride,
                                padding=self.padding, groups=c, **kw)
        self.pointwise = Conv2d(self.out_channels, 1, c, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.depthwise is None:
            self._build(x.shape[1 if self.data_format == "NCHW" else -1])
        return self.pointwise(self.depthwise(x))


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
                 name: Optional[str] = None, device: Optional[Device] = None):
        super().__init__(name, device)
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

    def __init__(self, name: Optional[str] = None):
        nn.Module.__init__(self)
        self.name = _layer_name(self, name)
        self.device = None


class _Pool2d(_Deviceless):
    def __init__(self, kernel_size, stride=None, padding: int = 0,
                 data_format: str = "NHWC", name: Optional[str] = None):
        super().__init__(name)
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
    def __init__(self, data_format: str = "NHWC",
                 name: Optional[str] = None):
        super().__init__(name)
        self.data_format = data_format

    def forward(self, x):
        axes = (1, 2) if self.data_format == "NHWC" else (2, 3)
        return autograd.reduce_mean(x, axes)


class Flatten(_Deviceless):
    def __init__(self, start_axis: int = 1, name: Optional[str] = None):
        super().__init__(name)
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

    def __init__(self, approximate: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.approximate = approximate

    def forward(self, x):
        return autograd.gelu(x, self.approximate)


class Softmax(_Deviceless):
    def __init__(self, axis: int = -1, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return autograd.softmax(x, self.axis)


class Sigmoid(_Deviceless):
    def forward(self, x):
        return autograd.sigmoid(x)


class SiLU(_Deviceless):
    def forward(self, x):
        return autograd.silu(x)


class LeakyReLU(_Deviceless):
    def __init__(self, slope: float = 0.01, name: Optional[str] = None):
        super().__init__(name)
        self.slope = slope

    def forward(self, x):
        return autograd.leakyrelu(x, self.slope)


class Dropout(Layer):
    """Dropout whose masks come from `generator` (default: the device's);
    a captured train step registers it, so each replay draws anew."""

    def __init__(self, p: float = 0.5, name: Optional[str] = None,
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name, device)
        self.p = p
        self.generator = _generator(self.device, generator)

    def forward(self, x):
        return autograd.dropout(x, self.p, self.generator)


class PipelineStack(Layer):
    """A stack of identical shape-preserving blocks (transformer blocks)
    over the ``pipe`` mesh axis: the Model-API surface of
    ``parallel.pipeline``.

    Parameter paths are those of a plain block list (``blocks.0. ...``),
    so checkpoints move between pipelined and sequential models.  With
    `remat` every block is a ``Remat`` of itself, on both paths.

    Under a bound ``pipe`` axis equal to `stages` (> 1), compiling the
    model (``parallel.pipeline.shard_stages``) leaves each pipe rank its
    own stage's blocks and frees the others: ``get_params()`` returns the
    live blocks, a checkpoint gathers every block, a load takes a
    sequential checkpoint.  A training call with gradients then runs the
    GPipe schedule over `n_micro` microbatches of the batch, extras such
    as padding masks cut next to x; any other call on a cut stack (eval,
    or a reason of `_pipe_blocker`, with its warning) runs the stages in
    turn on the whole batch, one microbatch, its extras whole.  A cut
    stack refuses gradient-carrying extras: it cannot fall back to a
    sequential run, its other stages' blocks being on other ranks.
    Uncut, the stack runs its blocks in order.  Under a ``model`` axis
    each stage's blocks keep their Megatron forms.

    Constraints, as the reference's: len(blocks) % stages == 0; a stack
    whose blocks hold buffers, ``Dropout(p>0)`` or a side channel
    (``REMAT_SAFE = False``, MoE) is not cut and runs sequentially, with
    the reference's warning."""

    def __init__(self, blocks, stages: int, n_micro: Optional[int] = None,
                 remat: bool = False, name: Optional[str] = None):
        blocks = list(blocks)
        super().__init__(name, getattr(blocks[0], "device", None) if blocks
                         else None)
        if stages < 1 or len(blocks) % stages:
            raise ValueError(
                f"{len(blocks)} blocks do not divide into {stages} stages")
        self.stages = stages
        self.n_micro = n_micro or stages
        self.remat = remat
        for i, b in enumerate(blocks):
            self.add_module(str(i), Remat(b) if remat else b)
        #: (mesh, this rank's stage) once `shard_stages` cut the stack
        self.cut = None

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def _pipe_live(self) -> bool:
        """A bound pipe axis of `stages` (> 1); a mismatched one is warned
        of where the model is compiled (``pipeline.shard_stages``)."""
        from .parallel import communicator as comm
        from .parallel import mesh as mesh_mod
        m = mesh_mod.current_mesh()
        pipe = m.shape.get("pipe", 0) if m is not None else 0
        return pipe == self.stages > 1 and comm.axis_bound("pipe")

    def forward(self, x: torch.Tensor, *rest) -> torch.Tensor:
        rest = tuple(r for r in rest if r is not None)
        if self.cut is None:
            if autograd.is_training() and self._pipe_live():
                why = self._structural_blocker() or (
                    "it was not cut into stages (compile the model under "
                    "the pipe mesh)")
                warnings.warn(f"PipelineStack({self.name}) running "
                              f"sequentially: {why}", stacklevel=2)
            h = x
            for blk in self:
                h = blk(h, *rest)
            return h
        from .parallel import pipeline
        mesh, stage = self.cut
        if torch.is_grad_enabled() and any(
                isinstance(r, torch.Tensor) and r.requires_grad for r in rest):
            # the schedule takes no gradient for an extra, and the other
            # stages' blocks are on other ranks: no sequential run either
            raise ValueError(
                "PipelineStack: gradient-carrying extra args are "
                "unsupported on a stack cut into stages (detach them, or "
                "build the model without pipeline_stages)")
        M = 1
        if autograd.is_training() and torch.is_grad_enabled():
            why = self._pipe_blocker(x, rest)
            if why:
                warnings.warn(f"PipelineStack({self.name}) running its "
                              f"stages on the whole batch as one "
                              f"microbatch: {why}",
                              stacklevel=2)
            else:
                M = self.n_micro
        k = len(self) // self.stages
        own = list(self)[stage * k:(stage + 1) * k]
        params = [p for b in own for p in b.parameters()]

        def stage_fn(ps, h, *ex):
            for blk in own:
                h = blk(h, *ex)
            return h
        B = x.shape[0]
        split = (lambda t: t.unsqueeze(0) if M == 1 else
                 t.reshape((M, B // M) + tuple(t.shape[1:])))
        out = pipeline.run_schedule(stage_fn, params, split(x),
                                    tuple(split(r) for r in rest), M,
                                    pipeline.Hop())
        return out.reshape(x.shape)

    def _structural_blocker(self) -> Optional[str]:
        """A reason the schedule cannot replay these blocks, known from
        the blocks alone (None: it can)."""
        for blk in self:
            if isinstance(blk, Layer) and blk._get_buffers():
                return ("blocks hold non-trainable buffers (the pipelined "
                        "forward must be replayable)")
            for l in blk.modules():
                if isinstance(l, Dropout) and l.p > 0:
                    return ("Dropout(p>0) inside blocks would draw "
                            "different keys than sequential execution")
                if not getattr(type(l), "REMAT_SAFE", True):
                    return (f"{type(l).__name__} layers carry a "
                            "side-channel (e.g. MoE aux losses) the "
                            "schedule's pure replay would drop")
        return None

    def _pipe_blocker(self, x, rest) -> Optional[str]:
        """The reason this call on a cut stack cannot be cut into
        `n_micro` microbatches (None: it can)."""
        B = x.shape[0]
        if B % self.n_micro:
            return f"batch {B} not divisible by n_micro={self.n_micro}"
        for r in rest:
            shape = getattr(r, "shape", None)
            if not shape or shape[0] != B:
                return (f"extra arg must be batch-leading (got shape "
                        f"{shape}, batch {B})")
        return None


class Sequential(_Deviceless):
    """Layers applied in order, named ``layers.<i>`` as in the reference."""

    def __init__(self, *layers: nn.Module, name: Optional[str] = None):
        super().__init__(name)
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
