"""The plain reference: Mistral's and Mixtral's decoder in plain PyTorch,
float32, with no kernel, cache or batching of the program's.

It follows the published architecture (Mistral-7B-v0.1 and
Mixtral-8x7B-v0.1): pre-RMSNorm blocks, rotate-half RoPE, grouped-query
attention over a sliding window, a SwiGLU FFN or a top-k mixture of
SwiGLU experts with gates renormalised over the chosen experts, an
untied head.  Departures, each the program's too: weights are in the
program's (in, out) layout, and an MoE layer adds the Switch balance
loss (E · Σ_e f_e · P_e over the first choices) at ``moe_aux_weight``.

Training follows Adafactor with the relative step (Shazeer & Stern
2018), layer by layer: the forward keeps each layer's input, the
backward recomputes one layer at a time and updates its parameters as
soon as their gradients are whole, so that a 7B model fits beside its
f32 masters.

``fp8=True`` computes every projection (the router's too) and the head
in float8: both
operands in e4m3 and the backward's incoming gradient in e5m2, each at a
per-tensor scale, the products accumulated in f32.  That is the control,
the precision below the program's bf16.  ``bf16=True`` computes them
with both operands in bfloat16 and f32 results: the program's own
precision, a witness of what bf16 alone moves.

Imports torch alone: nothing of the program, of JAX or of its package.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def set_exact() -> None:
    """f32 products in f32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to the 8-bit float `dtype` at a per-tensor scale, back
    in x's dtype."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _FP8MatMul(torch.autograd.Function):
    """a @ b with both operands in e4m3 and, in the backward, the
    incoming gradient in e5m2 (the usual float8 training recipe); the
    products accumulate in f32."""

    @staticmethod
    def forward(ctx, a, b):
        qa = _round8(a, torch.float8_e4m3fn, E4M3_MAX)
        qb = _round8(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round8(g, torch.float8_e5m2, E5M2_MAX)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.reshape(-1, qa.shape[-1]).transpose(0, 1) \
            @ qg.reshape(-1, qg.shape[-1])
        return ga, gb


class Reference:
    """The decoder of `cfg` (the configuration file's keys) over `params`
    (the program's leaf names → f32 tensors, used in place)."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 fp8: bool = False, moe_aux_weight: float = 0.0,
                 attn_chunk: int = 512, bf16: bool = False):
        self.cfg, self.p, self.fp8, self.bf16 = cfg, params, fp8, bf16
        self.routes = None      # a list: each MoE layer's chosen experts
        self.D = cfg["hidden_size"]
        self.L = cfg["num_hidden_layers"]
        self.H = cfg["num_attention_heads"]
        self.K = cfg["num_key_value_heads"]
        self.hd = self.D // self.H
        self.W = cfg.get("sliding_window") or 0
        self.E = cfg.get("num_local_experts", 0)
        self.k = cfg.get("num_experts_per_tok", 0)
        self.eps = cfg["rms_norm_eps"]
        self.aux_w = moe_aux_weight
        self.chunk = attn_chunk
        dev = params["lm_head.W"].device
        inv = 1.0 / (cfg["rope_theta"] ** (
            torch.arange(0, self.hd, 2, dtype=torch.float64) / self.hd))
        self._inv = inv.to(dev)

    # -- pieces ------------------------------------------------------------
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return _FP8MatMul.apply(a, b)
        if self.bf16:
            return (a.bfloat16() @ b.bfloat16()).float()
        return a @ b

    def rms(self, x, gamma):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * gamma

    def rope(self, x, start: int = 0):
        T = x.shape[1]
        t = torch.arange(start, start + T, dtype=torch.float64,
                         device=x.device)
        f = torch.outer(t, self._inv)
        c = torch.cos(f).float()[None, :, None, :]
        s = torch.sin(f).float()[None, :, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)

    def attend(self, q, k, v):
        """Causal attention over the window, in query chunks: q (B, T, H,
        hd), k and v (B, T, K, hd) → (B, T, H, hd)."""
        B, T = q.shape[:2]
        G = self.H // self.K
        k = k.repeat_interleave(G, dim=2).transpose(1, 2)   # (B, H, T, hd)
        v = v.repeat_interleave(G, dim=2).transpose(1, 2)
        q = q.transpose(1, 2)
        scale = 1.0 / math.sqrt(self.hd)
        outs = []
        for s in range(0, T, self.chunk):
            e = min(T, s + self.chunk)
            lo = max(0, s - self.W + 1) if self.W else 0
            sc = (q[:, :, s:e] @ k[:, :, lo:e].transpose(-1, -2)) * scale
            qi = torch.arange(s, e, device=q.device)[:, None]
            ki = torch.arange(lo, e, device=q.device)[None, :]
            ok = ki <= qi
            if self.W:
                ok = ok & (ki > qi - self.W)
            sc = sc.masked_fill(~ok, float("-inf"))
            outs.append(torch.softmax(sc, dim=-1) @ v[:, :, lo:e])
        return torch.cat(outs, dim=2).transpose(1, 2)

    def moe(self, i: int, x):
        """(output, balance loss) of layer i's experts over x (B, T, D)."""
        p = f"blocks.{i}.ffn."
        xf = x.reshape(-1, self.D)
        logits = self.mm(xf, self.p[p + "router"])
        probs = torch.softmax(logits, dim=-1)
        top_v, top_i = torch.topk(probs, self.k, dim=-1)
        if self.routes is not None:
            self.routes.append(top_i)
        gates = top_v / top_v.sum(-1, keepdim=True)
        out = torch.zeros_like(xf)
        for e in range(self.E):
            rows, slot = torch.nonzero(top_i == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = xf[rows]
            h = F.silu(self.mm(xe, self.p[p + "w_gate"][e])) \
                * self.mm(xe, self.p[p + "w_in"][e])
            ye = self.mm(h, self.p[p + "w_out"][e])
            out = out.index_add(0, rows, ye * gates[rows, slot][:, None])
        first = F.one_hot(top_i[:, 0], self.E).float()
        aux = self.E * torch.sum(first.mean(0) * probs.mean(0))
        return out.reshape(x.shape), aux

    def layer(self, i: int, x, start: int = 0):
        """Block i over x (B, T, D) at positions from `start`: (output,
        balance loss or None)."""
        p = f"blocks.{i}."
        B, T, _ = x.shape
        h = self.rms(x, self.p[p + "attn_norm.gamma"])
        q = self.mm(h, self.p[p + "attn.q_proj.W"]).reshape(B, T, self.H,
                                                            self.hd)
        k = self.mm(h, self.p[p + "attn.k_proj.W"]).reshape(B, T, self.K,
                                                            self.hd)
        v = self.mm(h, self.p[p + "attn.v_proj.W"]).reshape(B, T, self.K,
                                                            self.hd)
        o = self.attend(self.rope(q, start), self.rope(k, start), v)
        x = x + self.mm(o.reshape(B, T, self.D), self.p[p + "attn.o_proj.W"])
        h = self.rms(x, self.p[p + "ffn_norm.gamma"])
        if self.E:
            y, aux = self.moe(i, h)
            return x + y, aux
        y = self.mm(F.silu(self.mm(h, self.p[p + "ffn.gate.W"]))
                    * self.mm(h, self.p[p + "ffn.up.W"]),
                    self.p[p + "ffn.down.W"])
        return x + y, None

    def embed(self, ids):
        return self.p["tok_emb.table"][ids.long()]

    def head(self, x):
        return self.mm(self.rms(x, self.p["norm_f.gamma"]),
                       self.p["lm_head.W"])

    # -- whole passes --------------------------------------------------------
    @torch.no_grad()
    def logits(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, T, V) logits of ids (B, T)."""
        x = self.embed(ids)
        for i in range(self.L):
            x = self.layer(i, x)[0]
        return self.head(x)

    def loss_of(self, x, ids):
        """Mean next-token cross-entropy over B·(T − 1) positions."""
        lg = self.head(x[:, :-1])
        return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                               ids[:, 1:].reshape(-1).long())

    def train_step(self, ids: torch.Tensor,
                   update: Callable[[str, torch.Tensor, torch.Tensor], None]
                   ) -> float:
        """One step on ids (B, T): the loss (with the balance losses),
        then `update(name, param, grad)` for each parameter as soon as
        its gradient is whole.  Returns the loss."""
        with torch.no_grad():
            xs = [self.embed(ids)]
            aux_total = 0.0
            for i in range(self.L):
                x, aux = self.layer(i, xs[-1])
                if aux is not None:
                    aux_total += float(aux)
                xs.append(x)
        top = xs[-1].requires_grad_(True)
        head = ("norm_f.gamma", "lm_head.W")
        for n in head:
            self.p[n].requires_grad_(True)
        ce = self.loss_of(top, ids)
        ce.backward()
        loss = float(ce.detach()) + self.aux_w * aux_total
        for n in head:
            self._give(n, update)
        grad = top.grad
        xs[-1] = None
        for i in reversed(range(self.L)):
            names = [n for n in self.p if n.startswith(f"blocks.{i}.")]
            for n in names:
                self.p[n].requires_grad_(True)
            x_in = xs[i].requires_grad_(True)
            out, aux = self.layer(i, x_in)
            roots, grads = [out], [grad]
            if aux is not None and self.aux_w:
                roots.append(aux * self.aux_w)
                grads.append(torch.ones_like(aux))
            torch.autograd.backward(roots, grads)
            grad = x_in.grad
            xs[i] = None
            for n in names:
                self._give(n, update)
        table = self.p["tok_emb.table"]
        g = torch.zeros_like(table).index_add_(
            0, ids.reshape(-1).long(), grad.reshape(-1, self.D))
        update("tok_emb.table", table, g)
        return loss

    def _give(self, name, update):
        p = self.p[name]
        g = p.grad
        p.grad = None
        p.requires_grad_(False)
        update(name, p, g)


class Adafactor:
    """Adafactor with the relative step, factored second moments over the
    last two axes of a matrix whose both are at least 128 wide, update
    clipping at 1 and the parameter scale (Shazeer & Stern 2018,
    Algorithm 4 with β1 = 0)."""

    def __init__(self, decay_rate=0.8, eps1=1e-30, eps2=1e-3, clip=1.0,
                 cap=1e-2, min_factor=128):
        self.decay_rate, self.eps1, self.eps2 = decay_rate, eps1, eps2
        self.clip, self.cap, self.min_factor = clip, cap, min_factor
        self.state: Dict[str, List[torch.Tensor]] = {}
        self.t = 0
        self.grad_norms: Dict[str, float] = {}

    def begin_step(self) -> None:
        self.t += 1
        self.grad_norms = {}

    @torch.no_grad()
    def __call__(self, name: str, p: torch.Tensor, g: torch.Tensor) -> None:
        t = float(self.t)
        decay = 1.0 - t ** (-self.decay_rate)
        self.grad_norms[name] = float(torch.linalg.vector_norm(g))
        gsq = g * g + self.eps1
        factored = p.ndim >= 2 and min(p.shape[-2:]) >= self.min_factor
        st = self.state.get(name)
        if st is None:
            st = ([torch.zeros(p.shape[:-1], device=p.device),
                   torch.zeros(p.shape[:-2] + p.shape[-1:], device=p.device)]
                  if factored else [torch.zeros_like(p)])
            self.state[name] = st
        if factored:
            vr, vc = st
            vr.mul_(decay).add_((1 - decay) * gsq.mean(-1))
            vc.mul_(decay).add_((1 - decay) * gsq.mean(-2))
            r = vr / vr.mean(-1, keepdim=True)
            y = g * torch.rsqrt(r)[..., None] * torch.rsqrt(vc)[..., None, :]
        else:
            (v,) = st
            v.mul_(decay).add_((1 - decay) * gsq)
            y = g * torch.rsqrt(v)
        y = y / max(float(torch.sqrt(torch.mean(y * y))) / self.clip, 1.0)
        rho = min(self.cap, 1.0 / math.sqrt(t))
        rho *= max(float(torch.sqrt(torch.mean(p * p))), self.eps2)
        p.sub_(rho * y)


def follow_steps(cfg: dict, weights, batches: List[torch.Tensor],
                 moe_aux_weight: float, fp8: bool = False) -> dict:
    """The reference's first len(batches) training steps from the
    weights `weights` makes (``all()``: every leaf; ``leaf(name)``: one
    leaf again): each step's loss, each step's gradient norm of each
    leaf, and each leaf's norm of its change over all the steps."""
    params = weights.all()
    ref = Reference(cfg, params, fp8=fp8, moe_aux_weight=moe_aux_weight)
    opt = Adafactor()
    losses, grads = [], []
    for ids in batches:
        opt.begin_step()
        losses.append(ref.train_step(ids, opt))
        grads.append(dict(opt.grad_norms))
    change = {n: float(torch.linalg.vector_norm(params[n] - weights.leaf(n)))
              for n in params}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}
