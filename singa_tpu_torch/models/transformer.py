"""The transformer family, ported from ``singa_tpu/models/transformer.py``:
GPT-2 (pre-LN decoder, learned positions, tied head; ``generate()`` and
the paged ``ServeEngine`` through ``forward_cached``) and BERT (post-LN
encoder with token types, pooler and an optional classifier), with the
causal-LM losses (``next_token_loss``, ``next_token_loss_fused_w``,
``next_token_loss_fused``).

Attention goes through ``ops.attention.attention``, as in the reference:
the Hopper flash kernels on the card for sequences of 512 and more
without an explicit mask, the plain path otherwise (BERT at T = 128, any
padding mask).  Widths are given at construction; parameter names and
shapes equal the reference's ``get_params()``.  Tensor-parallel shard
rules, ``remat`` and pipeline stages are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import autograd, layer, model
from ..device import Device, get_default_device
from ..ops import kv_cache as kv_ops
from ._generate import GenerateMixin

__all__ = ["GPT2Config", "GPT2", "BERTConfig", "BERT", "next_token_loss",
           "next_token_loss_fused_w", "next_token_loss_fused"]


def _positions(ids: torch.Tensor) -> torch.Tensor:
    T = ids.shape[-1]
    return torch.arange(T, device=ids.device)[None, :].expand(ids.shape)


def _padding_mask(attention_mask) -> Optional[torch.Tensor]:
    """(B, T) 1/0 mask -> (B, 1, 1, T) bool, broadcast over heads and
    queries."""
    if attention_mask is None:
        return None
    return (torch.as_tensor(attention_mask) > 0)[:, None, None, :]


class _MLP(layer.Layer):
    """c_fc (dim -> hidden), act, c_proj (hidden -> dim).  act:
    "gelu_tanh" (GPT-2's gelu_new), "gelu" (the exact erf form, BERT's)
    or "relu"."""

    def __init__(self, hidden: int, dim: int, act: str = "gelu",
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        kw = dict(device=self.device, generator=generator)
        self.c_fc = layer.Linear(hidden, dim, **kw)
        if act == "gelu":
            self.act = layer.Gelu(approximate=False)
        elif act == "gelu_tanh":
            self.act = layer.Gelu(approximate=True)
        elif act == "relu":
            self.act = layer.ReLU()
        else:
            raise ValueError(f"unknown _MLP act {act!r}")
        self.c_proj = layer.Linear(dim, hidden, **kw)

    def forward(self, x):
        return self.c_proj(self.act(self.c_fc(x)))


# ---------------------------------------------------------------------------
# GPT-2
# ---------------------------------------------------------------------------

@dataclass
class GPT2Config:
    vocab_size: int = 50257
    max_position: int = 1024
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    dropout: float = 0.1
    # chunked fused tied-head + CE loss (no (B*T, V) logits;
    # train_one_batch then returns (loss, loss) instead of (logits, loss))
    fused_loss: bool = False
    # not ported: each raises at construction rather than being ignored
    remat: bool = False
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0

    @staticmethod
    def tiny() -> "GPT2Config":
        return GPT2Config(vocab_size=256, max_position=64, dim=64,
                          num_layers=2, num_heads=4, dropout=0.0)


def _check_supported(c: GPT2Config) -> None:
    if c.remat:
        raise NotImplementedError(
            "GPT2Config.remat=True is not ported yet: it needs "
            "layer.Remat (ROADMAP.md queue 1, the rest of the model API)")
    if c.pipeline_stages:
        raise NotImplementedError(
            f"GPT2Config.pipeline_stages={c.pipeline_stages!r} is not "
            "ported yet: it needs layer.PipelineStack (ROADMAP.md queue 1, "
            "distribution)")


class _GPT2Block(layer.Layer):
    def __init__(self, cfg: GPT2Config, device: Device,
                 generator: torch.Generator):
        super().__init__(device)
        kw = dict(device=device, generator=generator)
        self.ln_1 = layer.LayerNorm(cfg.dim, device=device)
        self.attn = layer.MultiHeadAttention(cfg.num_heads, cfg.dim,
                                             causal=True, **kw)
        self.ln_2 = layer.LayerNorm(cfg.dim, device=device)
        self.mlp = _MLP(4 * cfg.dim, cfg.dim, "gelu_tanh", **kw)
        self.drop = layer.Dropout(cfg.dropout, device=device)

    def forward(self, x, mask=None, cache=None, pos=0):
        if cache is not None:
            a, new_cache = self.attn(self.ln_1(x), mask, cache, pos)
            x = x + self.drop(a)
            x = x + self.drop(self.mlp(self.ln_2(x)))
            return x, new_cache
        x = x + self.drop(self.attn(self.ln_1(x), mask))
        x = x + self.drop(self.mlp(self.ln_2(x)))
        return x


class GPT2(GenerateMixin, model.Model):
    """GPT-2 causal LM with tied embeddings on one port ``Device`` (the
    card unless the caller passes ``device=create_device("cpu")``), with
    f32 master weights drawn from `generator` (default: the device's)."""

    def __init__(self, cfg: Optional[GPT2Config] = None,
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None, **kw):
        device = device or get_default_device()
        super().__init__(device)
        self.cfg = cfg or GPT2Config(**kw)
        c = self.cfg
        _check_supported(c)
        gen = generator if generator is not None else device.generator
        self.wte = layer.Embedding(c.vocab_size, c.dim, device=device,
                                   generator=gen)
        self.wpe = layer.Embedding(c.max_position, c.dim, device=device,
                                   generator=gen)
        self.drop = layer.Dropout(c.dropout, device=device)
        self.blocks = nn.ModuleList(
            [_GPT2Block(c, device, gen) for _ in range(c.num_layers)])
        self.ln_f = layer.LayerNorm(c.dim, device=device)

    def features(self, ids: torch.Tensor,
                 attention_mask=None) -> torch.Tensor:
        """Final hidden states (B, T, dim): everything but the tied head."""
        mask = _padding_mask(attention_mask)
        if mask is not None:
            mask = mask.to(ids.device)
        x = self.drop(self.wte(ids) + self.wpe(_positions(ids)))
        for blk in self.blocks:
            x = blk(x, mask)
        return self.ln_f(x)

    def _tied_head_w(self, x: torch.Tensor) -> torch.Tensor:
        """The tied head's (dim, V) weight: a transposed view of wte's
        table in x's dtype, so bf16 activations stay bf16."""
        w = self.wte.table
        if w.dtype != x.dtype:
            w = autograd.cast(w, x.dtype)
        return w.t()

    def forward(self, ids: torch.Tensor, attention_mask=None):
        x = self.features(ids, attention_mask)
        return torch.matmul(x, self._tied_head_w(x))

    def train_one_batch(self, ids, labels=None):
        """One training step on token ids (B, T): next-token loss, then
        ``self.optimizer(loss)``.  Returns (loss, loss) with the fused
        loss, else (logits, loss)."""
        tgt = labels if labels is not None else ids
        if self.cfg.fused_loss:
            x = self.features(ids)
            loss = next_token_loss_fused_w(x, self._tied_head_w(x), tgt)
            self.optimizer(loss)
            return loss, loss
        logits = self.forward(ids)
        loss = next_token_loss(logits, tgt)
        self.optimizer(loss)
        return logits, loss

    # -- KV-cached decoding ----------------------------------------------
    def init_caches(self, batch: int, max_len: int):
        c = self.cfg
        dtype = torch.bfloat16 if self.wte.table.dtype == torch.bfloat16 \
            else torch.float32
        return kv_ops.init_cache(c.num_layers, batch, max_len, c.num_heads,
                                 c.dim // c.num_heads, dtype,
                                 device=self.device.torch_device)

    def forward_cached(self, ids: torch.Tensor, caches, pos):
        """Logits (B, T, V) of `ids` written into `caches` at `pos`: an
        int, a 0-d tensor (every row at one depth), or a (B,) tensor
        (row b embeds positions [pos[b], pos[b] + T))."""
        T = ids.shape[-1]
        ar = torch.arange(T, device=ids.device)
        if isinstance(pos, int):
            grid = (ar + pos)[None, :]
        else:
            p = torch.as_tensor(pos, device=ids.device)
            grid = p[:, None] + ar if p.ndim else (ar + p)[None, :]
        x = self.drop(self.wte(ids) + self.wpe(grid.expand(ids.shape)))
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, nc = blk(x, None, cache, pos)
            new_caches.append(nc)
        x = self.ln_f(x)
        return torch.matmul(x, self._tied_head_w(x)), new_caches


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

@dataclass
class BERTConfig:
    vocab_size: int = 30522
    max_position: int = 512
    type_vocab_size: int = 2
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    dropout: float = 0.1
    num_labels: Optional[int] = None  # optional classification head
    # FFN width; 0 = the standard 4*dim
    ffn_dim: int = 0
    # LayerNorm epsilon (HF/original BERT uses 1e-12)
    eps: float = 1e-12

    @staticmethod
    def tiny(num_labels: Optional[int] = None) -> "BERTConfig":
        return BERTConfig(vocab_size=256, max_position=64, type_vocab_size=2,
                          dim=64, num_layers=2, num_heads=4, dropout=0.0,
                          num_labels=num_labels)


class _BERTBlock(layer.Layer):
    """Post-LN encoder block (the original BERT layout)."""

    def __init__(self, cfg: BERTConfig, device: Device,
                 generator: torch.Generator):
        super().__init__(device)
        kw = dict(device=device, generator=generator)
        self.attn = layer.MultiHeadAttention(cfg.num_heads, cfg.dim,
                                             causal=False, **kw)
        self.ln_1 = layer.LayerNorm(cfg.dim, eps=cfg.eps, device=device)
        self.mlp = _MLP(cfg.ffn_dim or 4 * cfg.dim, cfg.dim, "gelu", **kw)
        self.ln_2 = layer.LayerNorm(cfg.dim, eps=cfg.eps, device=device)
        self.drop = layer.Dropout(cfg.dropout, device=device)

    def forward(self, x, mask=None):
        x = self.ln_1(x + self.drop(self.attn(x, mask)))
        x = self.ln_2(x + self.drop(self.mlp(x)))
        return x


class BERT(model.Model):
    """BERT-base encoder with pooler and an optional classifier, on one
    port ``Device``, f32 masters drawn from `generator`."""

    def __init__(self, cfg: Optional[BERTConfig] = None,
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None, **kw):
        device = device or get_default_device()
        super().__init__(device)
        self.cfg = cfg or BERTConfig(**kw)
        c = self.cfg
        gen = generator if generator is not None else device.generator
        kw = dict(device=device, generator=gen)
        self.wte = layer.Embedding(c.vocab_size, c.dim, **kw)
        self.wpe = layer.Embedding(c.max_position, c.dim, **kw)
        self.wtype = layer.Embedding(c.type_vocab_size, c.dim, **kw)
        self.ln_emb = layer.LayerNorm(c.dim, eps=c.eps, device=device)
        self.drop = layer.Dropout(c.dropout, device=device)
        self.blocks = nn.ModuleList(
            [_BERTBlock(c, device, gen) for _ in range(c.num_layers)])
        self.pooler = layer.Linear(c.dim, c.dim, **kw)
        self.pool_act = layer.Tanh()
        self.classifier = (layer.Linear(c.num_labels, c.dim, **kw)
                           if c.num_labels else None)

    def forward(self, ids: torch.Tensor, token_type_ids=None,
                attention_mask=None):
        """(hidden states (B, T, dim), pooled (B, dim)), or the
        classifier's logits (B, num_labels) when it has one.  Token
        types default to zeros."""
        ids = torch.as_tensor(ids, device=self.device.torch_device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        mask = _padding_mask(attention_mask)
        if mask is not None:
            mask = mask.to(ids.device)
        x = (self.wte(ids) + self.wpe(_positions(ids))
             + self.wtype(torch.as_tensor(token_type_ids, device=ids.device)))
        x = self.drop(self.ln_emb(x))
        for blk in self.blocks:
            x = blk(x, mask)
        pooled = self.pool_act(self.pooler(x[:, 0, :]))
        if self.classifier is not None:
            return self.classifier(pooled)
        return x, pooled

    def train_one_batch(self, ids, labels, token_type_ids=None,
                        attention_mask=None):
        if self.classifier is None:
            raise RuntimeError("BERT(num_labels=...) required for the "
                               "canonical classification train step")
        out = self.forward(ids, token_type_ids, attention_mask)
        loss = autograd.softmax_cross_entropy(out, labels)
        self.optimizer(loss)
        return out, loss

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs a token, 6·N_matmul + 12·L·dim·T, the
        reference's accounting: N excludes the embedding tables (a
        classification BERT has no vocabulary-sized output product)."""
        c = self.cfg
        n_embed = (c.vocab_size + c.max_position
                   + c.type_vocab_size) * c.dim
        n_total = sum(p.numel() for p in self.get_params().values())
        return (6 * (n_total - n_embed)
                + 12 * c.num_layers * c.dim * seq_len)


def next_token_loss(logits: torch.Tensor, ids) -> torch.Tensor:
    """Causal-LM loss: predict ids[t+1] from logits[t]."""
    B, T, V = logits.shape
    ids = torch.as_tensor(ids, device=logits.device)
    return autograd.softmax_cross_entropy(
        logits[:, :-1, :].reshape(B * (T - 1), V), ids[:, 1:].reshape(-1))


def next_token_loss_fused_w(x: torch.Tensor, w: torch.Tensor, ids,
                            chunk_rows: int = 512) -> torch.Tensor:
    """Causal-LM loss straight from the final hidden states against an
    explicit (dim, V) head weight: the matmul and softmax-CE run fused
    and row-chunked, so the (B*T, V) logits are never materialised."""
    B, T, d = x.shape
    ids = torch.as_tensor(ids, device=x.device)
    return autograd.fused_linear_cross_entropy(
        x[:, :-1, :].reshape(B * (T - 1), d), w, ids[:, 1:].reshape(-1),
        chunk_rows)


def next_token_loss_fused(x: torch.Tensor, lm_head, ids,
                          chunk_rows: int = 512) -> torch.Tensor:
    """next_token_loss_fused_w against a Linear lm-head layer (its f32
    master W; the loss casts it to x's dtype)."""
    return next_token_loss_fused_w(x, lm_head.W, ids, chunk_rows)
