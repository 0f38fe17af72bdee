"""Llama-3 family, ported from ``singa_tpu/models/llama.py``: pre-RMSNorm
decoder blocks, rotary position embeddings, grouped-query attention,
SwiGLU FFN, untied LM head.

This slice serves: ``forward``, ``forward_cached`` and ``generate``.
Sliding-window attention, MoE, pipeline stages and remat come with later
slices and raise here rather than being ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import autograd, layer, model
from ..device import Device, get_default_device
from ..ops import kv_cache as kv_ops
from ..ops import rope as rope_ops
from ..ops.attention import attention
from ._generate import GenerateMixin

__all__ = ["LlamaConfig", "Llama"]


@dataclass
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    ffn_dim: int = 14336
    max_position: int = 8192
    rope_theta: float = 500000.0
    # Llama-3.1-style frequency-dependent RoPE interpolation: 0 = off
    rope_scaling: float = 0.0
    rope_scaling_original_max_position: int = 8192
    # Mistral-style sliding-window attention (0 = full causal context)
    sliding_window: int = 0
    eps: float = 1e-5
    # training-path options of the reference (fused lm-head + CE loss)
    fused_loss: bool = False
    fused_loss_chunk: int = 512
    remat: bool = False
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    # Mixtral-style MoE FFN (0 = dense)
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(vocab_size=256, dim=64, num_layers=2,
                           num_heads=4, num_kv_heads=2, ffn_dim=128,
                           max_position=128, rope_theta=10000.0)

    @staticmethod
    def serve_bench() -> "LlamaConfig":
        return LlamaConfig(vocab_size=1024, dim=256, num_layers=4,
                           num_heads=8, num_kv_heads=4, ffn_dim=688,
                           max_position=128)

    @staticmethod
    def small() -> "LlamaConfig":
        """~110M-param config."""
        return LlamaConfig(vocab_size=32000, dim=768, num_layers=12,
                           num_heads=12, num_kv_heads=4, ffn_dim=2048,
                           max_position=2048)

    @staticmethod
    def base() -> "LlamaConfig":
        """~0.9B-param flagship config (dim 2048, 16 layers, GQA 16/8)."""
        return LlamaConfig(vocab_size=32000, dim=2048, num_layers=16,
                           num_heads=16, num_kv_heads=8, ffn_dim=5632,
                           max_position=2048)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


def _check_supported(c: LlamaConfig) -> None:
    later = [(c.sliding_window, "sliding_window", "the banded-attention slice"),
             (c.num_experts, "num_experts", "the MoE slice"),
             (c.pipeline_stages, "pipeline_stages", "the distribution slice"),
             (c.remat, "remat", "the training slice")]
    for value, name, where in later:
        if value:
            raise NotImplementedError(
                f"LlamaConfig.{name}={value!r} is not ported yet; it comes "
                f"with {where}")


class _LlamaAttention(layer.Layer):
    def __init__(self, cfg: LlamaConfig, device: Device,
                 generator: torch.Generator):
        super().__init__(device)
        c = self.cfg = cfg
        kw = dict(bias=False, device=device, generator=generator)
        self.q_proj = layer.Linear(c.num_heads * c.head_dim, c.dim, **kw)
        self.k_proj = layer.Linear(c.num_kv_heads * c.head_dim, c.dim, **kw)
        self.v_proj = layer.Linear(c.num_kv_heads * c.head_dim, c.dim, **kw)
        self.o_proj = layer.Linear(c.dim, c.num_heads * c.head_dim, **kw)
        cos, sin = rope_ops.rope_frequencies(
            c.head_dim, c.max_position, c.rope_theta, c.rope_scaling,
            c.rope_scaling_original_max_position)
        self.register_buffer("rope_cos", cos.to(device.torch_device),
                             persistent=False)
        self.register_buffer("rope_sin", sin.to(device.torch_device),
                             persistent=False)

    def forward(self, x: torch.Tensor, cache=None, pos=0):
        c = self.cfg
        B, T, _ = x.shape
        q = self.q_proj(x).reshape(B, T, c.num_heads, c.head_dim)
        k = self.k_proj(x).reshape(B, T, c.num_kv_heads, c.head_dim)
        v = self.v_proj(x).reshape(B, T, c.num_kv_heads, c.head_dim)
        q = rope_ops.apply_rope(q, self.rope_cos, self.rope_sin, offset=pos)
        k = rope_ops.apply_rope(k, self.rope_cos, self.rope_sin, offset=pos)
        if cache is None:
            o = attention(q, k, v, causal=True)
            return self.o_proj(o.reshape(B, T, c.num_heads * c.head_dim))
        ck, cv = kv_ops.update_cache(cache[0], cache[1], k, v, pos)
        if isinstance(pos, int) and pos == 0:
            # prefill: attend within the prompt through the regular stack
            # (flash kernel when the shape tiles) — what the reference's
            # ring_attention does with no 'seq' mesh installed
            o = attention(q, k, v, causal=True)
        else:
            o = kv_ops.cached_sdpa(q, ck, cv, limit=pos + T)
        out = self.o_proj(o.reshape(B, T, c.num_heads * c.head_dim))
        return out, (ck, cv)


class _SwiGLU(layer.Layer):
    def __init__(self, cfg: LlamaConfig, device: Device,
                 generator: torch.Generator):
        super().__init__(device)
        kw = dict(bias=False, device=device, generator=generator)
        self.gate = layer.Linear(cfg.ffn_dim, cfg.dim, **kw)
        self.up = layer.Linear(cfg.ffn_dim, cfg.dim, **kw)
        self.down = layer.Linear(cfg.dim, cfg.ffn_dim, **kw)

    def forward(self, x):
        return self.down(autograd.silu(self.gate(x)) * self.up(x))


class _LlamaBlock(layer.Layer):
    def __init__(self, cfg: LlamaConfig, device: Device,
                 generator: torch.Generator):
        super().__init__(device)
        self.attn_norm = layer.RMSNorm(cfg.dim, eps=cfg.eps, device=device)
        self.attn = _LlamaAttention(cfg, device, generator)
        self.ffn_norm = layer.RMSNorm(cfg.dim, eps=cfg.eps, device=device)
        self.ffn = _SwiGLU(cfg, device, generator)

    def forward(self, x, cache=None, pos=0):
        if cache is not None:
            a, new_cache = self.attn(self.attn_norm(x), cache, pos)
            x = x + a
            x = x + self.ffn(self.ffn_norm(x))
            return x, new_cache
        x = x + self.attn(self.attn_norm(x))
        x = x + self.ffn(self.ffn_norm(x))
        return x


class Llama(GenerateMixin, model.Model):
    """Llama decoder on one port ``Device`` (the card unless the caller
    passes ``device=create_device("cpu")``), with f32 master weights
    drawn from `generator` (default: the device's generator)."""

    def __init__(self, cfg: Optional[LlamaConfig] = None,
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None, **kw):
        device = device or get_default_device()
        super().__init__(device)
        self.cfg = cfg or LlamaConfig(**kw)
        c = self.cfg
        _check_supported(c)
        gen = generator if generator is not None else device.generator
        self.tok_emb = layer.Embedding(c.vocab_size, c.dim, device=device,
                                       generator=gen)
        self.blocks = nn.ModuleList(
            [_LlamaBlock(c, device, gen) for _ in range(c.num_layers)])
        self.norm_f = layer.RMSNorm(c.dim, eps=c.eps, device=device)
        self.lm_head = layer.Linear(c.vocab_size, c.dim, bias=False,
                                    device=device, generator=gen)

    def features(self, ids: torch.Tensor) -> torch.Tensor:
        """Final hidden states (B, T, dim) — everything but the lm head."""
        x = self.tok_emb(ids)
        for blk in self.blocks:
            x = blk(x)
        return self.norm_f(x)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.features(ids))

    # -- KV-cached decoding ----------------------------------------------
    def init_caches(self, batch: int, max_len: int):
        c = self.cfg
        dtype = torch.bfloat16 if self.tok_emb.table.dtype == torch.bfloat16 \
            else torch.float32
        return kv_ops.init_cache(c.num_layers, batch, max_len,
                                 c.num_kv_heads, c.head_dim, dtype,
                                 device=self.device.torch_device)

    def forward_cached(self, ids: torch.Tensor, caches, pos):
        x = self.tok_emb(ids)
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, nc = blk(x, cache, pos)
            new_caches.append(nc)
        return self.lm_head(self.norm_f(x)), new_caches

    def num_params(self) -> int:
        return sum(p.numel() for p in self.get_params().values())

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token ≈ 6·N_matmul + 12·L·dim·T (the reference's
        accounting: N excludes the token-embedding gather, keeps the
        lm head; + 2·dim·V when the fused loss recomputes the head)."""
        c = self.cfg
        n = self.num_params()
        if n:
            n -= c.vocab_size * c.dim        # tok_emb gather
        f = 6 * n + 12 * c.num_layers * c.dim * seq_len
        if c.fused_loss:
            f += 2 * c.dim * c.vocab_size
        return f
