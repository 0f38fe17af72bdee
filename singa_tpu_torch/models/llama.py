"""Llama-3 family, ported from ``singa_tpu/models/llama.py``: pre-RMSNorm
decoder blocks, rotary position embeddings, grouped-query attention,
SwiGLU FFN, untied LM head; with Mistral-style sliding-window attention
(``sliding_window``) and a Mixtral-style mixture-of-experts FFN
(``num_experts``).

Ported: ``forward``, ``forward_cached`` and ``generate`` (serving), and
``train_one_batch`` with the fused or plain loss, the MoE balance loss
and optional remat (``layer.Remat`` blocks, as GPT-2's) (training).

``LLAMA_SHARD_RULES`` give Megatron tensor parallelism over a ``model``
mesh axis (q/k/v, gate and up column-parallel, o and down row-parallel,
the embedding table on its hidden dim, the lm head on its vocabulary,
whose logits enter the vocab-parallel cross-entropy); the attention
works on this rank's heads, each with the kv heads it reads.  Under a
``seq`` axis the attention is ``ops.ring_attention`` and RoPE rotates at
the global positions.  With ``pipeline_stages`` the blocks are a
``layer.PipelineStack`` (``pipeline_microbatches`` microbatches, remat
folded in) over the ``pipe`` mesh axis; MoE blocks in it run
sequentially with the reference's warning.  Under an ``expert`` axis
each rank holds its share of every MoE block's experts.
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
from ..ops.attention import banded_attention
from ..ops.ring_attention import ring_attention, seq_parallel
from ..parallel import tensor_parallel as tp
from ._generate import GenerateMixin
from .transformer import (_no_cached_tp, lm_head_vocab, next_token_loss,
                          next_token_loss_fused)

__all__ = ["LlamaConfig", "Llama", "PUBLISHED", "LLAMA_SHARD_RULES"]

# Megatron tensor parallelism over the 'model' axis (the reference's
# rules): q/k/v/gate/up column-parallel, o/down row-parallel, the
# embedding on its hidden dim and the head on its vocabulary
LLAMA_SHARD_RULES = [
    (r"(q_proj|k_proj|v_proj|gate|up)\.W$", (None, "model")),
    (r"(o_proj|down)\.W$", ("model", None)),
    (r"tok_emb\.table$", (None, "model")),
    (r"lm_head\.W$", (None, "model")),
]


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
    # Mistral-style sliding-window attention: query t attends keys in
    # (t - window, t]; 0 = full causal context
    sliding_window: int = 0
    eps: float = 1e-5
    # training-path options of the reference (fused lm-head + CE loss)
    fused_loss: bool = False
    fused_loss_chunk: int = 512
    remat: bool = False
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    # Mixtral-style MoE: > 0 replaces every block's SwiGLU FFN with a
    # top-`moe_top_k` mixture of `num_experts` SwiGLU experts; the
    # balance losses join the training loss at `moe_aux_weight`.  remat
    # skips MoE blocks (their aux losses are a side channel)
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


# published configurations at their widths and depths (not presets: the
# JAX package has none); cut the depth with dataclasses.replace
PUBLISHED = {
    # Mistral-7B-v0.1, its config.json: sliding_window 4096
    "mistral-w4096": LlamaConfig(
        vocab_size=32000, dim=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, ffn_dim=14336, max_position=32768,
        rope_theta=10000.0, eps=1e-5, sliding_window=4096),
    # Mixtral-8x7B-v0.1, its config.json: 8 experts, top-2; the capacity
    # factor E/k = 4.0 routes dropless, as the JAX package's HF import
    # sets it (singa_tpu/models/convert.py)
    "mixtral-8x7b": LlamaConfig(
        vocab_size=32000, dim=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, ffn_dim=14336, max_position=32768,
        rope_theta=1e6, eps=1e-5, num_experts=8, moe_top_k=2,
        moe_capacity_factor=4.0),
}


class _LlamaAttention(layer.Layer):
    def __init__(self, cfg: LlamaConfig, name: Optional[str] = None, *,
                 device: Device, generator: torch.Generator):
        super().__init__(name, device)
        c = self.cfg = cfg
        kw = dict(bias=False, device=device, generator=generator)
        self.q_proj = layer.Linear(c.num_heads * c.head_dim, c.dim, **kw)
        self.k_proj = layer.Linear(c.num_kv_heads * c.head_dim, c.dim, **kw)
        self.v_proj = layer.Linear(c.num_kv_heads * c.head_dim, c.dim, **kw)
        self.o_proj = layer.Linear(c.dim, c.num_heads * c.head_dim, **kw)
        layer.head_units(self, ("q_proj", "k_proj", "v_proj"), ("o_proj",),
                         c.head_dim)
        cos, sin = rope_ops.rope_frequencies(
            c.head_dim, c.max_position, c.rope_theta, c.rope_scaling,
            c.rope_scaling_original_max_position)
        self.register_buffer("rope_cos", cos.to(device.torch_device),
                             persistent=False)
        self.register_buffer("rope_sin", sin.to(device.torch_device),
                             persistent=False)

    def _attend(self, q, k, v, T):
        """Causal attention within the block, banded when the window is
        shorter than the sequence (flash kernels with a window on the
        card, the chunked path elsewhere); else ring attention, which
        is ``ops.attention`` without a 'seq' axis."""
        W = self.cfg.sliding_window
        S = seq_parallel()[0]
        if W and W < T * S:
            if S > 1:
                raise NotImplementedError(
                    "sliding_window attention does not compose with the "
                    "'seq' (ring attention) mesh axis; drop the seq axis "
                    "or use full causal attention")
            return banded_attention(q, k, v, W)
        return ring_attention(q, k, v, causal=True)

    def forward(self, x: torch.Tensor, cache=None, pos=0):
        c = self.cfg
        B, T, _ = x.shape
        hd = c.head_dim
        # this rank's heads: all of them without a 'model' axis
        q = self.q_proj(x).reshape(B, T, -1, hd)
        k = self.k_proj(x).reshape(B, T, -1, hd)
        v = self.v_proj(x).reshape(B, T, -1, hd)
        if cache is None:
            pos = seq_parallel()[1] * T          # the block's first position
        q = rope_ops.apply_rope(q, self.rope_cos, self.rope_sin, offset=pos)
        k = rope_ops.apply_rope(k, self.rope_cos, self.rope_sin, offset=pos)
        k, v = tp.select_kv_heads(q, k, v, c.num_heads, c.num_kv_heads)
        if cache is None:
            o = self._attend(q, k, v, T)
            return self.o_proj(o.reshape(B, T, -1))
        ck, cv = kv_ops.update_cache(cache[0], cache[1], k, v, pos)
        if isinstance(pos, int) and pos == 0:
            # prefill: attend within the prompt through the regular stack
            # (flash kernel when the shape tiles) — what the reference's
            # ring_attention does with no 'seq' mesh installed
            o = self._attend(q, k, v, T)
        else:
            o = kv_ops.cached_sdpa(q, ck, cv, limit=pos + T,
                                   window=c.sliding_window or None)
        out = self.o_proj(o.reshape(B, T, c.num_heads * c.head_dim))
        return out, (ck, cv)


class _SwiGLU(layer.Layer):
    def __init__(self, cfg: LlamaConfig, name: Optional[str] = None, *,
                 device: Device, generator: torch.Generator):
        super().__init__(name, device)
        kw = dict(bias=False, device=device, generator=generator)
        self.gate = layer.Linear(cfg.ffn_dim, cfg.dim, **kw)
        self.up = layer.Linear(cfg.ffn_dim, cfg.dim, **kw)
        self.down = layer.Linear(cfg.dim, cfg.ffn_dim, **kw)

    def forward(self, x):
        return self.down(autograd.silu(self.gate(x)) * self.up(x))


class _LlamaBlock(layer.Layer):
    def __init__(self, cfg: LlamaConfig, name: Optional[str] = None, *,
                 device: Device, generator: torch.Generator):
        super().__init__(name, device)
        self.attn_norm = layer.RMSNorm(cfg.dim, eps=cfg.eps, device=device)
        self.attn = _LlamaAttention(cfg, device=device, generator=generator)
        self.ffn_norm = layer.RMSNorm(cfg.dim, eps=cfg.eps, device=device)
        if cfg.num_experts:
            self.ffn = layer.MoE(cfg.num_experts, ffn_dim=cfg.ffn_dim,
                                 capacity_factor=cfg.moe_capacity_factor,
                                 top_k=cfg.moe_top_k, act="swiglu",
                                 dim=cfg.dim, device=device,
                                 generator=generator)
        else:
            self.ffn = _SwiGLU(cfg, device=device, generator=generator)

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

    SHARD_RULES = LLAMA_SHARD_RULES

    def __init__(self, cfg: Optional[LlamaConfig] = None,
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None, **kw):
        device = device or get_default_device()
        super().__init__(device=device)
        self.cfg = cfg or LlamaConfig(**kw)
        c = self.cfg
        gen = generator if generator is not None else device.generator
        self.tok_emb = layer.Embedding(c.vocab_size, c.dim, device=device,
                                       generator=gen)
        blocks = [_LlamaBlock(c, device=device, generator=gen)
                  for _ in range(c.num_layers)]
        if c.pipeline_stages:
            # the embedding and the head stay outside the pipeline; remat
            # folds into the stack
            self.blocks = layer.PipelineStack(
                blocks, c.pipeline_stages,
                n_micro=c.pipeline_microbatches or None, remat=c.remat)
        else:
            if c.remat:
                blocks = [layer.Remat(b) for b in blocks]
            self.blocks = nn.ModuleList(blocks)
        self.norm_f = layer.RMSNorm(c.dim, eps=c.eps, device=device)
        self.lm_head = layer.Linear(c.vocab_size, c.dim, bias=False,
                                    device=device, generator=gen)

    def features(self, ids: torch.Tensor) -> torch.Tensor:
        """Final hidden states (B, T, dim) — everything but the lm head.
        With ``cfg.remat`` each block is a ``layer.Remat``: while
        training, its internals are recomputed in the backward instead
        of saved, except in blocks with a side channel (MoE), which run
        plain.  Parameter paths are unchanged.  A ``PipelineStack`` runs
        as one call (the GPipe schedule under a pipe axis)."""
        x = self.tok_emb(ids)
        if isinstance(self.blocks, layer.PipelineStack):
            x = self.blocks(x)
        else:
            for blk in self.blocks:
                x = blk(x)
        return self.norm_f(x)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """Logits (B, T, V); an lm head cut over 'model' gathers its
        columns."""
        logits = self.lm_head(self.features(ids))
        if lm_head_vocab(self.lm_head) is not None:
            logits = tp.gather_from_region(logits)
        return logits

    # -- KV-cached decoding ----------------------------------------------
    def init_caches(self, batch: int, max_len: int):
        c = self.cfg
        _no_cached_tp(self.tok_emb.table, self.blocks)
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

    def _moe_aux_loss(self) -> Optional[torch.Tensor]:
        """Summed router balance losses of every MoE block (None when
        dense or nothing accumulated)."""
        total = None
        for m in self.modules():
            if isinstance(m, layer.MoE):
                a = m.pop_aux_loss()
                if a is not None:
                    total = a if total is None else total + a
        return total

    def train_one_batch(self, ids, labels=None):
        """One training step on token ids (B, T): next-token loss (plus
        the weighted MoE balance loss), then ``self.optimizer(loss)``.
        Returns (loss, loss) with the fused loss, else (logits, loss)."""
        tgt = labels if labels is not None else ids
        if self.cfg.fused_loss:
            loss = next_token_loss_fused(self.features(ids), self.lm_head,
                                         tgt,
                                         chunk_rows=self.cfg.fused_loss_chunk)
        else:
            # an lm head cut over 'model': its columns of the logits
            # enter the vocab-parallel loss; the step returns them
            # gathered
            vocab = lm_head_vocab(self.lm_head)
            logits = self.lm_head(self.features(ids))
            loss = next_token_loss(logits, tgt, vocab)
            if vocab is not None:
                with torch.no_grad():
                    logits = tp.gather_from_region(logits)
        if self.cfg.num_experts:
            aux = self._moe_aux_loss()
            if aux is not None:
                loss = loss + aux * self.cfg.moe_aux_weight
        self.optimizer(loss)
        if self.cfg.fused_loss:
            return loss, loss
        return logits, loss

    def num_params(self) -> int:
        return sum(p.numel() for p in self.get_params().values())

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token ≈ 6·N_matmul + 12·L·dim·min(T, W) (the
        reference's accounting: N excludes the token-embedding gather,
        keeps the lm head, and counts only the top-k active experts of
        an MoE block, not the capacity padding; + 2·dim·V when the fused
        loss recomputes the head)."""
        c = self.cfg
        n = self.num_params()
        if n:
            n -= c.vocab_size * c.dim        # tok_emb gather
        if c.num_experts:
            expert_p = 3 * c.dim * c.ffn_dim
            n = max(n - c.num_layers * (c.num_experts - c.moe_top_k)
                    * expert_p, 0)
        attn_span = min(seq_len, c.sliding_window) if c.sliding_window \
            else seq_len
        f = 6 * n + 12 * c.num_layers * c.dim * attn_span
        if c.fused_loss:
            f += 2 * c.dim * c.vocab_size
        return f
