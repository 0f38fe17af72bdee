"""The program under test, reached through its public entry points: the
configuration file's keys mapped onto ``singa_tpu_torch``'s
``LlamaConfig``, and the device."""

from __future__ import annotations

import torch


def llama_config(cfg: dict, mix: dict):
    """The program's LlamaConfig for configuration `cfg` under the mix's
    recipe."""
    from singa_tpu_torch.models import LlamaConfig
    a = cfg.get("assumed", {})
    return LlamaConfig(
        vocab_size=cfg["vocab_size"], dim=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        ffn_dim=cfg["intermediate_size"],
        max_position=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), eps=cfg["rms_norm_eps"],
        sliding_window=cfg.get("sliding_window") or 0,
        num_experts=cfg.get("num_local_experts", 0),
        moe_top_k=cfg.get("num_experts_per_tok", 2),
        moe_capacity_factor=a.get("moe_capacity_factor", 1.25),
        moe_aux_weight=a.get("moe_aux_weight", 0.0),
        fused_loss=bool(mix.get("fused_loss", False)),
        remat=bool(mix.get("remat", False)))


def program_device(dev: torch.device):
    """The program's Device for torch device `dev`: the card or the CPU."""
    from singa_tpu_torch import device as pdev
    return pdev.create_device("cuda" if dev.type == "cuda" else "cpu")
