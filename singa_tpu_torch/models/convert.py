"""Weight carry-over into the port: from the JAX package's parameters
and states, and from HuggingFace ``transformers`` GPT-2 and BERT models
(``from_hf_gpt2``, ``from_hf_bert``, ported from
``singa_tpu/models/convert.py``).

The reference model's ``{name: np.asarray(t.data) for name, t in
m.get_params().items()}`` names every parameter by its attribute path
(``get_states()`` adds the buffers, such as BatchNorm's running
statistics), and the port keeps those paths, so a model moves across by
name.

The HF importers take a model object and are pure layout mapping: HF's
Linear stores (out, in) and the port (in, out); GPT-2's Conv1D already
stores (in, out), and its fused ``c_attn`` splits into q, k and v.
``transformers`` itself is never imported here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["load_reference_params", "load_reference_states",
           "from_hf_gpt2", "from_hf_bert"]


def _check_names(what: str, have, arrays) -> None:
    missing = sorted(set(have) - set(arrays))
    extra = sorted(set(arrays) - set(have))
    if missing or extra:
        raise KeyError(f"{what} names differ: missing {missing}, "
                       f"extra {extra}")


def load_reference_params(model, arrays: Dict[str, np.ndarray]) -> None:
    """Copy each array into the port's parameter of the same name.
    Raises on a missing name, an extra name or a shape mismatch."""
    _check_names("parameter", model.get_params(), arrays)
    model.set_params(arrays)


def load_reference_states(model, arrays: Dict[str, np.ndarray]) -> None:
    """`load_reference_params` over parameters and buffers (the names of
    the reference's ``get_states()``)."""
    _check_names("state", model.get_states(), arrays)
    model.set_states(arrays)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def from_hf_gpt2(hf_model, pipeline_stages: int = 0, dropout=None,
                 device=None, generator=None):
    """transformers.GPT2LMHeadModel -> models.GPT2 (tied head) on
    `device` (default: the default device).

    `dropout` defaults to the checkpoint's resid_pdrop, so fine-tuning
    regularises like the source model; pass 0.0 for inference parity in
    training mode."""
    from .transformer import GPT2, GPT2Config

    hc = hf_model.config
    act = getattr(hc, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise NotImplementedError(
            f"activation_function={act!r}; models.GPT2 implements the "
            "tanh-gelu (gelu_new) GPT-2 — converting would silently "
            "change the activation")
    if dropout is None:
        dropout = float(getattr(hc, "resid_pdrop", 0.0) or 0.0)
    cfg = GPT2Config(
        vocab_size=hc.vocab_size, max_position=hc.n_positions,
        dim=hc.n_embd, num_layers=hc.n_layer, num_heads=hc.n_head,
        dropout=dropout, pipeline_stages=pipeline_stages)
    m = GPT2(cfg, device=device, generator=generator)
    sd = hf_model.state_dict()
    a = {"wte.table": _np(sd["transformer.wte.weight"]),
         "wpe.table": _np(sd["transformer.wpe.weight"]),
         "ln_f.gamma": _np(sd["transformer.ln_f.weight"]),
         "ln_f.beta": _np(sd["transformer.ln_f.bias"])}
    D = hc.n_embd
    for i in range(hc.n_layer):
        hfp, our = f"transformer.h.{i}.", f"blocks.{i}."
        for ln in ("ln_1", "ln_2"):
            a[f"{our}{ln}.gamma"] = _np(sd[f"{hfp}{ln}.weight"])
            a[f"{our}{ln}.beta"] = _np(sd[f"{hfp}{ln}.bias"])
        # HF Conv1D stores (in, out): c_attn (D, 3D) fuses q|k|v columns
        ca_w = _np(sd[f"{hfp}attn.c_attn.weight"])
        ca_b = _np(sd[f"{hfp}attn.c_attn.bias"])
        for j, which in enumerate(("q_proj", "k_proj", "v_proj")):
            a[f"{our}attn.{which}.W"] = ca_w[:, j * D:(j + 1) * D]
            a[f"{our}attn.{which}.b"] = ca_b[j * D:(j + 1) * D]
        for theirs, ours in (("attn.c_proj", "attn.out_proj"),
                             ("mlp.c_fc", "mlp.c_fc"),
                             ("mlp.c_proj", "mlp.c_proj")):
            a[f"{our}{ours}.W"] = _np(sd[f"{hfp}{theirs}.weight"])
            a[f"{our}{ours}.b"] = _np(sd[f"{hfp}{theirs}.bias"])
    load_reference_params(m, a)
    return m


def from_hf_bert(hf_model, device=None, generator=None, **kw):
    """transformers.BertForSequenceClassification -> models.BERT (the
    exact-erf GELU on both sides) on `device`."""
    if kw:
        raise NotImplementedError(
            f"from_hf_bert takes no options (got {sorted(kw)}); "
            "pipeline_stages applies to the decoder families only")
    from .transformer import BERT, BERTConfig

    hc = hf_model.config
    if getattr(hc, "hidden_act", "gelu") != "gelu":
        raise NotImplementedError(
            f"hidden_act={hc.hidden_act!r}; models.BERT implements the "
            "standard exact-gelu BERT")
    pe = getattr(hc, "position_embedding_type", "absolute")
    if pe != "absolute":
        raise NotImplementedError(
            f"position_embedding_type={pe!r}; models.BERT implements "
            "absolute position embeddings (relative-key checkpoints "
            "would silently lose their distance embeddings)")
    cfg = BERTConfig(
        vocab_size=hc.vocab_size, max_position=hc.max_position_embeddings,
        type_vocab_size=hc.type_vocab_size, dim=hc.hidden_size,
        num_layers=hc.num_hidden_layers, num_heads=hc.num_attention_heads,
        dropout=float(hc.hidden_dropout_prob),
        num_labels=hc.num_labels, ffn_dim=hc.intermediate_size,
        eps=float(hc.layer_norm_eps))
    m = BERT(cfg, device=device, generator=generator)
    sd = hf_model.state_dict()
    emb = "bert.embeddings."
    a = {"wte.table": _np(sd[emb + "word_embeddings.weight"]),
         "wpe.table": _np(sd[emb + "position_embeddings.weight"]),
         "wtype.table": _np(sd[emb + "token_type_embeddings.weight"]),
         "ln_emb.gamma": _np(sd[emb + "LayerNorm.weight"]),
         "ln_emb.beta": _np(sd[emb + "LayerNorm.bias"]),
         "pooler.W": _np(sd["bert.pooler.dense.weight"]).T,
         "pooler.b": _np(sd["bert.pooler.dense.bias"]),
         "classifier.W": _np(sd["classifier.weight"]).T,
         "classifier.b": _np(sd["classifier.bias"])}
    for i in range(hc.num_hidden_layers):
        hfp, our = f"bert.encoder.layer.{i}.", f"blocks.{i}."
        # HF Linear stores (out, in) -> ours (in, out)
        for theirs, ours in (
                ("attention.self.query", "attn.q_proj"),
                ("attention.self.key", "attn.k_proj"),
                ("attention.self.value", "attn.v_proj"),
                ("attention.output.dense", "attn.out_proj"),
                ("intermediate.dense", "mlp.c_fc"),
                ("output.dense", "mlp.c_proj")):
            a[f"{our}{ours}.W"] = _np(sd[f"{hfp}{theirs}.weight"]).T
            a[f"{our}{ours}.b"] = _np(sd[f"{hfp}{theirs}.bias"])
        for theirs, ours in (("attention.output.LayerNorm", "ln_1"),
                             ("output.LayerNorm", "ln_2")):
            a[f"{our}{ours}.gamma"] = _np(sd[f"{hfp}{theirs}.weight"])
            a[f"{our}{ours}.beta"] = _np(sd[f"{hfp}{theirs}.bias"])
    load_reference_params(m, a)
    return m
