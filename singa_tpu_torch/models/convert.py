"""Weight carry-over into and out of the port: from the JAX package's
parameters and states, and from and to HuggingFace ``transformers``
models, ported from ``singa_tpu/models/convert.py``.

The reference model's ``{name: np.asarray(t.data) for name, t in
m.get_params().items()}`` names every parameter by its attribute path
(``get_states()`` adds the buffers, such as BatchNorm's running
statistics), and the port keeps those paths, so a model moves across by
name.

The HF importers (``from_hf_gpt2``, ``from_hf_llama``,
``from_hf_mistral``, ``from_hf_mixtral``, ``from_hf_bert``; ``from_hf``
dispatches on the class name) read only ``.config`` and
``.state_dict()`` of what they are given, and are pure layout mapping:
HF's Linear stores (out, in) and the port (in, out); GPT-2's Conv1D
already stores (in, out), and its fused ``c_attn`` splits into q, k and
v; Mixtral's experts (``w1`` gate, ``w3`` up, ``w2`` down) stack into
the MoE layer's (E, in, out) tables.  RoPE needs no permutation: both
sides rotate halves.

The export runs the other way in two halves: ``hf_layout`` (no
``transformers``) gives an ``HFLayout`` — the HF architecture name, its
config fields and its state dict as torch tensors on the CPU — which
the importers take as they take an HF model, so a machine without
``transformers`` can round-trip a model; ``to_hf`` builds the
``transformers`` instance from it, and is the one function that imports
``transformers`` (inside its body).
"""

from __future__ import annotations

import types
from typing import Dict, Tuple

import numpy as np
import torch

from ..layer import _copy_into

__all__ = ["load_reference_params", "load_reference_states", "from_hf",
           "from_hf_gpt2", "from_hf_llama", "from_hf_mistral",
           "from_hf_mixtral", "from_hf_bert", "HFLayout", "hf_layout",
           "to_hf"]


def _check_names(what: str, have, arrays) -> None:
    missing = sorted(set(have) - set(arrays))
    extra = sorted(set(arrays) - set(have))
    if missing or extra:
        raise KeyError(f"{what} names differ: missing {missing}, "
                       f"extra {extra}")


def load_reference_params(model, arrays: Dict[str, np.ndarray]) -> None:
    """Copy each array (or tensor) into the port's parameter of the same
    name.  Raises on a missing name, an extra name or a shape mismatch."""
    _check_names("parameter", model.get_params(), arrays)
    model.set_params(arrays)


def load_reference_states(model, arrays: Dict[str, np.ndarray]) -> None:
    """`load_reference_params` over parameters and buffers (the names of
    the reference's ``get_states()``)."""
    _check_names("state", model.get_states(), arrays)
    model.set_states(arrays)


def _f32(t) -> torch.Tensor:
    """An HF tensor as f32 where it lies (the copy into the port's
    parameter moves it)."""
    return t.detach().to(torch.float32)


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
    a = {"wte.table": _f32(sd["transformer.wte.weight"]),
         "wpe.table": _f32(sd["transformer.wpe.weight"]),
         "ln_f.gamma": _f32(sd["transformer.ln_f.weight"]),
         "ln_f.beta": _f32(sd["transformer.ln_f.bias"])}
    D = hc.n_embd
    for i in range(hc.n_layer):
        hfp, our = f"transformer.h.{i}.", f"blocks.{i}."
        for ln in ("ln_1", "ln_2"):
            a[f"{our}{ln}.gamma"] = _f32(sd[f"{hfp}{ln}.weight"])
            a[f"{our}{ln}.beta"] = _f32(sd[f"{hfp}{ln}.bias"])
        # HF Conv1D stores (in, out): c_attn (D, 3D) fuses q|k|v columns
        ca_w = _f32(sd[f"{hfp}attn.c_attn.weight"])
        ca_b = _f32(sd[f"{hfp}attn.c_attn.bias"])
        for j, which in enumerate(("q_proj", "k_proj", "v_proj")):
            a[f"{our}attn.{which}.W"] = ca_w[:, j * D:(j + 1) * D]
            a[f"{our}attn.{which}.b"] = ca_b[j * D:(j + 1) * D]
        for theirs, ours in (("attn.c_proj", "attn.out_proj"),
                             ("mlp.c_fc", "mlp.c_fc"),
                             ("mlp.c_proj", "mlp.c_proj")):
            a[f"{our}{ours}.W"] = _f32(sd[f"{hfp}{theirs}.weight"])
            a[f"{our}{ours}.b"] = _f32(sd[f"{hfp}{theirs}.bias"])
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
    a = {"wte.table": _f32(sd[emb + "word_embeddings.weight"]),
         "wpe.table": _f32(sd[emb + "position_embeddings.weight"]),
         "wtype.table": _f32(sd[emb + "token_type_embeddings.weight"]),
         "ln_emb.gamma": _f32(sd[emb + "LayerNorm.weight"]),
         "ln_emb.beta": _f32(sd[emb + "LayerNorm.bias"]),
         "pooler.W": _f32(sd["bert.pooler.dense.weight"]).T,
         "pooler.b": _f32(sd["bert.pooler.dense.bias"]),
         "classifier.W": _f32(sd["classifier.weight"]).T,
         "classifier.b": _f32(sd["classifier.bias"])}
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
            a[f"{our}{ours}.W"] = _f32(sd[f"{hfp}{theirs}.weight"]).T
            a[f"{our}{ours}.b"] = _f32(sd[f"{hfp}{theirs}.bias"])
        for theirs, ours in (("attention.output.LayerNorm", "ln_1"),
                             ("output.LayerNorm", "ln_2")):
            a[f"{our}{ours}.gamma"] = _f32(sd[f"{hfp}{theirs}.weight"])
            a[f"{our}{ours}.beta"] = _f32(sd[f"{hfp}{theirs}.bias"])
    load_reference_params(m, a)
    return m


def from_hf_llama(hf_model, pipeline_stages: int = 0, device=None,
                  generator=None):
    """transformers.LlamaForCausalLM -> models.Llama on `device` (default:
    the default device), Llama-3.1 ``rope_scaling`` carried over through
    ``ops.rope.llama31_rope_scaling``.  `pipeline_stages` > 0 makes the
    blocks a ``layer.PipelineStack`` of that many stages."""
    from .llama import Llama, LlamaConfig

    hc = hf_model.config
    if getattr(hc, "attention_bias", False) or \
            getattr(hc, "mlp_bias", False):
        raise NotImplementedError(
            "checkpoint uses attention_bias/mlp_bias; models.Llama's "
            "projections are bias-free — silently dropping the biases "
            "would corrupt the logits")
    # Llama-3.1-style RoPE scaling must carry over or the scaled
    # frequency bands diverge from transformers
    scaling, orig_max = 0.0, hc.max_position_embeddings
    rs = getattr(hc, "rope_scaling", None)
    if rs:
        kind = rs.get("rope_type", rs.get("type", "default"))
        if kind == "llama3":
            scaling = float(rs["factor"])
            orig_max = int(rs.get("original_max_position_embeddings",
                                  orig_max))
        elif kind != "default":
            raise NotImplementedError(
                f"rope_scaling type {kind!r} is not supported "
                "(supported: llama3)")
    cfg = LlamaConfig(
        vocab_size=hc.vocab_size, dim=hc.hidden_size,
        num_layers=hc.num_hidden_layers,
        num_heads=hc.num_attention_heads,
        num_kv_heads=getattr(hc, "num_key_value_heads",
                             hc.num_attention_heads),
        ffn_dim=hc.intermediate_size,
        max_position=hc.max_position_embeddings,
        rope_theta=float(getattr(hc, "rope_theta", 10000.0)),
        rope_scaling=scaling,
        rope_scaling_original_max_position=orig_max,
        eps=float(hc.rms_norm_eps),
        pipeline_stages=pipeline_stages)
    m = Llama(cfg, device=device, generator=generator)
    _copy_llama_dense_weights(m.get_params(), hf_model.state_dict(),
                              hc.num_hidden_layers)
    return m


#: (HF name, port name) of each Llama projection
_ATTN = (("self_attn.q_proj", "attn.q_proj"),
         ("self_attn.k_proj", "attn.k_proj"),
         ("self_attn.v_proj", "attn.v_proj"),
         ("self_attn.o_proj", "attn.o_proj"))
_MLP = (("mlp.gate_proj", "ffn.gate"), ("mlp.up_proj", "ffn.up"),
        ("mlp.down_proj", "ffn.down"))


def _llama_head(sd) -> Dict[str, torch.Tensor]:
    """Embedding, final norm and head, shared by every Llama layout."""
    head = sd.get("lm_head.weight",
                  sd["model.embed_tokens.weight"])   # tied fallback
    return {"tok_emb.table": _f32(sd["model.embed_tokens.weight"]),
            "norm_f.gamma": _f32(sd["model.norm.weight"]),
            "lm_head.W": _f32(head).T}


def _llama_attention(a, sd, hfp: str, our: str) -> None:
    a[f"{our}attn_norm.gamma"] = _f32(sd[f"{hfp}input_layernorm.weight"])
    a[f"{our}ffn_norm.gamma"] = _f32(
        sd[f"{hfp}post_attention_layernorm.weight"])
    # HF Linear stores (out, in) -> ours (in, out)
    for theirs, ours in _ATTN:
        a[f"{our}{ours}.W"] = _f32(sd[f"{hfp}{theirs}.weight"]).T


def _copy_llama_dense_weights(params, sd, num_layers: int) -> None:
    """Shared Llama/Mistral state-dict copy (identical layouts) into
    `params`, the model's ``get_params()``; raises on a missing or an
    extra name or a shape mismatch."""
    a = _llama_head(sd)
    for i in range(num_layers):
        hfp, our = f"model.layers.{i}.", f"blocks.{i}."
        _llama_attention(a, sd, hfp, our)
        for theirs, ours in _MLP:
            a[f"{our}{ours}.W"] = _f32(sd[f"{hfp}{theirs}.weight"]).T
    _check_names("parameter", params, a)
    _copy_into(params, a)


def from_hf_mistral(hf_model, pipeline_stages: int = 0, device=None,
                    generator=None):
    """transformers.MistralForCausalLM -> models.Llama(sliding_window=W):
    Llama's state-dict layout; the architectural delta is the sliding
    window, mapped onto LlamaConfig.sliding_window."""
    from .llama import Llama, LlamaConfig

    hc = hf_model.config
    hd = getattr(hc, "head_dim", None)
    if hd and hd != hc.hidden_size // hc.num_attention_heads:
        raise NotImplementedError(
            f"custom head_dim={hd} != hidden/heads is not supported")
    cfg = LlamaConfig(
        vocab_size=hc.vocab_size, dim=hc.hidden_size,
        num_layers=hc.num_hidden_layers,
        num_heads=hc.num_attention_heads,
        num_kv_heads=hc.num_key_value_heads,
        ffn_dim=hc.intermediate_size,
        max_position=hc.max_position_embeddings,
        rope_theta=float(getattr(hc, "rope_theta", 10000.0)),
        sliding_window=int(hc.sliding_window or 0),
        eps=float(hc.rms_norm_eps),
        pipeline_stages=pipeline_stages)
    m = Llama(cfg, device=device, generator=generator)
    _copy_llama_dense_weights(m.get_params(), hf_model.state_dict(),
                              hc.num_hidden_layers)
    return m


def from_hf_mixtral(hf_model, device=None, generator=None, **kw):
    """transformers.MixtralForCausalLM -> models.Llama(num_experts=E)
    (SwiGLU experts stacked; HF w1=gate, w3=up, w2=down).

    Routing semantics match exactly (full-softmax probs, top-k,
    renormalise); the converted model's capacity factor is E/k, so NO
    token is ever dropped — HF's dense gather has no capacity concept.
    Lower moe_capacity_factor afterwards for capacity-bound training."""
    from .llama import Llama, LlamaConfig

    if kw:
        raise NotImplementedError(
            f"from_hf_mixtral takes no options (got {sorted(kw)}); "
            "pipeline_stages is incompatible with MoE blocks")
    hc = hf_model.config
    E = hc.num_local_experts
    k = hc.num_experts_per_tok
    if k < 2:
        raise NotImplementedError(
            "num_experts_per_tok=1: HF renormalizes the selected "
            "gate to 1.0 while this framework's k=1 path keeps the "
            "Switch raw-probability gate — logits would silently "
            "diverge")
    cfg = LlamaConfig(
        vocab_size=hc.vocab_size, dim=hc.hidden_size,
        num_layers=hc.num_hidden_layers,
        num_heads=hc.num_attention_heads,
        num_kv_heads=hc.num_key_value_heads,
        ffn_dim=hc.intermediate_size,
        max_position=hc.max_position_embeddings,
        rope_theta=float(hc.rope_theta),
        eps=float(hc.rms_norm_eps),
        num_experts=E, moe_top_k=k,
        sliding_window=int(getattr(hc, "sliding_window", None) or 0),
        moe_capacity_factor=float(E) / k,
        moe_aux_weight=float(getattr(hc, "router_aux_loss_coef", 0.01)))
    m = Llama(cfg, device=device, generator=generator)
    sd = hf_model.state_dict()
    a = _llama_head(sd)
    for i in range(hc.num_hidden_layers):
        hfp, our = f"model.layers.{i}.", f"blocks.{i}."
        _llama_attention(a, sd, hfp, our)
        moe = f"{hfp}block_sparse_moe."
        a[f"{our}ffn.router"] = _f32(sd[moe + "gate.weight"]).T
        for theirs, ours in (("w1", "w_gate"), ("w3", "w_in"),
                             ("w2", "w_out")):
            a[f"{our}ffn.{ours}"] = torch.stack(
                [_f32(sd[f"{moe}experts.{e}.{theirs}.weight"]).T
                 for e in range(E)])
    load_reference_params(m, a)
    return m


def from_hf(hf_model, **kw):
    """Dispatch on the exact transformers class name (an `HFLayout`'s
    architecture); headless and variant classes have other state-dict
    prefixes and are refused."""
    name = (hf_model.architecture if isinstance(hf_model, HFLayout)
            else type(hf_model).__name__)
    if name == "GPT2LMHeadModel":
        return from_hf_gpt2(hf_model, **kw)
    if name == "LlamaForCausalLM":
        return from_hf_llama(hf_model, **kw)
    if name == "MistralForCausalLM":
        return from_hf_mistral(hf_model, **kw)
    if name == "MixtralForCausalLM":
        return from_hf_mixtral(hf_model, **kw)
    if name == "BertForSequenceClassification":
        return from_hf_bert(hf_model, **kw)
    raise NotImplementedError(
        f"no converter for {name}; supported: GPT2LMHeadModel, "
        "LlamaForCausalLM, MistralForCausalLM, MixtralForCausalLM, "
        "BertForSequenceClassification")


# ---------------------------------------------------------------------------
# the reverse direction: the port's models -> the HF layout, and from it
# transformers instances (save_pretrained-able)
# ---------------------------------------------------------------------------

class HFLayout:
    """An HF model's layout without ``transformers``: the architecture
    name (``LlamaForCausalLM``, ...), its config fields as the
    attributes of ``.config``, and its state dict.  The importers take it
    as they take an HF model; ``to_hf`` builds the instance."""

    def __init__(self, architecture: str, fields: Dict,
                 state: Dict[str, torch.Tensor]):
        self.architecture = architecture
        self.config = types.SimpleNamespace(**fields)
        self._state = state

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self._state


#: each exported architecture's transformers config class
_HF_CONFIG = {"GPT2LMHeadModel": "GPT2Config",
              "LlamaForCausalLM": "LlamaConfig",
              "MistralForCausalLM": "MistralConfig"}


def _host(p: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """A parameter as a contiguous f32 CPU tensor (transposed on its own
    device first, where that is the card)."""
    p = p.detach()
    if transpose:
        p = p.T
    return p.contiguous().to("cpu", torch.float32)


def _gpt2_layout(model, params) -> Tuple[str, Dict, Dict]:
    c = model.cfg
    fields = dict(vocab_size=c.vocab_size, n_positions=c.max_position,
                  n_embd=c.dim, n_layer=c.num_layers, n_head=c.num_heads,
                  resid_pdrop=c.dropout, embd_pdrop=c.dropout,
                  attn_pdrop=c.dropout)
    sd = {"transformer.wte.weight": _host(params["wte.table"]),
          "transformer.wpe.weight": _host(params["wpe.table"]),
          "transformer.ln_f.weight": _host(params["ln_f.gamma"]),
          "transformer.ln_f.bias": _host(params["ln_f.beta"])}
    sd["lm_head.weight"] = sd["transformer.wte.weight"]      # tied
    for i in range(c.num_layers):
        our, hfp = f"blocks.{i}.", f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[f"{hfp}{ln}.weight"] = _host(params[f"{our}{ln}.gamma"])
            sd[f"{hfp}{ln}.bias"] = _host(params[f"{our}{ln}.beta"])
        # fuse q|k|v back into Conv1D's (in, 3*out) c_attn
        qkv = ("q_proj", "k_proj", "v_proj")
        sd[f"{hfp}attn.c_attn.weight"] = torch.cat(
            [_host(params[f"{our}attn.{p}.W"]) for p in qkv], dim=1)
        sd[f"{hfp}attn.c_attn.bias"] = torch.cat(
            [_host(params[f"{our}attn.{p}.b"]) for p in qkv])
        for theirs, ours in (("attn.c_proj", "attn.out_proj"),
                             ("mlp.c_fc", "mlp.c_fc"),
                             ("mlp.c_proj", "mlp.c_proj")):
            sd[f"{hfp}{theirs}.weight"] = _host(params[f"{our}{ours}.W"])
            sd[f"{hfp}{theirs}.bias"] = _host(params[f"{our}{ours}.b"])
    return "GPT2LMHeadModel", fields, sd


def _llama_layout(model, params) -> Tuple[str, Dict, Dict]:
    c = model.cfg
    if c.num_experts:
        raise NotImplementedError(
            "to_hf does not yet export MoE (Mixtral-config) Llama "
            "models — only dense ones")
    rs = None
    if c.rope_scaling:
        rs = {"rope_type": "llama3", "factor": float(c.rope_scaling),
              "original_max_position_embeddings":
                  int(c.rope_scaling_original_max_position),
              "low_freq_factor": 1.0, "high_freq_factor": 4.0}
    fields = dict(
        vocab_size=c.vocab_size, hidden_size=c.dim,
        intermediate_size=c.ffn_dim, num_hidden_layers=c.num_layers,
        num_attention_heads=c.num_heads,
        num_key_value_heads=c.num_kv_heads,
        max_position_embeddings=c.max_position,
        rope_theta=c.rope_theta, rms_norm_eps=c.eps,
        tie_word_embeddings=False)
    if c.sliding_window:
        # the window is load-bearing: exporting as a plain Llama
        # would silently attend the full context in HF
        if rs:
            raise NotImplementedError(
                "sliding_window + rope_scaling has no matching HF "
                "architecture to export to")
        arch = "MistralForCausalLM"
        fields["sliding_window"] = c.sliding_window
    else:
        arch = "LlamaForCausalLM"
        fields.update(rope_scaling=rs, attention_bias=False,
                      mlp_bias=False)
    sd = {"model.embed_tokens.weight": _host(params["tok_emb.table"]),
          "model.norm.weight": _host(params["norm_f.gamma"]),
          "lm_head.weight": _host(params["lm_head.W"], transpose=True)}
    for i in range(c.num_layers):
        our, hfp = f"blocks.{i}.", f"model.layers.{i}."
        sd[f"{hfp}input_layernorm.weight"] = _host(
            params[f"{our}attn_norm.gamma"])
        sd[f"{hfp}post_attention_layernorm.weight"] = _host(
            params[f"{our}ffn_norm.gamma"])
        for theirs, ours in _ATTN + _MLP:
            sd[f"{hfp}{theirs}.weight"] = _host(params[f"{our}{ours}.W"],
                                                transpose=True)
    return arch, fields, sd


def hf_layout(model) -> HFLayout:
    """A models.GPT2 or a dense models.Llama in the HF layout, without
    ``transformers``: the architecture name (a Llama with a window is a
    ``MistralForCausalLM``), the config fields and the state dict as f32
    CPU tensors."""
    from .llama import Llama
    from .transformer import GPT2

    if isinstance(model, GPT2):
        return HFLayout(*_gpt2_layout(model, model.get_params()))
    if isinstance(model, Llama):
        return HFLayout(*_llama_layout(model, model.get_params()))
    raise NotImplementedError(
        f"to_hf supports models.GPT2 and models.Llama, got "
        f"{type(model).__name__}")


def to_hf(model):
    """Export a models.GPT2 / models.Llama to a fresh transformers model
    carrying this model's weights (the inverse of from_hf; logits
    match).  Returns the transformers instance: call .save_pretrained on
    it for a standard HF checkpoint.  The only function of the port
    that imports ``transformers``."""
    layout = hf_layout(model)
    import transformers

    arch = layout.architecture
    config = getattr(transformers, _HF_CONFIG[arch])(**vars(layout.config))
    hf = getattr(transformers, arch)(config)
    hf.load_state_dict(layout.state_dict(), strict=False)
    if arch == "GPT2LMHeadModel":
        hf.tie_weights()
    return hf.eval()
