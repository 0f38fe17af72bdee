"""The port's Llama-family HuggingFace converters (``models.from_hf_llama``,
``from_hf_mistral``, ``from_hf_mixtral``, ``from_hf``, ``hf_layout``,
``to_hf``) against HF models built in-process from configs (no weights
are downloaded) and against the JAX package's converters, on the CPU in
f32.

Tolerances: logits against transformers within the reference's own
rtol 1e-4, atol 1e-5 (tests/test_convert.py); the imported parameters
equal the reference importer's exactly (both are layout copies of the
same HF tensors); the two packages' logits within 1e-5 of the largest;
a round trip through the HF layout (port -> HF -> port) bitwise.  The
window binds (T = 24 > 6) and the llama3 RoPE scaling reaches past its
original 32 positions (T = 48) in the comparisons with transformers."""

import ast
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

# transformers would otherwise import TensorFlow (~10 s) it never uses here
os.environ.setdefault("USE_TF", "0")
import transformers  # noqa: E402

from singa_tpu import models as jmodels
from singa_tpu import tensor as jtensor
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.models import (GPT2, GPT2Config, HFLayout, Llama,
                                    LlamaConfig, convert, from_hf,
                                    from_hf_llama, from_hf_mistral,
                                    from_hf_mixtral, hf_layout, to_hf)

CPU = tdevice.create_device("cpu")
REPO = Path(__file__).resolve().parents[1]
VOCAB = 101
#: the reference's forwards run at the shape its importer's first forward
#: (``_init``) compiled: (1, 8)
SHORT = (1, 8)
SMALL = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, rms_norm_eps=1e-5,
             attn_implementation="eager", use_cache=False)


def _ids(shape, seed=0):
    return np.random.RandomState(seed).randint(
        0, VOCAB, shape).astype(np.int32)


def _hf_models():
    """name -> (HF model, ids): GQA with a tied head and llama3 RoPE
    scaling (T past the original window), a window shorter than T, and
    four experts with top-2."""
    torch.manual_seed(0)
    llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **SMALL, max_position_embeddings=256, rope_theta=10000.0,
        tie_word_embeddings=True,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "original_max_position_embeddings": 32,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0}))
    torch.manual_seed(1)
    mistral = transformers.MistralForCausalLM(transformers.MistralConfig(
        **SMALL, max_position_embeddings=64, rope_theta=10000.0,
        sliding_window=6))
    torch.manual_seed(2)
    mixtral = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        **SMALL, max_position_embeddings=64, rope_theta=10000.0,
        num_local_experts=4, num_experts_per_tok=2))
    return {"llama": (llama.eval(), _ids((2, 48))),
            "mistral": (mistral.eval(), _ids((2, 24), 1)),
            "mixtral": (mixtral.eval(), _ids((2, 24), 2))}


def _port_logits(m, ids):
    m.eval()
    with torch.no_grad():
        return m(torch.from_numpy(ids)).numpy()


@pytest.fixture(scope="module")
def fam():
    """Each family: the HF model, its ids and logits, the port's import
    and logits, the reference's import and its logits beside the port's
    on SHORT ids (the shape of the reference importer's own first
    forward, whose eager ops are then compiled already)."""
    out = {}
    short = _ids(SHORT, 4)
    for name, (hf, ids) in _hf_models().items():
        with torch.no_grad():
            ref = hf(input_ids=torch.tensor(ids.astype(np.int64)),
                     use_cache=False).logits.numpy()
        tm = from_hf(hf, device=CPU)
        jm = jmodels.from_hf(hf)
        jm.eval()
        jl = jm(jtensor.from_numpy(short)).to_numpy().reshape(
            SHORT + (VOCAB,))
        out[name] = dict(hf=hf, ids=ids, hf_logits=ref, tm=tm,
                         tm_logits=_port_logits(tm, ids), jm=jm,
                         jm_logits=jl, tm_short=_port_logits(tm, short))
    return out


FAMILIES = ["llama", "mistral", "mixtral"]


@pytest.mark.parametrize("name", FAMILIES)
def test_import_matches_transformers(fam, name):
    f = fam[name]
    np.testing.assert_allclose(f["tm_logits"], f["hf_logits"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", FAMILIES)
def test_imported_parameters_equal_the_reference_importers(fam, name):
    tp, jp = fam[name]["tm"].get_params(), fam[name]["jm"].get_params()
    assert sorted(tp) == sorted(jp)
    for n, p in tp.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(jp[n].data), err_msg=n)


@pytest.mark.parametrize("name", FAMILIES)
def test_logits_equal_the_reference_import(fam, name):
    f = fam[name]
    want = f["jm_logits"]
    np.testing.assert_allclose(f["tm_short"], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_configurations_carry_over(fam):
    lc, mc, xc = (fam[n]["tm"].cfg for n in FAMILIES)
    assert (lc.num_kv_heads, lc.rope_scaling,
            lc.rope_scaling_original_max_position) == (2, 8.0, 32)
    assert mc.sliding_window == 6 < fam["mistral"]["ids"].shape[1]
    assert (xc.num_experts, xc.moe_top_k, xc.moe_capacity_factor,
            xc.moe_aux_weight) == (4, 2, 2.0, 0.001)
    for n in FAMILIES:
        j, t = fam[n]["jm"].cfg, fam[n]["tm"].cfg
        assert dataclasses.asdict(t) == dataclasses.asdict(j), n


@pytest.mark.parametrize("name,fn", [("llama", from_hf_llama),
                                     ("mistral", from_hf_mistral),
                                     ("mixtral", from_hf_mixtral)])
def test_from_hf_dispatches_on_the_class_name(fam, monkeypatch, name, fn):
    seen = []
    monkeypatch.setattr(convert, fn.__name__,
                        lambda hf, **kw: seen.append((hf, kw)))
    hf = fam[name]["hf"]
    from_hf(hf, device=CPU)
    assert seen == [(hf, {"device": CPU})]


# -- refusals: the reference's, with its messages --------------------------

def _hf(cls, cfg_cls, **kw):
    torch.manual_seed(0)
    return getattr(transformers, cls)(getattr(transformers, cfg_cls)(
        **dict(SMALL, max_position_embeddings=64, **kw))).eval()


REFUSALS = {
    "attention_bias": lambda: _hf("LlamaForCausalLM", "LlamaConfig",
                                  attention_bias=True),
    "mlp_bias": lambda: _hf("LlamaForCausalLM", "LlamaConfig",
                            mlp_bias=True),
    "rope_yarn": lambda: _hf("LlamaForCausalLM", "LlamaConfig",
                             rope_scaling={"rope_type": "yarn",
                                           "factor": 4.0}),
    "head_dim": lambda: _hf("MistralForCausalLM", "MistralConfig",
                            head_dim=16),
    "top_1": lambda: _hf("MixtralForCausalLM", "MixtralConfig",
                         num_local_experts=4, num_experts_per_tok=1),
    "unknown_class": lambda: type("LlamaModel", (), {})(),
}


def _message(fn, *a, **kw):
    with pytest.raises(NotImplementedError) as e:
        fn(*a, **kw)
    return str(e.value)


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_importers_refuse_what_the_reference_refuses(case):
    hf = REFUSALS[case]()
    assert _message(from_hf, hf, device=CPU) == _message(jmodels.from_hf, hf)


def test_mixtral_options_and_pipeline_stages_raise(fam):
    hf = fam["mixtral"]["hf"]
    assert _message(from_hf_mixtral, hf, pipeline_stages=2) == \
        _message(jmodels.from_hf_mixtral, hf, pipeline_stages=2)
    # the dense families take pipeline stages, as the reference's do:
    # the blocks a PipelineStack holding the plain import's parameters
    for name in ("llama", "mistral"):
        m = from_hf(fam[name]["hf"], pipeline_stages=2, device=CPU)
        assert type(m.blocks).__name__ == "PipelineStack"
        plain = fam[name]["tm"].get_params()
        assert all(torch.equal(p, plain[n])
                   for n, p in m.get_params().items())


EXPORT_REFUSALS = {
    "moe": dict(num_experts=4, moe_top_k=2),
    "window_and_rope_scaling": dict(sliding_window=6, rope_scaling=8.0,
                                    rope_scaling_original_max_position=32),
}


@pytest.mark.parametrize("case", sorted(EXPORT_REFUSALS))
def test_to_hf_refuses_what_the_reference_refuses(case):
    kw = dict(vocab_size=VOCAB, dim=32, num_layers=1, num_heads=4,
              num_kv_heads=2, ffn_dim=64, max_position=64,
              **EXPORT_REFUSALS[case])
    tm = Llama(LlamaConfig(**kw), device=CPU)
    jm = jmodels.Llama(jmodels.LlamaConfig(**kw))
    msg = _message(to_hf, tm)
    assert msg == _message(jmodels.to_hf, jm)
    assert _message(hf_layout, tm) == msg


def test_to_hf_refuses_other_models():
    from singa_tpu_torch.models import MLP
    assert _message(to_hf, MLP(device=CPU)) == \
        _message(jmodels.to_hf, jmodels.MLP())


# -- the way back: to_hf and hf_layout ---------------------------------------

def _same(a, b):
    pa, pb = a.get_params(), b.get_params()
    assert list(pa) == list(pb)
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n


@pytest.mark.parametrize("name", ["llama", "mistral"])
def test_round_trip_through_transformers_is_bitwise(fam, name):
    f = fam[name]
    hf = to_hf(f["tm"])
    assert type(hf).__name__ == type(f["hf"]).__name__
    with torch.no_grad():
        got = hf(input_ids=torch.tensor(f["ids"].astype(np.int64)),
                 use_cache=False).logits.numpy()
    np.testing.assert_allclose(f["tm_logits"], got, rtol=1e-4, atol=1e-5)
    back = from_hf(hf, device=CPU)
    _same(back, f["tm"])
    assert dataclasses.asdict(back.cfg) == dataclasses.asdict(f["tm"].cfg)


@pytest.mark.parametrize("name", ["llama", "mistral"])
def test_export_equals_the_reference_export(fam, name):
    """The same weights exported by both packages: the same class, the
    same config fields and a bitwise-equal state dict."""
    f = fam[name]
    got, want = to_hf(f["tm"]), jmodels.to_hf(f["jm"])
    assert type(got) is type(want)
    assert got.config.to_dict() == want.config.to_dict()
    gs, ws = got.state_dict(), want.state_dict()
    assert list(gs) == list(ws)
    for k in gs:
        assert torch.equal(gs[k], ws[k]), k


def test_layout_alone_round_trips_without_transformers(fam):
    """hf_layout's output stands in for an HF model: the importers read
    its .config and .state_dict() only, so a machine without
    transformers round-trips a model bitwise."""
    for name in ("llama", "mistral"):
        tm = fam[name]["tm"]
        layout = hf_layout(tm)
        assert isinstance(layout, HFLayout)
        assert layout.architecture == type(fam[name]["hf"]).__name__
        assert all(t.device.type == "cpu" and t.dtype == torch.float32
                   and t.is_contiguous()
                   for t in layout.state_dict().values())
        _same(from_hf(layout, device=CPU), tm)
        hf_sd = to_hf(tm).state_dict()
        for k, t in layout.state_dict().items():
            assert torch.equal(hf_sd[k], t), k


def test_mixtral_layout_written_by_hand_imports(fam):
    """to_hf does not export MoE, so a caller writes the Mixtral layout
    itself (w1 gate, w3 up, w2 down, gate.weight the router), as the
    chip script does: it imports as the HF model does."""
    hf = fam["mixtral"]["hf"]
    fields = {k: getattr(hf.config, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size",
        "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
        "max_position_embeddings", "rope_theta", "rms_norm_eps",
        "num_local_experts", "num_experts_per_tok", "sliding_window",
        "router_aux_loss_coef")}
    layout = HFLayout("MixtralForCausalLM", fields,
                      {k: v.clone() for k, v in hf.state_dict().items()})
    _same(from_hf(layout, device=CPU), fam["mixtral"]["tm"])


def test_gpt2_round_trip_and_save_pretrained(tmp_path):
    torch.manual_seed(3)
    m = GPT2(GPT2Config(vocab_size=VOCAB, max_position=64, dim=48,
                        num_layers=2, num_heads=4, dropout=0.0), device=CPU)
    ids = _ids((2, 16), 3)
    ours = _port_logits(m, ids)
    hf = to_hf(m)
    assert hf.lm_head.weight.data_ptr() == \
        hf.transformer.wte.weight.data_ptr()                  # tied
    d = tmp_path / "gpt2"
    hf.save_pretrained(str(d), safe_serialization=False)
    hf2 = transformers.GPT2LMHeadModel.from_pretrained(str(d)).eval()
    with torch.no_grad():
        got = hf2(input_ids=torch.tensor(ids.astype(np.int64)),
                  use_cache=False).logits.numpy()
    np.testing.assert_allclose(ours, got, rtol=1e-4, atol=1e-5)
    _same(from_hf(hf2, device=CPU, dropout=0.0), m)


def test_llama_save_pretrained_round_trip(fam, tmp_path):
    tm = fam["llama"]["tm"]
    d = tmp_path / "llama"
    to_hf(tm).save_pretrained(str(d))
    back = from_hf(transformers.LlamaForCausalLM.from_pretrained(str(d)),
                   device=CPU)
    _same(back, tm)


def _transformers_imports(tree):
    """The enclosing function's name (None at module level) of each
    import of transformers in `tree`."""
    found = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom):
                names = [child.module or ""]
            else:
                names = []
            if any(n.split(".")[0] == "transformers" for n in names):
                found.append(fn)
            visit(child, child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)
    visit(tree, None)
    return found


def test_transformers_is_imported_only_inside_to_hf():
    """The card's machine has no transformers: nothing of the port
    imports it but the body of convert.to_hf."""
    where = [(str(p.relative_to(REPO)), fn)
             for p in sorted((REPO / "singa_tpu_torch").rglob("*.py"))
             for fn in _transformers_imports(ast.parse(p.read_text()))]
    assert where == [("singa_tpu_torch/models/convert.py", "to_hf")]
