"""The port's HuggingFace importers (``models.from_hf_gpt2``,
``from_hf_bert``) against HF models built in-process from configs (no
weights are downloaded) and against the JAX package's importers, on the
CPU in f32.

Tolerances: logits against transformers within the reference's own
rtol 1e-4, atol 1e-5 (tests/test_convert.py); the imported parameters
equal the reference importer's exactly (both are layout copies of the
same HF tensors); the two packages' logits within rtol 1e-5, atol
1e-5 of the largest."""

import numpy as np
import pytest
import torch
import transformers

from singa_tpu import models as jmodels
from singa_tpu import tensor as jtensor
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.models import from_hf_bert, from_hf_gpt2

CPU = tdevice.create_device("cpu")


def _ids(vocab=211, shape=(2, 16), seed=0):
    return np.random.RandomState(seed).randint(
        0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def hf():
    """HF GPT-2 and BERT (3 labels) built from configs, as the
    reference's tests build them."""
    torch.manual_seed(0)
    gcfg = transformers.GPT2Config(
        vocab_size=211, n_positions=64, n_embd=48, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, use_cache=False,
        attn_implementation="eager")
    gpt2 = transformers.GPT2LMHeadModel(gcfg).eval()
    torch.manual_seed(0)
    bcfg = transformers.BertConfig(
        vocab_size=211, hidden_size=48, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=96,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        num_labels=3, attn_implementation="eager")
    return {"gpt2": gpt2,
            "bert": transformers.BertForSequenceClassification(bcfg).eval()}


@pytest.fixture
def hf_gpt2(hf):
    return hf["gpt2"]


@pytest.fixture
def hf_bert(hf):
    return hf["bert"]


def _same_params(tm, jm):
    jp = jm.get_params()
    tp = tm.get_params()
    assert list(tp) == list(jp)
    for n, p in tp.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(jp[n].data), err_msg=n)


def test_gpt2_import_matches_transformers_and_the_reference(hf_gpt2):
    tm = from_hf_gpt2(hf_gpt2, device=CPU)
    tm.eval()
    assert (tm.cfg.dim, tm.cfg.num_layers, tm.cfg.num_heads,
            tm.cfg.dropout) == (48, 2, 4, 0.0)
    ids = _ids()
    with torch.no_grad():
        ref = hf_gpt2(input_ids=torch.tensor(ids.astype(np.int64)),
                      use_cache=False).logits.numpy()
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)

    jm = jmodels.from_hf_gpt2(hf_gpt2)
    jm.eval()
    _same_params(tm, jm)
    jout = np.asarray(jm(jtensor.from_numpy(ids)).data)
    np.testing.assert_allclose(out, jout, rtol=1e-5,
                               atol=1e-5 * np.abs(jout).max())


def test_gpt2_import_generates_as_the_reference(hf_gpt2):
    tm = from_hf_gpt2(hf_gpt2, device=CPU)
    jm = jmodels.from_hf_gpt2(hf_gpt2)
    prompt = _ids(shape=(1, 8), seed=2)
    np.testing.assert_array_equal(tm.generate(prompt, max_new_tokens=5),
                                  jm.generate(prompt, max_new_tokens=5))


def test_bert_import_matches_transformers_and_the_reference(hf_bert):
    """A padding mask and token types, as the reference's test."""
    tm = from_hf_bert(hf_bert, device=CPU)
    tm.eval()
    assert tm.cfg.eps == 1e-12 and tm.cfg.num_labels == 3
    ids = _ids()
    am = np.ones((2, 16), np.int64)
    am[:, 12:] = 0
    tt = np.zeros((2, 16), np.int64)
    tt[:, 8:] = 1
    with torch.no_grad():
        ref = hf_bert(input_ids=torch.tensor(ids.astype(np.int64)),
                      attention_mask=torch.tensor(am),
                      token_type_ids=torch.tensor(tt)).logits.numpy()
        out = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                 torch.from_numpy(am)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)

    jm = jmodels.from_hf_bert(hf_bert)
    jm.eval()
    _same_params(tm, jm)
    jout = np.asarray(jm(jtensor.from_numpy(ids),
                         jtensor.from_numpy(tt.astype(np.int32)),
                         jtensor.from_numpy(am.astype(np.float32))).data)
    np.testing.assert_allclose(out, jout, rtol=1e-5,
                               atol=1e-5 * np.abs(jout).max())


def test_importers_refuse_what_they_would_change(hf_gpt2, hf_bert):
    cfg = transformers.GPT2Config(n_embd=16, n_layer=1, n_head=2,
                                  vocab_size=32, n_positions=8,
                                  activation_function="relu")
    with pytest.raises(NotImplementedError, match="activation_function"):
        from_hf_gpt2(transformers.GPT2LMHeadModel(cfg), device=CPU)
    with pytest.raises(NotImplementedError, match="PipelineStack"):
        from_hf_gpt2(hf_gpt2, pipeline_stages=2, device=CPU)
    with pytest.raises(NotImplementedError, match="no options"):
        from_hf_bert(hf_bert, pipeline_stages=2)
    bcfg = transformers.BertConfig(
        vocab_size=32, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=8, hidden_act="relu")
    with pytest.raises(NotImplementedError, match="hidden_act"):
        from_hf_bert(transformers.BertForSequenceClassification(bcfg),
                     device=CPU)


def test_gpt2_import_takes_the_checkpoints_dropout(hf_gpt2):
    torch.manual_seed(1)
    cfg = transformers.GPT2Config(n_embd=16, n_layer=1, n_head=2,
                                  vocab_size=32, n_positions=8,
                                  resid_pdrop=0.1)
    hf = transformers.GPT2LMHeadModel(cfg)
    assert from_hf_gpt2(hf, device=CPU).cfg.dropout == 0.1
    assert from_hf_gpt2(hf, dropout=0.0, device=CPU).cfg.dropout == 0.0
