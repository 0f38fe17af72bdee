"""The port's GPT-2 and BERT (singa_tpu_torch.models.transformer) against
the JAX package's, on the CPU: GPT2Config.tiny() and BERTConfig.tiny()
in f32 with the reference's weights carried over by
`load_reference_params`, on numpy-seeded batches.

Tolerances (both sides f32; they differ in op order and elementwise
implementations only):
  * GPT-2 logits and BERT's (x, pooled): rtol 1e-5, atol 1e-5 of the
    largest reference value;
  * ten train_steps: every step's loss within rtol 1e-4;
  * greedy token streams: identical, to the reference's generate() and,
    through the port's ServeEngine, to the port's own generate()."""

import dataclasses

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import transformer as jtr
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch.models import (BERT, GPT2, BERTConfig, GPT2Config,
                                    load_reference_params)
from singa_tpu_torch.models import transformer as ttr
from singa_tpu_torch.serve import ServeEngine

B, T = 2, 16
STEPS = 10
TOL = 1e-5
LOSS_RTOL = 1e-4
CPU = tdevice.create_device("cpu")


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(CPU)
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)
    jautograd.set_training(False)


def _ids(shape=(B, T), seed=3, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _padding(lengths, t=T):
    m = np.zeros((len(lengths), t), np.int32)
    for i, n in enumerate(lengths):
        m[i, :n] = 1
    return m


def _arrays(jm):
    return {n: np.asarray(t.data) for n, t in jm.get_params().items()}


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


@pytest.fixture(scope="module")
def refs():
    """The reference tiny GPT-2 and BERT (with a 3-label classifier) in
    eval, each with its initial parameters by name."""
    out = {}
    for seed, name, make in (
            (0, "gpt2", lambda: jtr.GPT2(jtr.GPT2Config.tiny())),
            (1, "bert", lambda: jtr.BERT(jtr.BERTConfig.tiny(num_labels=3)))):
        jtensor.set_seed(seed)
        jm = make()
        jm.compile([jtensor.from_numpy(_ids())], is_train=False,
                   use_graph=False)
        out[name] = (jm, _arrays(jm))
    return out


@pytest.fixture
def gpt2(refs):
    return refs["gpt2"]


@pytest.fixture
def bert(refs):
    return refs["bert"]


def _tgpt2(arrays, **kw):
    tm = GPT2(dataclasses.replace(GPT2Config.tiny(), **kw), device=CPU)
    load_reference_params(tm, arrays)
    return tm


def _tbert(arrays, **kw):
    tm = BERT(BERTConfig.tiny(**kw), device=CPU)
    load_reference_params(tm, {n: a for n, a in arrays.items()
                               if n in tm.get_params()})
    return tm


# -- GPT-2 -----------------------------------------------------------------------

def test_gpt2_names_shapes_and_presets_are_the_reference(gpt2):
    jm, arrays = gpt2
    tm = _tgpt2(arrays)
    tp = tm.get_params()
    assert list(tp) == list(arrays)
    assert all(tuple(tp[n].shape) == arrays[n].shape for n in arrays)
    for name in ("tiny",):
        assert dataclasses.asdict(getattr(GPT2Config, name)()) == \
            dataclasses.asdict(getattr(jtr.GPT2Config, name)())
    assert dataclasses.asdict(GPT2Config()) == \
        dataclasses.asdict(jtr.GPT2Config())
    # GPT-2 124M at its published widths
    full = GPT2(GPT2Config(num_layers=1), device=CPU)
    n_block = sum(p.numel() for n, p in full.get_params().items()
                  if n.startswith("blocks."))
    n_rest = sum(p.numel() for n, p in full.get_params().items()
                 if not n.startswith("blocks."))
    assert n_rest + 12 * n_block == 124_439_808


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_gpt2_flops_per_token_counts_the_tied_head(gpt2, fused):
    """6 N + 12 L dim T over the reference's parameters less the position
    table (a gather), + 2 dim V where the fused loss recomputes the tied
    head: Llama's accounting."""
    _, arrays = gpt2
    tm = _tgpt2(arrays, fused_loss=fused)
    c = tm.cfg
    n = sum(a.size for name, a in arrays.items() if name != "wpe.table")
    assert arrays["wpe.table"].shape == (c.max_position, c.dim)
    for t in (16, 64):
        want = 6 * n + 12 * c.num_layers * c.dim * t \
            + (2 * c.dim * c.vocab_size if fused else 0)
        assert tm.flops_per_token(t) == want


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "padding"])
def test_gpt2_logits_match(gpt2, masked):
    jm, arrays = gpt2
    tm = _tgpt2(arrays)
    ids = _ids(seed=4)
    mask = _padding([T, 9]) if masked else None
    ref = jm(jtensor.from_numpy(ids),
             None if mask is None else jtensor.from_numpy(mask))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids),
                 None if mask is None else torch.from_numpy(mask))
    assert out.shape == (B, T, 256) and out.dtype == torch.float32
    _close(out.numpy(), ref.data)


def _sgd(m):
    return m.SGD(lr=0.05, momentum=0.9)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_gpt2_ten_step_losses_match(gpt2, fused):
    _, arrays = gpt2
    ids = _ids(seed=5)
    jm = jtr.GPT2(jtr.GPT2Config.tiny())
    jm.cfg.fused_loss = fused
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    for n, t in jm.get_params().items():
        t.copy_from(arrays[n])
    jm.set_optimizer(_sgd(jopt))
    x = jtensor.from_numpy(ids)
    jm.compile([x], is_train=True, use_graph=True)
    jl = [float(np.asarray(jm.train_step(x)[1].data)) for _ in range(STEPS)]

    tm = _tgpt2(arrays, fused_loss=fused)
    tm.set_optimizer(_sgd(topt))
    tm.compile([ids], is_train=True, use_graph=True)
    tl = [tm.train_step(ids)[1].item() for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]


def test_gpt2_greedy_generate_is_the_reference(gpt2):
    jm, arrays = gpt2
    tm = _tgpt2(arrays)
    prompt = _ids((B, 8), seed=6)
    ref = jm.generate(prompt, max_new_tokens=8)
    for use_graph in (True, False):
        out = tm.generate(prompt, max_new_tokens=8, use_graph=use_graph)
        assert out.dtype == np.int32 and out.shape == (B, 16)
        np.testing.assert_array_equal(out, ref)


def test_gpt2_forward_cached_position_forms_agree(gpt2):
    """The prompt at int 0, then one step at an int, a 0-d and a (B,)
    position (the engine's decode): the same logits and caches."""
    _, arrays = gpt2
    tm = _tgpt2(arrays)
    ids = torch.from_numpy(_ids((B, 9), seed=7))
    outs = []
    with torch.no_grad():
        for pos in (8, torch.tensor(8), torch.tensor([8, 8])):
            _, caches = tm.forward_cached(ids[:, :8], tm.init_caches(B, 12), 0)
            outs.append(tm.forward_cached(ids[:, 8:], caches, pos))
        full = tm(ids)
    for lg, caches in outs:
        torch.testing.assert_close(lg, outs[0][0], rtol=0, atol=1e-6)
        for (k, v), (k0, v0) in zip(caches, outs[0][1]):
            assert torch.equal(k, k0) and torch.equal(v, v0)
        torch.testing.assert_close(lg[:, 0], full[:, 8], rtol=1e-5,
                                   atol=1e-6)


def test_gpt2_engine_streams_equal_generate(gpt2):
    """The engine is model-generic: GPT-2's learned positions (per-row
    position grids in forward_cached) serve as the reference's test
    (tests/test_serve.py) holds them."""
    _, arrays = gpt2
    tm = _tgpt2(arrays)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32) for n in (4, 6, 9)]
    refs = [tm.generate(p[None], max_new_tokens=6)[0, p.size:]
            for p in prompts]
    eng = ServeEngine(tm, num_slots=2, max_len=24, block_size=8)
    hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_idle()
    for ref, h in zip(refs, hs):
        np.testing.assert_array_equal(ref, np.asarray(h.tokens))
    assert eng.compiled_counts() == (1, 1)


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu", "relu"])
def test_mlp_activations_match_reference(act):
    x = np.random.RandomState(2).randn(B, T, 32).astype(np.float32)
    jtensor.set_seed(4)
    jm = jtr._MLP(64, act)
    ref = np.asarray(jm(jtensor.Tensor(data=x, requires_grad=False)).data)
    tm = ttr._MLP(64, 32, act, device=CPU)
    load_reference_params(tm, _arrays(jm))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)).numpy(), ref)
    with pytest.raises(ValueError, match="act"):
        ttr._MLP(64, 32, "swish", device=CPU)


@pytest.mark.parametrize("field,value,what", [
    ("remat", True, "Remat"), ("pipeline_stages", 2, "PipelineStack")])
def test_gpt2_unported_options_raise(field, value, what):
    """No option is ignored: each builds the layer it needs, ported
    since: remat a Remat around every block, pipeline stages a
    PipelineStack of the blocks."""
    cfg = dataclasses.replace(GPT2Config.tiny(), **{field: value})
    m = GPT2(cfg, device=CPU)
    if field == "remat":
        assert all(type(b).__name__ == what for b in m.blocks)
        return
    assert type(m.blocks).__name__ == what and m.blocks.stages == value


# -- BERT ------------------------------------------------------------------------

def test_bert_names_shapes_and_flops_are_the_reference(bert):
    jm, arrays = bert
    tm = _tbert(arrays, num_labels=3)
    tp = tm.get_params()
    assert list(tp) == list(arrays)
    assert all(tuple(tp[n].shape) == arrays[n].shape for n in arrays)
    for seq in (16, 128):
        assert tm.flops_per_token(seq) == jm.flops_per_token(seq)
    assert dataclasses.asdict(BERTConfig()) == \
        dataclasses.asdict(jtr.BERTConfig())
    assert dataclasses.asdict(BERTConfig.tiny(2)) == \
        dataclasses.asdict(jtr.BERTConfig.tiny(2))


def test_bert_hidden_and_pooled_match(bert):
    """No classifier: (x, pooled), with token types and a padding mask."""
    _, arrays = bert
    jm = jtr.BERT(jtr.BERTConfig.tiny())
    ids, tt = _ids(seed=8), _ids(seed=9, vocab=2)
    mask = _padding([T, 11])
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    for n, t in jm.get_params().items():
        t.copy_from(arrays[n])
    tm = _tbert(arrays)
    assert tm.classifier is None
    for tt_, m_ in ((tt, mask), (None, None)):
        jx, jp = jm(jtensor.from_numpy(ids),
                    None if tt_ is None else jtensor.from_numpy(tt_),
                    None if m_ is None else jtensor.from_numpy(m_))
        with torch.no_grad():
            tx, tp = tm(torch.from_numpy(ids),
                        None if tt_ is None else torch.from_numpy(tt_),
                        None if m_ is None else torch.from_numpy(m_))
        assert tx.shape == (B, T, 64) and tp.shape == (B, 64)
        _close(tx.numpy(), jx.data)
        _close(tp.numpy(), jp.data)


def test_bert_ten_step_classifier_losses_match(bert):
    _, arrays = bert
    ids = _ids(seed=10)
    y = np.array([0, 2], np.int32)
    jm = jtr.BERT(jtr.BERTConfig.tiny(num_labels=3))
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    for n, t in jm.get_params().items():
        t.copy_from(arrays[n])
    jm.set_optimizer(_sgd(jopt))
    x, jy = jtensor.from_numpy(ids), jtensor.from_numpy(y)
    jm.compile([x], is_train=True, use_graph=True)
    jl = [float(np.asarray(jm.train_step(x, jy)[1].data))
          for _ in range(STEPS)]

    tm = _tbert(arrays, num_labels=3)
    tm.set_optimizer(_sgd(topt))
    tm.compile([ids], is_train=True, use_graph=True)
    tl = []
    for _ in range(STEPS):
        out, loss = tm.train_step(ids, y)
        assert out.shape == (B, 3)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]


def test_bert_without_a_classifier_refuses_to_train(bert):
    tm = _tbert(bert[1])
    tm.set_optimizer(_sgd(topt))
    with pytest.raises(RuntimeError, match="num_labels"):
        tm.train_one_batch(_ids(), np.zeros(B, np.int32))


def test_bert_base_parameter_count_is_the_reference():
    """MFU divides by flops_per_token, which counts the parameters: at
    BERT-base's widths the two packages count alike (one block built,
    the rest by multiplication, as the reference's sum is linear)."""
    c = BERTConfig(num_labels=2, num_layers=1)
    tm = BERT(c, device=CPU)
    jm = jtr.BERT(jtr.BERTConfig(num_labels=2, num_layers=1))
    jm.compile([jtensor.from_numpy(_ids((1, 4)))], is_train=False,
               use_graph=False)
    assert tm.flops_per_token(128) == jm.flops_per_token(128)
    n = sum(p.numel() for p in tm.get_params().values())
    n_block = sum(p.numel() for k, p in tm.get_params().items()
                  if k.startswith("blocks."))
    assert n + 11 * n_block == 109_483_778
