"""The port's generate_beam (singa_tpu_torch/models/_generate.py,
`_BeamSession`) against the JAX package's, on the CPU:
LlamaConfig.tiny() in f32 with the reference's weights carried over
through `load_reference_params`, two prompts of 8 tokens, 6 new.

Sequences must equal the reference's and scores agree within 1e-5 for
num_beams 1, 2 and 4, with and without eos_id, at length_penalty 0.5 and
1.0; the session's path equals the eager one bitwise; num_beams=1 is
greedy generate(); the reported score is the returned sequence's
log-probability under a teacher-forced forward; beam sessions share
generate()'s MAX_SESSIONS cap.  GPT2Config.tiny() (learned positions,
its own forward_cached) goes through the same search and is held to
the reference's the same way."""

import numpy as np
import pytest
import torch

from singa_tpu import models as jmodels
from singa_tpu import tensor as jtensor
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.models import (GPT2, GPT2Config, Llama, LlamaConfig,
                                    _generate, load_reference_params)

N = 6
#: |score - reference score| for the returned hypothesis (f32 sums of
#: six log-softmax terms, each computed by each package's own kernels)
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model with the same weights, prompt (2, 8), an
    eos id greedy decoding emits)."""
    jtensor.set_seed(0)
    cfg = jmodels.LlamaConfig.tiny()
    jm = jmodels.Llama(cfg)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                              (2, 8)).astype(np.int32)
    jm.compile([jtensor.from_numpy(prompt)], is_train=False, use_graph=True)
    jm.eval()
    tm = Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"))
    load_reference_params(tm, {n: np.asarray(t.data)
                               for n, t in jm.get_params().items()})
    eos = int(tm.generate(prompt, max_new_tokens=N)[0, 10])
    return jm, tm, prompt, eos


@pytest.mark.parametrize("length_penalty", [0.5, 1.0])
@pytest.mark.parametrize("with_eos", [False, True], ids=["no_eos", "eos"])
@pytest.mark.parametrize("num_beams", [1, 2, 4])
def test_beam_equals_the_reference(pair, num_beams, with_eos,
                                   length_penalty):
    jm, tm, prompt, eos = pair
    _beam_is_the_reference(jm, tm, prompt, num_beams=num_beams,
                           eos_id=eos if with_eos else None,
                           length_penalty=length_penalty)


def _beam_is_the_reference(jm, tm, prompt, **kw):
    """The port's sequences equal the reference's, its scores within
    SCORE_TOL, and its captured search equals its eager one bitwise."""
    kw.update(max_new_tokens=N, return_scores=True)
    want, wscore = jm.generate_beam(prompt, **kw)
    got, score = tm.generate_beam(prompt, **kw)
    eager, escore = tm.generate_beam(prompt, use_graph=False, **kw)
    assert got.dtype == np.int32 and got.shape == (2, 8 + N)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(score, np.asarray(wscore), rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(eager, got)
    np.testing.assert_array_equal(escore, score)


@pytest.fixture(scope="module")
def gpt2_pair():
    """(reference GPT-2 tiny, the port's with its weights, prompt (2, 8))."""
    jtensor.set_seed(0)
    jm = jmodels.GPT2(jmodels.GPT2Config.tiny())
    prompt = np.random.RandomState(1).randint(
        0, jm.cfg.vocab_size, (2, 8)).astype(np.int32)
    jm.compile([jtensor.from_numpy(prompt)], is_train=False, use_graph=True)
    jm.eval()
    tm = GPT2(GPT2Config.tiny(), device=tdevice.create_device("cpu"))
    load_reference_params(tm, {n: np.asarray(t.data)
                               for n, t in jm.get_params().items()})
    return jm, tm, prompt


@pytest.mark.parametrize("num_beams", [2, 4])
def test_gpt2_beam_equals_the_reference(gpt2_pair, num_beams):
    _beam_is_the_reference(*gpt2_pair, num_beams=num_beams)


def test_one_beam_is_greedy_generate(pair):
    _, tm, prompt, _ = pair
    np.testing.assert_array_equal(
        tm.generate_beam(prompt, max_new_tokens=N, num_beams=1),
        tm.generate(prompt, max_new_tokens=N))


def test_reported_score_is_the_sequence_logprob(pair):
    """The score of the returned hypothesis equals the sum of its chosen
    tokens' log-softmax under one teacher-forced forward."""
    _, tm, prompt, _ = pair
    out, score = tm.generate_beam(prompt, max_new_tokens=N, num_beams=4,
                                  return_scores=True)
    with torch.no_grad():
        lg = tm(torch.as_tensor(out[:, :-1], dtype=torch.int64)).float()
    lp = torch.log_softmax(lg, dim=-1)
    tgt = torch.as_tensor(out[:, 1:], dtype=torch.int64)
    take = lp.gather(2, tgt[:, :, None])[:, :, 0][:, 8 - 1:].sum(1)
    np.testing.assert_allclose(take.numpy(), score, rtol=1e-4, atol=1e-4)


def test_beam_sessions_share_the_session_cap(pair):
    _, tm, prompt, eos = pair
    tm._gen_sessions.clear()
    tm.generate_beam(prompt, max_new_tokens=N, num_beams=2)
    tm.generate_beam(prompt, max_new_tokens=N, num_beams=2)
    assert len(tm._gen_sessions) == 1
    sess = next(iter(tm._gen_sessions.values()))
    assert isinstance(sess, _generate._BeamSession) and sess.calls == 2
    for p in range(3, 3 + _generate.MAX_SESSIONS):
        tm.generate(prompt[:, :p], max_new_tokens=2)
    assert len(tm._gen_sessions) == _generate.MAX_SESSIONS
    assert sess not in tm._gen_sessions.values()
    tm._gen_sessions.clear()
    tm.generate_beam(prompt, max_new_tokens=N, num_beams=3, use_graph=False)
    assert not tm._gen_sessions


def test_bad_num_beams_raises(pair):
    _, tm, prompt, _ = pair
    with pytest.raises(ValueError, match="num_beams"):
        tm.generate_beam(prompt, max_new_tokens=2, num_beams=0)
