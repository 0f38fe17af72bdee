"""The port's sliding-window (banded) attention against the JAX
package's, on the CPU: `pick_band_chunk`, `banded_sdpa`, `BandedSDPA`,
the plain flash path with a window, and LlamaConfig.tiny() with
`sliding_window=8` in f32 with the reference's weights carried over by
`load_reference_params`, through training, `generate()` and the paged
ServeEngine with prompts longer than the window.

Tolerances (both sides f32, differing in op order only):
  * attention outputs and their gradients: atol 1e-5;
  * the model's logits: atol 1e-4; its gradients rtol 1e-4, atol 1e-6;
  * ten SGD steps: every loss within rtol 1e-4;
  * greedy token streams: identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import transformer as jtr
from singa_tpu.ops import attention as jattn
from singa_tpu.serve import ServeEngine as JEngine
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch.models import Llama, LlamaConfig, load_reference_params
from singa_tpu_torch.models import transformer as ttr
from singa_tpu_torch.ops import attention as tattn
from singa_tpu_torch.ops import flash_attention as tfa
from singa_tpu_torch.serve import ServeEngine

W = 8
B, T = 2, 24
STEPS = 10
SLOTS, MAX_LEN, BS = 4, 32, 8
FAST = dict(backoff_base=0.001, backoff_max=0.01)


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)
    jautograd.set_training(False)


def _qkv(b, t, h, k, d, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, t, n, d) * 0.5).astype(np.float32)
            for n in (h, k, k)]


def _cfgs():
    return (dataclasses.replace(jmodels.LlamaConfig.tiny(), sliding_window=W),
            dataclasses.replace(LlamaConfig.tiny(), sliding_window=W))


@pytest.fixture(scope="module")
def ids():
    return np.random.RandomState(3).randint(0, 256, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_arrays(ids):
    """The reference windowed tiny Llama's initial parameters, by name."""
    jtensor.set_seed(0)
    jm = jmodels.Llama(_cfgs()[0])
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    return {n: np.asarray(t.data) for n, t in jm.get_params().items()}


def _jmodel(ref_arrays, ids, **kw):
    jm = jmodels.Llama(dataclasses.replace(_cfgs()[0], **kw))
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    for n, t in jm.get_params().items():
        t.data = jnp.asarray(ref_arrays[n])
    return jm


def _tmodel(ref_arrays, **kw):
    tm = Llama(dataclasses.replace(_cfgs()[1], **kw),
               device=tdevice.create_device("cpu"))
    load_reference_params(tm, ref_arrays)
    return tm


# -- the attention ops ----------------------------------------------------------

@pytest.mark.parametrize("T_", [1, 7, 8, 16, 24, 64, 97, 128, 600, 1024])
@pytest.mark.parametrize("W_", [1, 4, 8, 16, 200, 4096])
def test_pick_band_chunk_matches_reference(T_, W_):
    assert tattn.pick_band_chunk(T_, W_) == jattn.pick_band_chunk(T_, W_)


@pytest.mark.parametrize("shape,window,chunk", [
    ((2, 32, 4, 2, 16), 8, None),
    ((1, 48, 4, 4, 8), 5, 12),
    ((1, 24, 2, 1, 8), 30, 8),
])
def test_banded_sdpa_forward_and_gradients_match_reference(shape, window,
                                                           chunk):
    b, t, h, k, d = shape
    q, kk, v = _qkv(b, t, h, k, d, seed=t + window)
    do = np.random.RandomState(1).randn(b, t, h, d).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda *a: jattn.banded_sdpa(*a, window, None, chunk),
        *map(jnp.asarray, (q, kk, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, kk, v))
    out = tattn.banded_sdpa(tq, tk, tv, window, None, chunk)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    tgrads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)


@pytest.mark.parametrize("t,chunk", [(32, None), (14, None), (24, 6)])
def test_banded_sdpa_op_routes_as_the_reference(t, chunk):
    """BandedSDPA off the card: chunked, or the full band mask when only
    a degenerate chunk divides T (T = 14)."""
    q, kk, v = _qkv(1, t, 4, 2, 8, seed=t)
    ref = jattn.BandedSDPA(W, None, chunk).fwd(*map(jnp.asarray, (q, kk, v)))
    out = tattn.banded_attention(*map(torch.from_numpy, (q, kk, v)), W,
                                 chunk=chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_plain_flash_with_a_window_equals_banded_sdpa():
    """The flash wrapper's plain version (what runs off the card) with a
    window against the chunked path, outputs and gradients."""
    q, kk, v = _qkv(1, 256, 4, 2, 32, seed=11)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, kk, v))
    a = tfa.flash_attention(tq, tk, tv, causal=True, window=40)
    b = tattn.banded_sdpa(tq, tk, tv, 40)
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               atol=1e-5)
    do = torch.randn(a.shape, generator=torch.Generator().manual_seed(0))
    for ga, gb in zip(torch.autograd.grad(a, (tq, tk, tv), do),
                      torch.autograd.grad(b, (tq, tk, tv), do)):
        np.testing.assert_allclose(ga.numpy(), gb.numpy(), atol=1e-5)


# -- the windowed tiny Llama ----------------------------------------------------

def test_logits_and_gradients_match_reference(ref_arrays, ids):
    jm = _jmodel(ref_arrays, ids)
    x = jtensor.from_numpy(ids)
    jm.train(True)
    jlogits = jm.forward(x)
    ref_logits = np.asarray(jlogits.data)
    jloss = jtr.next_token_loss(jlogits, x)
    names = {id(t): n for n, t in jm.get_params().items()}
    jgrads = {names[id(p)]: np.asarray(g.data)
              for p, g in jautograd.backward(jloss)}

    tm = _tmodel(ref_arrays)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(ids)).numpy(),
                                   ref_logits, atol=1e-4)
    tm.train(True)
    tloss = ttr.next_token_loss(tm(torch.from_numpy(ids)),
                                torch.from_numpy(ids))
    tgrads = {p.param_name: g.numpy() for p, g in tautograd.backward(tloss)}
    np.testing.assert_allclose(tloss.item(), float(jloss.data), rtol=1e-6)
    assert sorted(tgrads) == sorted(jgrads)
    for n, g in jgrads.items():
        np.testing.assert_allclose(tgrads[n], g, rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def test_sgd_trajectory_matches_reference(ref_arrays, ids):
    jm = _jmodel(ref_arrays, ids, fused_loss=True)
    jm.set_optimizer(jopt.SGD(lr=0.05, momentum=0.9))
    x = jtensor.from_numpy(ids)
    jm.compile([x], is_train=True, use_graph=True)
    jlosses = [float(np.asarray(jm.train_step(x)[1].data))
               for _ in range(STEPS)]
    tm = _tmodel(ref_arrays, fused_loss=True)
    tm.set_optimizer(topt.SGD(lr=0.05, momentum=0.9))
    tm.compile([ids], is_train=True, use_graph=True)
    tlosses = [tm.train_step(ids)[1].item() for _ in range(STEPS)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]


def test_flops_per_token_has_the_window_term(ref_arrays, ids):
    jm, tm = _jmodel(ref_arrays, ids), _tmodel(ref_arrays)
    for t in (4, W, 64):
        assert tm.flops_per_token(t) == jm.flops_per_token(t)
    assert tm.flops_per_token(64) == tm.flops_per_token(W)


@pytest.fixture(scope="module")
def serving(ref_arrays, ids):
    """(JAX model, port model, JAX engine, port engine) with the
    reference's weights, eval mode."""
    jm = _jmodel(ref_arrays, ids)
    jm.eval()
    tm = _tmodel(ref_arrays)
    return (jm, tm, JEngine(jm, SLOTS, MAX_LEN, block_size=BS, **FAST),
            ServeEngine(tm, SLOTS, MAX_LEN, block_size=BS, **FAST))


def _prompts(lens, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (n,)).astype(np.int32) for n in lens]


def test_greedy_generate_past_the_window_matches_reference(serving):
    jm, tm, _, _ = serving
    prompt = np.stack(_prompts((20, 20)))
    ref = jm.generate(prompt, max_new_tokens=8)
    for use_graph in (True, False):
        np.testing.assert_array_equal(
            tm.generate(prompt, max_new_tokens=8, use_graph=use_graph), ref)


def test_engine_streams_past_the_window_match_reference_and_generate(
        serving):
    jm, tm, je, te = serving
    prompts = _prompts((12, 20, 9, 17, 3))
    n = 8
    jh = [je.submit(p, max_new_tokens=n) for p in prompts]
    je.run_until_idle()
    th = [te.submit(p, max_new_tokens=n) for p in prompts]
    te.run_until_idle()
    got = [list(map(int, h.tokens)) for h in th]
    assert got == [list(map(int, h.tokens)) for h in jh]
    assert got == [list(map(int, tm.generate(p[None], max_new_tokens=n)
                            [0, p.size:])) for p in prompts]
    assert te.compiled_counts() == (1, 1)
