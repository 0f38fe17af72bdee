"""The port's Llama (singa_tpu_torch.models.llama) against the JAX
package's, on the CPU: LlamaConfig.tiny() in f32 with the reference's
weights carried over through `load_reference_params`.

Tolerance 1e-5 on logits: both sides compute in f32 and differ only in
op order and elementwise implementations.  Greedy token streams must be
identical."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import models as jmodels
from singa_tpu import tensor as jtensor
from singa_tpu.models import _generate as jgen
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.models import Llama, LlamaConfig, load_reference_params
from singa_tpu_torch.models import _generate as tgen

ATOL = 1e-5
P, N = 8, 6


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model with the same weights, prompt (2, P))."""
    prompt = np.random.RandomState(1).randint(0, 256, (2, P)).astype(np.int32)
    jtensor.set_seed(0)
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.compile([jtensor.from_numpy(prompt)], is_train=False, use_graph=False)
    tm = Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"))
    load_reference_params(tm, {n: np.asarray(t.data)
                               for n, t in jm.get_params().items()})
    return jm, tm, prompt


def _jparams(jm):
    return {n: t.data for n, t in jm.get_params().items()}


def _jbuffers(jm):
    return {n: t.data for n, t in jm._get_buffers().items()}


def test_forward_logits_match(pair):
    jm, tm, prompt = pair
    ref = np.asarray(jm(jtensor.from_numpy(prompt)).data)
    with torch.no_grad():
        out = tm(torch.from_numpy(prompt)).numpy()
    assert out.shape == (2, P, 256)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_forward_cached_prefill_and_decode_match(pair):
    jm, tm, prompt = pair
    S = P + 3
    jl, jc = jgen.prefill_step(jm, S, last_only=False)(
        _jparams(jm), _jbuffers(jm), jnp.asarray(prompt))
    with torch.no_grad():
        tl, tc = tgen.prefill_step(tm, S, last_only=False)(
            torch.from_numpy(prompt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        jdec, tdec = jgen.decode_step(jm), tgen.decode_step(tm)
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        for i in range(2):
            jl, jc = jdec(_jparams(jm), _jbuffers(jm), jnp.asarray(tok),
                          jnp.asarray(P + i, jnp.int32), jc)
            tl, tc = tdec(torch.from_numpy(tok), P + i, tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
            tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_forward_cached_vector_pos_matches_scalar(pair):
    _, tm, prompt = pair
    with torch.no_grad():
        _, caches = tgen.prefill_step(tm, P + 1)(torch.from_numpy(prompt))
        tok = torch.tensor([[3], [9]], dtype=torch.int32)
        a, _ = tgen.decode_step(tm)(tok, P, [(k.clone(), v.clone())
                                            for k, v in caches])
        b, _ = tgen.decode_step(tm)(tok, torch.tensor([P, P]), caches)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_greedy_generate_token_identical(pair):
    jm, tm, prompt = pair
    ref = jm.generate(prompt, max_new_tokens=N)
    out = tm.generate(prompt, max_new_tokens=N)
    assert out.dtype == np.int32 and out.shape == (2, P + N)
    np.testing.assert_array_equal(out, ref)


def test_greedy_generate_eos_matches(pair):
    jm, tm, prompt = pair
    first = jm.generate(prompt, max_new_tokens=N)
    for eos in (int(first[0, P]), int(first[1, P + 1])):
        np.testing.assert_array_equal(
            tm.generate(prompt, max_new_tokens=N, eos_id=eos),
            jm.generate(prompt, max_new_tokens=N, eos_id=eos))


def test_sampled_generation_deterministic_within_port(pair):
    _, tm, prompt = pair
    kw = dict(max_new_tokens=N, temperature=0.9, top_k=40, top_p=0.9)
    a = tm.generate(prompt, seed=7, **kw)
    b = tm.generate(prompt, seed=7, **kw)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[:, :P], prompt)
    draws = {tm.generate(prompt, seed=s, **kw).tobytes() for s in range(4)}
    assert len(draws) > 1, "the seed must reach the sampler"


def test_top_k_one_is_greedy(pair):
    _, tm, prompt = pair
    np.testing.assert_array_equal(
        tm.generate(prompt, max_new_tokens=N, temperature=1.3, top_k=1),
        tm.generate(prompt, max_new_tokens=N))


def test_max_position_overflow_raises(pair):
    _, tm, _ = pair
    with pytest.raises(ValueError, match="max_position"):
        tm.generate(np.zeros((1, 120), np.int32), max_new_tokens=10)


def test_param_dtype_bf16_casts_once_and_restores(pair):
    _, tm, prompt = pair
    a = tm.generate(prompt, max_new_tokens=N, param_dtype=torch.bfloat16)
    b = tm.generate(prompt, max_new_tokens=N, param_dtype=torch.bfloat16)
    np.testing.assert_array_equal(a, b)
    assert all(p.dtype == torch.float32 for p in tm.get_params().values())
    with tgen._bound(tm, {n: p.to(torch.bfloat16)
                          for n, p in tm.get_params().items()}):
        assert tm.init_caches(1, 4)[0][0].dtype == torch.bfloat16
    assert tm.init_caches(1, 4)[0][0].dtype == torch.float32


def test_param_names_shapes_and_counts_match(pair):
    jm, tm, _ = pair
    jp, tp = jm.get_params(), tm.get_params()
    assert list(tp) == list(jp)
    assert all(tuple(tp[n].shape) == tuple(jp[n].shape) for n in jp)
    assert tm.num_params() == jm.num_params()
    assert tm.flops_per_token(64) == jm.flops_per_token(64)


def test_load_reference_params_rejects_mismatches(pair):
    jm, tm, _ = pair
    arrays = {n: np.asarray(t.data) for n, t in jm.get_params().items()}
    with pytest.raises(KeyError, match="missing"):
        load_reference_params(tm, {k: v for k, v in arrays.items()
                                   if k != "norm_f.gamma"})
    with pytest.raises(KeyError, match="extra"):
        load_reference_params(tm, {**arrays, "bogus.W": arrays["lm_head.W"]})
    with pytest.raises(ValueError, match="lm_head.W"):
        load_reference_params(tm, {**arrays, "lm_head.W": arrays["lm_head.W"].T})


@pytest.mark.parametrize("field,value", [("sliding_window", 16),
                                         ("num_experts", 4),
                                         ("pipeline_stages", 2)])
def test_later_slice_options_raise(field, value):
    cfg = dataclasses.replace(LlamaConfig.tiny(), **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        Llama(cfg)


def test_presets_match_the_reference():
    for name in ("tiny", "serve_bench", "small", "base", "llama3_8b"):
        assert dataclasses.asdict(getattr(LlamaConfig, name)()) == \
            dataclasses.asdict(getattr(jmodels.LlamaConfig, name)())


def test_seeded_init_is_reproducible():
    dev = tdevice.create_device("cpu")
    a = Llama(LlamaConfig.tiny(), device=dev,
              generator=torch.Generator().manual_seed(5))
    b = Llama(LlamaConfig.tiny(), device=dev,
              generator=torch.Generator().manual_seed(5))
    for (n, p), q in zip(a.get_params().items(), b.get_params().values()):
        assert torch.equal(p, q), n
    assert a.get_params()["tok_emb.table"].dtype == torch.float32
