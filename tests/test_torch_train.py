"""The port's training path (singa_tpu_torch autograd, opt, model,
Llama.train_one_batch) against the JAX package's, on the CPU:
LlamaConfig.tiny() in f32 with the reference's weights carried over by
`load_reference_params`, on the same numpy-seeded token batch.

Tolerances (both sides f32; they differ in op order and elementwise
implementations only):
  * one backward: loss within 1e-6 relative, each parameter's gradient
    within rtol 1e-4, atol 1e-6;
  * ten train_steps: every step's loss within rtol 1e-5 and the final
    parameters within rtol 1e-4, atol 1e-5 (rounding grows with the
    number of updates);
  * optimizer updates on the same arrays: rtol 1e-6, atol 1e-7."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import transformer as jtr
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch.models import Llama, LlamaConfig, load_reference_params
from singa_tpu_torch.models import transformer as ttr

B, T = 2, 16
STEPS = 10


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)
    jautograd.set_training(False)


@pytest.fixture(scope="module")
def ids():
    return np.random.RandomState(3).randint(0, 256, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_arrays(ids):
    """The reference tiny Llama's initial parameters, by name."""
    jtensor.set_seed(0)
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    return {n: np.asarray(t.data) for n, t in jm.get_params().items()}


def _cfg(**kw):
    return dataclasses.replace(LlamaConfig.tiny(), **kw)


def _jmodel(ref_arrays, ids, **kw):
    jm = jmodels.Llama(dataclasses.replace(jmodels.LlamaConfig.tiny(), **kw))
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    for n, t in jm.get_params().items():
        t.data = jnp.asarray(ref_arrays[n])
    return jm


def _tmodel(ref_arrays, **kw):
    tm = Llama(_cfg(**kw), device=tdevice.create_device("cpu"))
    load_reference_params(tm, ref_arrays)
    return tm


def _port_loss(tm, ids, fused):
    x = torch.from_numpy(ids)
    if fused:
        return ttr.next_token_loss_fused(tm.features(x), tm.lm_head, x)
    return ttr.next_token_loss(tm(x), x)


# -- one backward ---------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_gradients_match_reference_backward(ref_arrays, ids, fused):
    jm = _jmodel(ref_arrays, ids)
    jm.train(True)
    x = jtensor.from_numpy(ids)
    if fused:
        jloss = jtr.next_token_loss_fused(jm.features(x), jm.lm_head, x)
    else:
        jloss = jtr.next_token_loss(jm.forward(x), x)
    names = {id(t): n for n, t in jm.get_params().items()}
    jgrads = {names[id(p)]: np.asarray(g.data)
              for p, g in jautograd.backward(jloss)}

    tm = _tmodel(ref_arrays)
    tm.train(True)
    tloss = _port_loss(tm, ids, fused)
    tgrads = {p.param_name: g.numpy() for p, g in tautograd.backward(tloss)}

    np.testing.assert_allclose(tloss.item(), float(jloss.data), rtol=1e-6)
    assert sorted(tgrads) == sorted(jgrads) == sorted(ref_arrays)
    for n, g in jgrads.items():
        assert tgrads[n].dtype == np.float32
        np.testing.assert_allclose(tgrads[n], g, rtol=1e-4, atol=1e-6,
                                   err_msg=n)


# -- ten steps through the step executor -------------------------------------

_OPTS = {
    "sgd_momentum": (lambda m: m.SGD(lr=0.05, momentum=0.9)),
    "adamw": (lambda m: m.AdamW(lr=3e-3, weight_decay=0.01)),
}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("optname", list(_OPTS))
def test_train_step_trajectory_matches_reference(ref_arrays, ids, fused,
                                                 optname):
    jm = _jmodel(ref_arrays, ids, fused_loss=fused)
    jm.set_optimizer(_OPTS[optname](jopt))
    x = jtensor.from_numpy(ids)
    jm.compile([x], is_train=True, use_graph=True)
    jlosses = [float(np.asarray(jm.train_step(x)[1].data))
               for _ in range(STEPS)]

    tm = _tmodel(ref_arrays, fused_loss=fused)
    tm.set_optimizer(_OPTS[optname](topt))
    tm.compile([ids], is_train=True, use_graph=True)
    tlosses = []
    for _ in range(STEPS):
        out, loss = tm.train_step(ids)
        assert not loss.requires_grad
        tlosses.append(loss.item())

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    assert tm.optimizer.step_counter == STEPS == jm.optimizer.step_counter
    jp = jm.get_params()
    for n, p in tm.get_params().items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n].data),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


# -- inside the port -------------------------------------------------------------

def test_remat_gives_the_same_loss_gradients_and_param_keys(ref_arrays, ids):
    results = []
    for remat in (False, True):
        tm = _tmodel(ref_arrays, remat=remat, fused_loss=True)
        tm.train(True)
        loss = _port_loss(tm, ids, fused=True)
        grads = {p.param_name: g for p, g in tautograd.backward(loss)}
        results.append((tm, loss, grads))
    (m0, l0, g0), (m1, l1, g1) = results
    assert list(m0.get_params()) == list(m1.get_params())
    assert torch.equal(l0, l1)
    assert sorted(g0) == sorted(g1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0)


def test_remat_runs_each_block_under_checkpoint(ref_arrays, ids, monkeypatch):
    from singa_tpu_torch.models import llama as tllama
    calls = []
    real = tllama.checkpoint

    def spy(fn, *a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *a, **kw)
    monkeypatch.setattr(tllama, "checkpoint", spy)
    tm = _tmodel(ref_arrays, remat=True)
    x = torch.from_numpy(ids)
    tm.features(x)                       # eval: no checkpointing
    assert calls == []
    tm.train(True)
    tm.features(x)
    assert calls == [False] * tm.cfg.num_layers


def test_fused_and_unfused_losses_agree(ref_arrays, ids):
    tm = _tmodel(ref_arrays)
    tm.train(True)
    a = _port_loss(tm, ids, fused=False)
    ga = {p.param_name: g for p, g in tautograd.backward(a)}
    b = _port_loss(tm, ids, fused=True)
    gb = {p.param_name: g for p, g in tautograd.backward(b)}
    torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)
    for n in ga:
        torch.testing.assert_close(gb[n], ga[n], rtol=1e-4, atol=1e-7)


def test_fused_loss_chunks_agree_with_one_chunk():
    g = torch.Generator().manual_seed(0)
    h = torch.randn(37, 8, generator=g, requires_grad=True)
    w = torch.randn(8, 11, generator=g, requires_grad=True)
    tgt = torch.randint(0, 11, (37,), generator=g)
    res = []
    for chunk in (5, 64):
        loss = tautograd.fused_linear_cross_entropy(h, w, tgt, chunk)
        res.append((loss, *torch.autograd.grad(loss, (h, w))))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    ref = tautograd.softmax_cross_entropy(h @ w, tgt)
    torch.testing.assert_close(res[0][0], ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_out_of_range_targets_give_zero_loss_and_gradient(fused):
    g = torch.Generator().manual_seed(1)
    h = torch.randn(6, 8, generator=g, requires_grad=True)
    w = torch.randn(8, 5, generator=g, requires_grad=True)
    tgt = torch.tensor([1, -1, 4, 5, 0, -3])
    valid = torch.tensor([True, False, True, False, True, False])
    if fused:
        loss = tautograd.fused_linear_cross_entropy(h, w, tgt, 4)
    else:
        loss = tautograd.softmax_cross_entropy(h @ w, tgt)
    dh, = torch.autograd.grad(loss, h)
    assert torch.all(dh[~valid] == 0) and torch.all(dh[valid] != 0)
    # the invalid rows add nothing, but still count in the mean
    kept = tautograd.softmax_cross_entropy((h @ w)[valid], tgt[valid])
    torch.testing.assert_close(loss, kept * 3 / 6)


def test_softmax_cross_entropy_matches_reference_and_takes_probs():
    rng = np.random.RandomState(2)
    logits = rng.randn(4, 3, 7).astype(np.float32)
    tgt = rng.randint(-1, 8, (4, 3)).astype(np.int32)
    probs = rng.dirichlet(np.ones(7), (4, 3)).astype(np.float32)
    for t in (tgt, probs):
        ref = jautograd.softmax_cross_entropy(
            jtensor.from_numpy(logits), jtensor.from_numpy(t))
        out = tautograd.softmax_cross_entropy(torch.from_numpy(logits),
                                              torch.from_numpy(t))
        np.testing.assert_allclose(out.item(), float(ref.data), rtol=1e-6)
    bf = tautograd.softmax_cross_entropy(
        torch.from_numpy(logits).bfloat16().requires_grad_(),
        torch.from_numpy(tgt))
    assert bf.dtype == torch.float32


def test_fused_loss_refuses_non_integer_targets():
    h = torch.zeros(4, 3)
    with pytest.raises(TypeError, match="integer class-id"):
        tautograd.fused_linear_cross_entropy(h, torch.zeros(3, 5),
                                             torch.zeros(4))


# -- optimizers ------------------------------------------------------------------

_APPLY = {
    "sgd": lambda m: m.SGD(lr=0.1),
    "sgd_momentum": lambda m: m.SGD(lr=0.1, momentum=0.9),
    "sgd_nesterov_wd_dampening": lambda m: m.SGD(
        lr=0.1, momentum=0.8, weight_decay=0.01, nesterov=True,
        dampening=0.1),
    "adam": lambda m: m.Adam(lr=1e-2, weight_decay=0.01),
    "adamw": lambda m: m.AdamW(lr=1e-2),
    "sgd_cosine": lambda m: m.SGD(lr=m.WarmupCosine(0.1, 2, 5),
                                  momentum=0.5),
}


@pytest.mark.parametrize("name", list(_APPLY))
def test_optimizer_update_matches_reference_apply(name):
    rng = np.random.RandomState(4)
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(4)]
    jo, to = _APPLY[name](jopt), _APPLY[name](topt)
    jp, jslot = jnp.asarray(p0), jo._init_slot(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy())
    tslot = to.init_slot(tp)
    for step, g in enumerate(grads):
        jp, jslot = jo.apply(step, "w", jp, jnp.asarray(g), jslot)
        tslot = to.apply(step, "w", tp, torch.from_numpy(g), tslot)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7, err_msg=f"step {step}")
    assert to.state_signature() == jo.state_signature()


@pytest.mark.parametrize("sched", [
    lambda m: m.Constant(0.3),
    lambda m: m.ExponentialDecay(0.1, 3, 0.5),
    lambda m: m.ExponentialDecay(0.1, 3, 0.5, staircase=True),
    lambda m: m.CosineDecay(0.1, 6, alpha=0.1),
    lambda m: m.WarmupCosine(0.1, 2, 8, min_lr=0.01),
    lambda m: m.MultiStepLR(0.1, [2, 5], gamma=0.5),
])
def test_schedules_match_reference(sched):
    js, ts = sched(jopt), sched(topt)
    for step in range(10):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


def test_optimizer_states_and_slots_round_trip():
    p = torch.nn.Parameter(torch.ones(3))
    p.param_name = "w"
    o = topt.Adam(lr=0.1)
    o.update(p, torch.full((3,), 0.5))
    o.step()
    assert o.get_states() == {"step": 1}
    slots = o.slot_arrays()
    assert list(slots) == ["w"] and len(slots["w"]) == 2
    o2 = topt.Adam(lr=0.1)
    o2.set_states(o.get_states())
    o2.load_slot_arrays(slots)
    assert o2.step_counter == 1
    assert all(torch.equal(a, b) for a, b in zip(o2._eager_state["w"],
                                                  o._eager_state["w"]))
    sgd = topt.SGD(lr=0.1)
    sgd.update(p, torch.ones(3))
    assert sgd.slot_arrays() == {"w": []}
    sgd.load_slot_arrays({"w": []})
    assert sgd._eager_state == {"w": None}


def test_backward_returns_param_grad_pairs_and_sets_grad(ref_arrays, ids):
    tm = _tmodel(ref_arrays)
    tm.train(True)
    loss = _port_loss(tm, ids, fused=True)
    pairs = tautograd.backward(loss)
    params = tm.get_params()
    assert len(pairs) == len(params)
    for p, g in pairs:
        assert p is params[p.param_name] and p.grad is g
        assert g.dtype == torch.float32 and g.shape == p.shape
    assert tautograd.backward(loss.detach()) == []


# -- the step executor -----------------------------------------------------------

def test_executor_keys_steps_and_slots(ref_arrays, ids):
    tm = _tmodel(ref_arrays, fused_loss=True)
    tm.set_optimizer(topt.SGD(lr=0.01, momentum=0.9))
    tm.compile([ids], is_train=True, use_graph=True)
    tm.train_step(ids)
    tm.train_step(ids)
    assert len(tm._executors) == 1
    assert tm.optimizer.step_counter == 2 and tm._step_count == 2
    ex = next(iter(tm._executors.values()))
    assert sorted(ex.slots) == sorted(tm.get_params())
    assert all(ex.slots[n] is s for n, s in tm.optimizer._eager_state.items())
    assert torch.count_nonzero(ex.slots["lm_head.W"]) > 0
    tm.train_step(ids[:, :8])                 # new shape: a new executor
    assert len(tm._executors) == 2 and tm.optimizer.step_counter == 3
    tm.eval()                                 # eval runs its own executor
    logits = tm(ids)
    assert logits.shape == (B, T, 256) and not logits.requires_grad
    assert len(tm._executors) == 3 and tm.optimizer.step_counter == 3
    assert {k[-1] for k in tm._executors} == {"train", "eval"}


def test_executor_refuses_restored_slots_that_do_not_fit(ref_arrays, ids):
    tm = _tmodel(ref_arrays, fused_loss=True)
    o = topt.SGD(lr=0.01, momentum=0.9)
    o._eager_state = {"lm_head.W": torch.zeros(3)}
    tm.set_optimizer(o)
    tm.compile([ids], is_train=True, use_graph=True)
    with pytest.raises(ValueError, match="does not fit"):
        tm.train_step(ids)


def test_executor_resumes_from_restored_slots(ref_arrays, ids):
    runs = []
    for resume in (False, True):
        tm = _tmodel(ref_arrays, fused_loss=True)
        tm.set_optimizer(topt.SGD(lr=0.05, momentum=0.9))
        tm.compile([ids], is_train=True, use_graph=True)
        losses = [tm.train_step(ids)[1].item() for _ in range(2)]
        if resume:
            states = tm.optimizer.get_states()
            slots = {n: [s.clone() for s in v]
                     for n, v in tm.optimizer.slot_arrays().items()}
            params = {n: p.detach().clone()
                      for n, p in tm.get_params().items()}
            tm = _tmodel(ref_arrays, fused_loss=True)
            with torch.no_grad():
                for n, p in tm.get_params().items():
                    p.copy_(params[n])
            tm.set_optimizer(topt.SGD(lr=0.05, momentum=0.9))
            tm.optimizer.set_states(states)
            tm.optimizer.load_slot_arrays(slots)
            tm.compile([ids], is_train=True, use_graph=True)
        losses += [tm.train_step(ids)[1].item() for _ in range(2)]
        runs.append(losses)
    assert runs[0] == runs[1]


def test_compile_checks_parameters_and_eager_train_step(ref_arrays, ids):
    from singa_tpu_torch import model as tmodel
    with pytest.raises(ValueError, match="no parameters"):
        tmodel.Model(tdevice.create_device("cpu")).compile([ids])
    tm = _tmodel(ref_arrays)
    with pytest.raises(RuntimeError, match="optimizer"):
        tmodel.Model.train_one_batch(tm, torch.from_numpy(ids), None)
    tm.set_optimizer(topt.SGD(lr=0.05))
    logits, loss = tm.train_step(torch.from_numpy(ids))   # eager: no compile
    assert logits.shape == (B, T, 256) and tm._step_count == 1
    assert not tm._executors
    assert tautograd.is_training()
