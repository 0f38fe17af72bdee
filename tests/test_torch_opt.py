"""The port's optimizers and schedules (singa_tpu_torch.opt) against the
JAX package's, on the CPU: the schedules on int and 0-d tensor steps,
each optimizer's update, and 9-step train_step trajectories of
LlamaConfig.tiny() in f32 with the reference's weights carried over, on
the same numpy-seeded token batch.

Tolerances (both sides f32 where the reference is; they differ in op
order and elementwise implementations only):
  * schedules: 1e-6 relative (the port computes them in float64 from
    the step, the reference in f32);
  * one update on the same arrays: rtol 1e-6, atol 1e-7;
  * nine train_steps: every step's loss within rtol 1e-5, the final
    parameters within rtol 1e-4, atol 1e-5;
  * GradAccum over k microbatches against one step on their
    concatenation: rtol 1e-5, atol 1e-7 (the reference's own test)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch.models import Llama, LlamaConfig, load_reference_params

B, T = 2, 16
STEPS = 9


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


def _jmodel(ref_arrays, ids):
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    for n, t in jm.get_params().items():
        t.data = jnp.asarray(ref_arrays[n])
    return jm


def _tmodel(ref_arrays):
    tm = Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"))
    load_reference_params(tm, ref_arrays)
    return tm


# -- schedules -------------------------------------------------------------------

# (schedule, total steps it spans)
_SCHEDULES = {
    "constant": (lambda m: m.Constant(0.3), 4),
    "exponential": (lambda m: m.ExponentialDecay(0.1, 3, 0.5), 9),
    "exponential_staircase": (
        lambda m: m.ExponentialDecay(0.1, 3, 0.5, staircase=True), 9),
    "cosine": (lambda m: m.CosineDecay(0.1, 6, alpha=0.1), 6),
    "warmup_cosine": (lambda m: m.WarmupCosine(0.1, 2, 8, min_lr=0.01), 8),
    "multistep": (lambda m: m.MultiStepLR(0.1, [2, 5], gamma=0.5), 6),
}


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("name", list(_SCHEDULES))
def test_schedule_matches_reference_over_two_spans(name, as_tensor):
    make, total = _SCHEDULES[name]
    js, ts = make(jopt), make(topt)
    for step in range(2 * total + 1):
        arg = torch.tensor(step) if as_tensor else step
        got = ts(arg)
        if isinstance(got, torch.Tensor):
            assert got.ndim == 0
        np.testing.assert_allclose(float(got), float(js(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


# -- one update ------------------------------------------------------------------

_APPLY = {
    "rmsprop": lambda m: m.RMSProp(lr=1e-2, weight_decay=0.01),
    "adagrad": lambda m: m.AdaGrad(lr=m.CosineDecay(0.1, 4)),
    "adafactor_factored_relative": lambda m: m.Adafactor(
        min_dim_size_to_factor=4),
    "adafactor_unfactored_lr_momentum": lambda m: m.Adafactor(
        lr=1e-2, momentum=0.9, weight_decay=0.1),
    "grad_accum_adam": lambda m: m.GradAccum(m.Adam(lr=1e-2), 2),
}


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("name", list(_APPLY))
def test_update_matches_reference_apply(name, as_tensor):
    rng = np.random.RandomState(4)
    p0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(4)]
    jo, to = _APPLY[name](jopt), _APPLY[name](topt)
    jp, jslot = jnp.asarray(p0), jo._init_slot(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy())
    tslot = to.init_slot(tp)
    for step, g in enumerate(grads):
        jp, jslot = jo.apply(step, "w", jp, jnp.asarray(g), jslot)
        arg = torch.tensor(step) if as_tensor else step
        tslot = to.apply(arg, "w", tp, torch.from_numpy(g), tslot)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7, err_msg=f"step {step}")
    assert to.state_signature() == jo.state_signature()
    jleaves = jax.tree.leaves(jslot)
    tleaves = topt._leaves(tslot)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_adafactor_factors_only_large_matrices():
    o = topt.Adafactor(min_dim_size_to_factor=8, momentum=0.5)
    big = o.init_slot(torch.zeros(8, 16))
    assert sorted(big) == ["m", "vc", "vr"]
    assert big["vr"].shape == (8,) and big["vc"].shape == (16,)
    assert sorted(o.init_slot(torch.zeros(4, 16))) == ["m", "v"]
    assert sorted(o.init_slot(torch.zeros(16))) == ["m", "v"]
    o._eager_state = {"w": big}
    slots = o.slot_arrays()
    assert [t is s for t, s in zip(slots["w"], (big["m"], big["vc"],
                                                big["vr"]))] == [True] * 3
    o2 = topt.Adafactor(min_dim_size_to_factor=8, momentum=0.5)
    o2.load_slot_arrays(slots)
    assert {k: v.shape for k, v in o2._eager_state["w"].items()} == \
        {k: v.shape for k, v in big.items()}


# -- the step on the device ---------------------------------------------------------

def test_step_tensor_follows_the_step_counter():
    o = topt.SGD(lr=topt.WarmupCosine(0.1, 4, 10))
    o.step_counter = 3
    t = o.step_tensor("cpu")
    assert t.dtype == torch.int64 and int(t) == 3
    assert o.step_tensor("cpu") is t
    o.step()
    assert int(t) == 4 and o.step_counter == 4
    o.set_states({"step": 7})
    assert int(t) == 7 and o.get_states() == {"step": 7}
    # the schedule reads the tensor's value when it runs, not when the
    # optimizer was made
    np.testing.assert_allclose(float(o.sched(t)), float(o.sched(7)))


def test_grad_accum_updates_only_on_every_kth_step_and_schedules_by_update():
    inner = topt.SGD(lr=topt.MultiStepLR(1.0, [1], gamma=0.5))
    o = topt.GradAccum(inner, 3)
    p = torch.zeros(4)
    slot = o.init_slot(p)
    seen = []
    for step in range(6):
        o.apply(torch.tensor(step), "w", p, torch.ones(4), slot)
        seen.append(p.clone())
    # steps 0, 1 accumulate; step 2 applies lr 1.0 (update 0) x mean 1;
    # steps 3, 4 accumulate; step 5 applies lr 0.5 (update 1)
    expect = [0, 0, -1, -1, -1, -1.5]
    assert [float(s[0]) for s in seen] == expect
    assert torch.count_nonzero(slot["acc"]) == 0


# -- nine steps through compile / train_step ----------------------------------------

_TRAJ = {
    "rmsprop": lambda m: m.RMSProp(lr=1e-3),
    "adagrad": lambda m: m.AdaGrad(lr=5e-3),
    # factored (every tiny matrix has both dims >= 32), relative step
    "adafactor_factored_relative": lambda m: m.Adafactor(
        min_dim_size_to_factor=32),
    # unfactored, explicit lr, momentum
    "adafactor_unfactored_lr_momentum": lambda m: m.Adafactor(
        lr=1e-2, momentum=0.9),
    # factored, explicit scheduled lr with parameter scale, momentum
    "adafactor_factored_sched_scaled_momentum": lambda m: m.Adafactor(
        lr=m.WarmupCosine(0.1, 2, 9), min_dim_size_to_factor=32,
        multiply_by_parameter_scale=True, momentum=0.8),
    # unfactored, relative step, no clipping, weight decay
    "adafactor_unfactored_relative_wd": lambda m: m.Adafactor(
        clipping_threshold=None, weight_decay=0.1),
    "grad_accum_sgd_momentum": lambda m: m.GradAccum(
        m.SGD(lr=0.1, momentum=0.9), 3),
}


@pytest.mark.parametrize("optname", list(_TRAJ))
def test_train_step_trajectory_matches_reference(ref_arrays, ids, optname):
    jm = _jmodel(ref_arrays, ids)
    jm.set_optimizer(_TRAJ[optname](jopt))
    x = jtensor.from_numpy(ids)
    jm.compile([x], is_train=True, use_graph=True)
    jlosses = [float(np.asarray(jm.train_step(x)[1].data))
               for _ in range(STEPS)]

    tm = _tmodel(ref_arrays)
    tm.set_optimizer(_TRAJ[optname](topt))
    tm.compile([ids], is_train=True, use_graph=True)
    tlosses = [tm.train_step(ids)[1].item() for _ in range(STEPS)]

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    assert tm.optimizer.step_counter == STEPS == jm.optimizer.step_counter
    jp = jm.get_params()
    for n, p in tm.get_params().items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n].data),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("use_graph", [True, False], ids=["graph", "eager"])
def test_grad_accum_equals_the_big_batch(ref_arrays, use_graph):
    """GradAccum(SGD-momentum, k) over k microbatches lands on the
    parameters of one SGD-momentum step on their concatenation."""
    k = 2
    big = np.random.RandomState(21).randint(0, 256, (4, T)).astype(np.int32)
    m_big = _tmodel(ref_arrays)
    m_big.set_optimizer(topt.SGD(lr=0.1, momentum=0.9))
    m_big.compile([big], is_train=True, use_graph=use_graph)
    m_big.train_step(torch.from_numpy(big))

    m_acc = _tmodel(ref_arrays)
    m_acc.set_optimizer(topt.GradAccum(topt.SGD(lr=0.1, momentum=0.9), k))
    micro = [torch.from_numpy(x) for x in np.split(big, k)]
    m_acc.compile([micro[0]], is_train=True, use_graph=use_graph)
    before = {n: p.detach().clone() for n, p in m_acc.get_params().items()}
    for i, x in enumerate(micro):
        m_acc.train_step(x)
        if i < k - 1:                     # accumulate-only: no update
            for n, p in m_acc.get_params().items():
                assert torch.equal(p, before[n]), n
    pb = m_big.get_params()
    for n, p in m_acc.get_params().items():
        np.testing.assert_allclose(p.detach().numpy(), pb[n].detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


def test_train_step_reads_the_schedule_at_every_step(ref_arrays, ids):
    """A schedule that moves every step gives the eager path's
    trajectory through the executor (which passes the device step)."""
    runs = []
    for use_graph in (False, True):
        tm = _tmodel(ref_arrays)
        tm.set_optimizer(topt.AdamW(lr=topt.WarmupCosine(3e-3, 2, 6)))
        tm.compile([ids], is_train=True, use_graph=use_graph)
        runs.append([tm.train_step(torch.from_numpy(ids))[1].item()
                     for _ in range(6)])
    assert runs[0] == runs[1]
    # lr is 0 at step 0, then moves every step
    assert runs[0][0] == runs[0][1] and len(set(runs[0][1:])) == 5
