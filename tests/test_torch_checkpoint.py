"""Checkpoints of the port (singa_tpu_torch.utils.checkpoint,
Model.save_states / load_states, the layer state accessors) on the CPU:
round trips, resume inside the port, and files crossing between the
port and the JAX package, on LlamaConfig.tiny() in f32 with the
reference's weights carried over.

Tolerances: resume inside the port is bitwise (one device, the same
ops in the same order); across the packages a loaded file's arrays are
equal, and later steps track the other package's within rtol 1e-5 on
the loss and rtol 1e-4, atol 1e-5 on the parameters, as the trajectory
tests do."""

import json

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
from singa_tpu_torch.utils import checkpoint as tckpt

B, T = 2, 16


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)
    jautograd.set_training(False)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.RandomState(5)
    return [rng.randint(0, 256, (B, T)).astype(np.int32) for _ in range(6)]


@pytest.fixture(scope="module")
def ref_arrays(batches):
    jtensor.set_seed(0)
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.compile([jtensor.from_numpy(batches[0])], is_train=False,
               use_graph=False)
    return {n: np.asarray(t.data) for n, t in jm.get_params().items()}


def _jmodel(ref_arrays, batches, make_opt):
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.compile([jtensor.from_numpy(batches[0])], is_train=False,
               use_graph=False)
    for n, t in jm.get_params().items():
        t.data = jnp.asarray(ref_arrays[n])
    jm.set_optimizer(make_opt(jopt))
    jm.compile([jtensor.from_numpy(batches[0])], is_train=True,
               use_graph=True)
    return jm


def _tmodel(ref_arrays, make_opt):
    tm = Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"))
    load_reference_params(tm, ref_arrays)
    tm.set_optimizer(make_opt(topt))
    tm.compile([np.zeros((B, T), np.int32)], is_train=True, use_graph=True)
    return tm


def _jstep(jm, x):
    return float(np.asarray(jm.train_step(jtensor.from_numpy(x))[1].data))


def _tstep(tm, x):
    return tm.train_step(x)[1].item()


_OPTS = {
    "sgd_momentum": lambda m: m.SGD(lr=0.05, momentum=0.9),
    "adamw": lambda m: m.AdamW(lr=m.WarmupCosine(3e-3, 2, 6)),
    "adafactor": lambda m: m.Adafactor(min_dim_size_to_factor=32,
                                       momentum=0.9),
    # saved after 3 steps: mid-accumulation (one microbatch held)
    "grad_accum": lambda m: m.GradAccum(m.SGD(lr=0.1, momentum=0.9), 2),
}


# -- inside the port -------------------------------------------------------------

def test_states_are_the_references_and_exclude_rope_tables(ref_arrays,
                                                           batches):
    jm = _jmodel(ref_arrays, batches, _OPTS["sgd_momentum"])
    tm = _tmodel(ref_arrays, _OPTS["sgd_momentum"])
    assert sorted(tm.get_states()) == sorted(jm.get_states())
    assert not any("rope" in n for n in tm.get_states())
    assert tm._get_buffers() == {}


def test_save_load_round_trips_params_slots_and_step(ref_arrays, batches,
                                                     tmp_path):
    tm = _tmodel(ref_arrays, _OPTS["sgd_momentum"])
    for x in batches[:3]:
        tm.train_step(x)
    path = str(tmp_path / "ckpt.npz")
    tm.save_states(path, aux_states={"epoch": 2})
    t2 = _tmodel(ref_arrays, lambda m: m.SGD(lr=0.05, momentum=0.9))
    aux = t2.load_states(path)
    assert aux["epoch"] == 2 and aux["optimizer"] == {"step": 3}
    assert aux["opt_signature"] == "SGD(momentum=True)"
    assert t2.optimizer.step_counter == 3
    for n, p in tm.get_params().items():
        assert torch.equal(t2.get_params()[n], p), n
    s1, s2 = tm.optimizer.slot_arrays(), t2.optimizer.slot_arrays()
    assert sorted(s1) == sorted(s2) == sorted(tm.get_params())
    for n in s1:
        assert all(torch.equal(a, b) for a, b in zip(s1[n], s2[n])), n


@pytest.mark.parametrize("optname", list(_OPTS))
def test_resume_is_bitwise(ref_arrays, batches, tmp_path, optname):
    """6 steps uninterrupted == 3 steps, save, a fresh model, load, 3
    more steps."""
    make = _OPTS[optname]
    whole = _tmodel(ref_arrays, make)
    losses = [_tstep(whole, x) for x in batches]

    first = _tmodel(ref_arrays, make)
    resumed = [_tstep(first, x) for x in batches[:3]]
    path = str(tmp_path / "mid.npz")
    first.save_states(path)
    second = Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"),
                   generator=torch.Generator().manual_seed(9))
    second.set_optimizer(make(topt))
    second.compile([batches[0]], is_train=True, use_graph=True)
    second.load_states(path)
    resumed += [_tstep(second, x) for x in batches[3:]]

    assert resumed == losses
    assert second.optimizer.step_counter == 6
    for n, p in whole.get_params().items():
        assert torch.equal(second.get_params()[n], p), n


def test_load_copies_into_existing_storage_and_drops_executors(
        ref_arrays, batches, tmp_path):
    tm = _tmodel(ref_arrays, _OPTS["adamw"])
    tm.train_step(batches[0])
    path = str(tmp_path / "a.npz")
    tm.save_states(path)
    tm.train_step(batches[1])
    ptrs = {n: p.data_ptr() for n, p in tm.get_params().items()}
    assert tm._executors and tm.graph is not None
    tm.load_states(path)
    assert not tm._executors and tm.graph is None
    assert {n: p.data_ptr() for n, p in tm.get_params().items()} == ptrs
    assert tm.optimizer.step_counter == 1
    assert int(tm.optimizer.step_tensor("cpu")) == 1


def test_cross_optimizer_restore_is_refused_before_any_change(
        ref_arrays, batches, tmp_path):
    """Adam's (m, v) must not be read as GradAccum's {acc, base}: leaf
    counts and shapes coincide, the signature does not."""
    tm = _tmodel(ref_arrays, lambda m: m.Adam(lr=1e-3))
    tm.train_step(batches[0])
    path = str(tmp_path / "adam.npz")
    tm.save_states(path)
    other = _tmodel(ref_arrays, lambda m: m.GradAccum(
        m.SGD(lr=0.1, momentum=0.9), 2))
    other.train_step(batches[1])
    before = {n: p.clone() for n, p in other.get_params().items()}
    with pytest.raises(ValueError, match="refusing to reinterpret"):
        other.load_states(path)
    assert other.optimizer.step_counter == 1
    for n, p in other.get_params().items():
        assert torch.equal(p, before[n]), n


def test_torn_slot_manifest_is_refused_before_any_change(ref_arrays, batches,
                                                         tmp_path):
    tm = _tmodel(ref_arrays, _OPTS["sgd_momentum"])
    tm.train_step(batches[0])
    arrays, aux = tckpt._collect(tm, None)
    del arrays["__opt__:0"]               # a moment lost, manifest intact
    path = str(tmp_path / "torn.npz")
    tckpt.save_arrays(arrays, path, aux)
    fresh = _tmodel(ref_arrays, _OPTS["sgd_momentum"])
    before = {n: p.clone() for n, p in fresh.get_params().items()}
    with pytest.raises(ValueError, match="slot manifest"):
        fresh.load_states(path)
    for n, p in fresh.get_params().items():
        assert torch.equal(p, before[n]), n
    # and a file whose metadata was edited fails its digest
    with np.load(path) as z:
        members = {k: z[k] for k in z.files}
    meta = json.loads(str(members["__meta__"]))
    meta["__aux__"] = meta["__aux__"].replace('"step": 1', '"step": 5')
    members["__meta__"] = json.dumps(meta)
    np.savez(path, **members)
    with pytest.raises(ValueError, match="digest"):
        tckpt.load_arrays(path)


def test_set_params_refuses_a_shape_it_cannot_hold(ref_arrays):
    tm = _tmodel(ref_arrays, _OPTS["sgd_momentum"])
    w = tm.get_params()["lm_head.W"]
    before = w.clone()
    with pytest.raises(ValueError, match="lm_head.W"):
        tm.set_params({"norm_f.gamma": np.zeros(64, np.float32),
                       "lm_head.W": np.zeros((3, 3), np.float32)})
    assert torch.equal(w, before)
    assert torch.count_nonzero(tm.get_params()["norm_f.gamma"]) == 64
    tm.set_params({"lm_head.W": np.zeros(tuple(w.shape), np.float32),
                   "not.a.param": np.zeros(1)})
    assert torch.count_nonzero(w) == 0


@pytest.mark.parametrize("asynchronous", [False, True],
                         ids=["sync", "async"])
def test_checkpoint_manager_keeps_the_newest_and_resumes(
        ref_arrays, batches, tmp_path, asynchronous):
    tm = _tmodel(ref_arrays, _OPTS["sgd_momentum"])
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2,
                                  asynchronous=asynchronous)
    for step, x in enumerate(batches[:4]):
        tm.train_step(x)
        mgr.save(step, tm)
    mgr.wait()
    assert mgr.steps() == [2, 3]
    # a torn newest file falls back to the one before it
    with open(mgr._path(3), "wb") as f:
        f.write(b"torn")
    fresh = _tmodel(ref_arrays, _OPTS["sgd_momentum"])
    assert mgr.restore_latest(fresh) == 3
    assert fresh.optimizer.step_counter == 3


# -- across the two packages ---------------------------------------------------------

def test_reference_file_loads_into_the_port_and_tracks(ref_arrays, batches,
                                                       tmp_path):
    make = _OPTS["adamw"]
    jm = _jmodel(ref_arrays, batches, make)
    for x in batches[:3]:
        _jstep(jm, x)
    path = str(tmp_path / "jax.npz")
    jm.save_states(path)
    jlosses = [_jstep(jm, x) for x in batches[3:]]

    tm = _tmodel(ref_arrays, make)
    tm.load_states(path)
    assert tm.optimizer.step_counter == 3
    tlosses = [_tstep(tm, x) for x in batches[3:]]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    jp = jm.get_params()
    for n, p in tm.get_params().items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n].data),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("optname", ["adamw", "adafactor", "grad_accum"])
def test_port_file_loads_into_the_reference_and_tracks(ref_arrays, batches,
                                                       tmp_path, optname):
    make = _OPTS[optname]
    tm = _tmodel(ref_arrays, make)
    for x in batches[:3]:
        _tstep(tm, x)
    path = str(tmp_path / "port.npz")
    tm.save_states(path)
    tlosses = [_tstep(tm, x) for x in batches[3:]]

    jm = _jmodel(ref_arrays, batches, make)
    aux = jm.load_states(path)
    assert aux["opt_signature"] == jm.optimizer.state_signature()
    arrays, _ = tckpt.load_arrays(path)
    for n, t in jm.get_params().items():
        np.testing.assert_array_equal(np.asarray(t.data), arrays[n])
    jlosses = [_jstep(jm, x) for x in batches[3:]]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
