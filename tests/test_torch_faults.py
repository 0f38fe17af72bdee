"""The port's fault injection (singa_tpu_torch.faults) and failure
detection (singa_tpu_torch.utils.failure) against the JAX package's.

The same plan strings parse to the same specs, the same seeded plans
fire on the same calls, the site registries are equal, ``corrupt``
NaN-fills floating tensors only, and the port's host seams (the step
executor and generate() sessions) carry the ``device.execute`` site.
The Heartbeat fires on a stalled beat and the liveness probe answers on
the CPU device."""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from singa_tpu import faults as jfaults
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import faults as tfaults
from singa_tpu_torch import opt
from singa_tpu_torch.faults import FaultPlan, FaultSpec, InjectedFault
from singa_tpu_torch.models import Llama, LlamaConfig
from singa_tpu_torch.utils import failure


@pytest.fixture(autouse=True)
def _no_plan_leak():
    yield
    tfaults.uninstall()
    jfaults.uninstall()


def _spec_fields(spec):
    return {k: getattr(spec, k) for k in
            ("site", "kind", "at", "every", "p", "times", "delay_s")}


PLANS = ["serve.decode=error:every=3,times=2;serve.prefill=hang:at=1,"
         "delay=0.5",
         "device.execute=nan:at=4",
         "serve.block_alloc=error:p=0.25,times=5",
         "ckpt.torn=torn_write:at=2;serve.transport=torn_frame:every=2"]


@pytest.mark.parametrize("text", PLANS)
def test_plan_strings_parse_alike(text):
    j, t = jfaults.FaultPlan.parse(text, seed=9), FaultPlan.parse(text, seed=9)
    assert t.seed == j.seed == 9
    assert [_spec_fields(s) for s in t.specs] == \
        [_spec_fields(s) for s in j.specs]


@pytest.mark.parametrize("text", ["serve.decode", "serve.decode=error:never=3",
                                  "serve.typo=error",
                                  "serve.prefill=nan:at=1",
                                  "serve.decode=error:at=1,every=2",
                                  "serve.decode=error:p=1.5"])
def test_bad_plans_fail_alike(text):
    with pytest.raises(ValueError) as jerr:
        jfaults.FaultPlan.parse(text)
    with pytest.raises(ValueError) as terr:
        FaultPlan.parse(text)
    assert str(terr.value) == str(jerr.value)


def _firing(mod, seed, specs, sites, n=48):
    plan = mod.FaultPlan([mod.FaultSpec(*s[:2], **s[2]) for s in specs],
                         seed=seed)
    seq = []
    for i in range(n):
        site = sites[i % len(sites)]
        seq.append((site, [k for k, sp in plan.match(
            site, ("error", "hang", "nan"))]))
    return seq, plan.fire_count(), dict(plan.calls)


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_seeded_firing_sequences_are_identical(seed):
    specs = [("serve.decode", "error", dict(p=0.4)),
             ("serve.prefill", "hang", dict(every=3, times=4, delay_s=0.0)),
             ("device.execute", "nan", dict(p=0.3, times=6))]
    sites = ["serve.decode", "serve.prefill", "device.execute"]
    assert _firing(tfaults, seed, specs, sites) == \
        _firing(jfaults, seed, specs, sites)


def test_site_registries_are_equal():
    assert tfaults.SITES == jfaults.SITES
    assert tfaults.sites.INCIDENT_SITES == jfaults.sites.INCIDENT_SITES
    assert tfaults.KINDS == jfaults.KINDS


Pair = collections.namedtuple("Pair", "x y")


def test_corrupt_nanifies_float_tensors_only():
    value = {"loss": torch.ones(3), "ids": torch.ones(2, dtype=torch.int32),
             "nested": [torch.ones(2, dtype=torch.bfloat16),
                        (np.ones(2, np.float32), np.ones(2, np.int64))],
             "pair": Pair(torch.zeros(1), 7)}
    plan = FaultPlan([FaultSpec("device.execute", "nan", at=1)])
    with tfaults.active(plan):
        tfaults.fire("device.execute")
        out = tfaults.corrupt("device.execute", value)
    assert torch.isnan(out["loss"]).all()
    assert torch.equal(out["ids"], value["ids"])
    assert out["nested"][0].dtype == torch.bfloat16
    assert torch.isnan(out["nested"][0].float()).all()
    assert np.isnan(out["nested"][1][0]).all()
    assert (out["nested"][1][1] == 1).all()
    assert isinstance(out["pair"], Pair) and out["pair"].y == 7
    assert torch.isnan(out["pair"].x).all()


def test_corrupt_without_a_plan_returns_the_value():
    x = torch.ones(2)
    assert tfaults.corrupt("device.execute", x) is x


def test_injected_fault_is_a_runtime_error():
    plan = FaultPlan([FaultSpec("serve.decode", "error", at=1)])
    with tfaults.active(plan):
        with pytest.raises(InjectedFault, match="serve.decode"):
            tfaults.fire("serve.decode")
        tfaults.fire("serve.decode")
    assert issubclass(InjectedFault, RuntimeError)


def test_nested_activation_rejected():
    with tfaults.active(FaultPlan()):
        with pytest.raises(RuntimeError, match="already active"):
            with tfaults.active(FaultPlan()):
                pass


@pytest.fixture(scope="module")
def tiny():
    dev = tdevice.create_device("cpu")
    return Llama(LlamaConfig.tiny(), device=dev,
                 generator=torch.Generator().manual_seed(0))


def test_train_step_carries_the_device_execute_site(tiny):
    """An error fired at the executor's seam leaves the step undone (a
    retry runs the same step); a nan corrupts the step's outputs."""
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 8)).astype(np.int32))
    tiny.set_optimizer(opt.SGD(lr=0.0))
    tiny.compile([ids], is_train=True, use_graph=True)
    plan = FaultPlan([FaultSpec("device.execute", "error", at=1),
                      FaultSpec("device.execute", "nan", at=2)])
    with tfaults.active(plan):
        with pytest.raises(InjectedFault):
            tiny.train_step(ids)
        assert tiny._step_count == 0
        _, loss = tiny.train_step(ids)
        assert torch.isnan(loss)
        _, loss = tiny.train_step(ids)
    assert torch.isfinite(loss) and tiny._step_count == 2
    assert plan.calls == {"device.execute": 3}


def test_generate_session_carries_the_device_execute_site(tiny):
    prompt = np.arange(6, dtype=np.int32)[None]
    plan = FaultPlan([FaultSpec("device.execute", "error", at=1)])
    with tfaults.active(plan):
        with pytest.raises(InjectedFault):
            tiny.generate(prompt, max_new_tokens=3)
        out = tiny.generate(prompt, max_new_tokens=3)
    assert out.shape == (1, 9)
    assert plan.calls == {"device.execute": 2}


def test_heartbeat_fires_on_a_stalled_beat():
    fired = threading.Event()
    seen = []

    def on_failure(age, step):
        seen.append((age, step))
        fired.set()

    hb = failure.Heartbeat(timeout=0.05, check_every=0.01,
                           on_failure=on_failure).start()
    try:
        hb.beat(4)
        assert fired.wait(2.0), "no alarm for a stalled beat"
    finally:
        hb.stop()
    assert hb.fired and seen[0][1] == 4 and seen[0][0] > 0.05


def test_heartbeat_stays_quiet_while_beating():
    hb = failure.Heartbeat(timeout=0.5, check_every=0.01,
                           on_failure=lambda a, s: None)
    with hb:
        for i in range(10):
            hb.beat(i)
            time.sleep(0.01)
    assert not hb.fired


@pytest.mark.parametrize("dev", [None, "port", "torch"])
def test_liveness_probe_on_the_cpu(dev):
    cpu = tdevice.create_device("cpu")
    tdevice.set_default_device(cpu)
    try:
        arg = {None: None, "port": cpu, "torch": torch.device("cpu")}[dev]
        assert failure.device_liveness_check(arg, timeout=10.0)
    finally:
        tdevice.set_default_device(None)


def test_liveness_probe_reports_a_dead_device():
    assert not failure.device_liveness_check(torch.device("meta"),
                                             timeout=10.0)
