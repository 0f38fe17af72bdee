"""The port's memory planner (parallel.planner) against the JAX package's
``plan_train_step`` on the same mesh shapes.

Both plan shapes only: the reference under ``jax.eval_shape`` (called
with ``lower=False`` to keep the test fast), the port on torch's meta
device.  The reference's tiny plans run in this process on the
conftest's 8 virtual CPU devices; its Llama-3-8B plan on data 4 × model
8 needs 32 and runs in a subprocess, as its own test does.  Per-device
parameter, slot and gradient bytes are held equal (exact integers);
where the port holds other bytes than the reference's GSPMD would (a
projection the model axis would cut mid-head, a pipe rank's one stage),
the difference is held to exactly those bytes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import parallel as jparallel
from singa_tpu.parallel import planner as jplanner
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import opt as topt
from singa_tpu_torch.parallel import planner as tplanner

REPO = Path(__file__).resolve().parents[1]
CPU = tdevice.create_device("cpu")
FIELDS = ("param_bytes_global", "param_bytes_per_device",
          "slot_bytes_per_device", "grad_bytes_per_device",
          "grad_bytes_update_per_device", "per_device_state_bytes")

# name: (mesh axes, optimizer (package -> optimizer), batch)
CASES = {
    "dm_momentum": ({"data": 2, "model": 2},
                    lambda o: o.SGD(lr=0.1, momentum=0.9), (2, 16)),
    "dms_adam": ({"data": 2, "model": 2, "seq": 2},
                 lambda o: o.DistOpt(o.Adam(lr=1e-3)), (2, 16)),
    "zero1": ({"data": 8},
              lambda o: o.DistOpt(o.SGD(lr=0.1, momentum=0.9),
                                  shard_weight_update=True), (8, 16)),
    "grad_accum": ({"data": 8},
                   lambda o: o.DistOpt(o.GradAccum(
                       o.SGD(lr=0.1, momentum=0.9), 4)), (8, 16)),
    "model_plain": ({"model": 2}, lambda o: o.SGD(lr=0.1), (2, 16)),
}


def _jplan(axes, make_opt, batch, **cfg):
    m = jmodels.Llama(jmodels.LlamaConfig(
        **{**vars(jmodels.LlamaConfig.tiny()), **cfg}))
    return jplanner.plan_train_step(
        m, make_opt(jopt), (jax.ShapeDtypeStruct(batch, jnp.int32),),
        jparallel.make_mesh(axes), lower=False)


def _tmodel(**cfg):
    return tmodels.Llama(tmodels.LlamaConfig(
        **{**vars(tmodels.LlamaConfig.tiny()), **cfg}), device=CPU)


def _tplan(axes, make_opt, batch, lower=False, **cfg):
    return tplanner.plan_train_step(
        _tmodel(**cfg), make_opt(topt), ((torch.Size(batch), torch.int32),),
        axes, lower=lower)


def _bytes(plan):
    return {f: getattr(plan, f) for f in FIELDS}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_bytes_equal_the_reference(case):
    """Tiny Llama: the port's per-device parameter, slot (momentum, Adam,
    ZeRO-1 shards, GradAccum's f32 accumulator) and gradient bytes are
    the reference's MemoryPlan's on the same mesh shape."""
    axes, make_opt, batch = CASES[case]
    assert _bytes(_tplan(axes, make_opt, batch)) == \
        _bytes(_jplan(axes, make_opt, batch))


def test_grad_accum_and_zero1_account_as_the_reference():
    """GradAccum's accumulator adds one f32 parameter set to the slots;
    ZeRO-1 keeps the backward peak and holds 1/W at the update."""
    sgd = CASES["zero1"][1]
    plain = _tplan({"data": 8}, lambda o: o.DistOpt(
        o.SGD(lr=0.1, momentum=0.9)), (8, 16))
    accum = _tplan(*CASES["grad_accum"])
    zero1 = _tplan({"data": 8}, sgd, (8, 16))
    assert accum.slot_bytes_per_device - plain.slot_bytes_per_device == \
        plain.param_bytes_per_device
    assert zero1.grad_bytes_per_device == zero1.param_bytes_per_device
    assert zero1.grad_bytes_update_per_device * 8 == \
        zero1.param_bytes_per_device
    assert zero1.slot_bytes_per_device * 8 == plain.slot_bytes_per_device


def test_projections_the_model_axis_would_cut_mid_head_stay_whole():
    """At model = 4, tiny()'s two kv heads cannot be cut by whole heads:
    the port keeps k_proj and v_proj whole (as tensor_parallel does),
    where the reference's GSPMD cuts them in four: the plans differ by
    exactly those bytes, and by nothing else."""
    axes, batch = {"data": 2, "model": 4}, (2, 16)
    sgd = lambda o: o.SGD(lr=0.1, momentum=0.9)   # noqa: E731
    t, j = _tplan(axes, sgd, batch), _jplan(axes, sgd, batch)
    cfg = tmodels.LlamaConfig.tiny()
    kv = 2 * cfg.num_layers * cfg.dim * cfg.num_kv_heads * cfg.head_dim * 4
    extra = kv - kv // 4
    assert t.param_bytes_per_device - j.param_bytes_per_device == extra
    assert t.slot_bytes_per_device - j.slot_bytes_per_device == extra
    assert t.param_bytes_global == j.param_bytes_global


def test_a_pipe_rank_is_planned_with_one_stage():
    """Under {'data': 2, 'pipe': 2} with pipeline_stages=2 a pipe rank
    holds one stage's blocks (layer.PipelineStack), so the port's plan is
    the reference's less one block; without pipeline stages the plans
    agree."""
    axes, batch = {"data": 2, "pipe": 2}, (4, 16)
    sgd = lambda o: o.DistOpt(o.SGD(lr=0.1, momentum=0.9))   # noqa: E731
    t = _tplan(axes, sgd, batch, pipeline_stages=2)
    j = _jplan(axes, sgd, batch, pipeline_stages=2)
    block = sum(p.numel() * 4 for n, p in _tmodel().get_params().items()
                if n.startswith("blocks.0."))
    assert j.param_bytes_per_device - t.param_bytes_per_device == block
    assert j.slot_bytes_per_device - t.slot_bytes_per_device == block
    assert _bytes(_tplan(axes, sgd, batch)) == _bytes(_jplan(axes, sgd,
                                                             batch))


_SUB = r"""
import os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=32").strip()
import json
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from singa_tpu import models, opt, parallel, device
from singa_tpu.parallel import planner

device.set_default_device(device.create_cpu_device())
plan = planner.plan_train_step(
    models.Llama(models.LlamaConfig.llama3_8b()),
    opt.SGD(lr=1e-3, momentum=0.9), (jax.ShapeDtypeStruct((4, 1024),
                                                          jnp.int32),),
    mesh=parallel.make_mesh({"data": 4, "model": 8}), lower=False)
print(json.dumps({f: getattr(plan, f) for f in %r}))
"""


def test_llama3_8b_on_data_4_by_model_8_is_the_reference_plan():
    """Llama-3-8B on a 4 × 8 mesh, planned on one CPU without allocating:
    the reference's bytes exactly, and it fits an H100 (the port's
    HBM table holds the cards it runs on, not TPU generations)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _SUB % (FIELDS,)], env=env,
                       capture_output=True, text=True, timeout=240,
                       cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    plan = tplanner.plan_train_step(
        lambda d: tmodels.Llama(tmodels.LlamaConfig.llama3_8b(), device=d),
        topt.SGD(lr=1e-3, momentum=0.9),
        ((torch.Size([4, 1024]), torch.int32),), {"data": 4, "model": 8},
        lower=False)
    assert _bytes(plan) == ref
    assert 7.5e9 < plan.param_bytes_global / 4 < 8.5e9
    assert plan.fits() and plan.fits("h100") and plan.fits("h200")
    assert set(tplanner.HBM_BYTES) == {"h100", "h200"}


def test_abstract_init_allocates_nothing():
    """A model's twin, or a builder's model, has every parameter and
    buffer on the meta device; the model itself is left as it was."""
    m = _tmodel()
    before = {n: p.detach().clone() for n, p in m.get_params().items()}
    twin = tplanner.abstract_init(m)
    built = tplanner.abstract_init(lambda d: tmodels.Llama(
        tmodels.LlamaConfig.tiny(), device=d))
    for mod in (twin, built):
        assert all(t.device.type == "meta"
                   for t in list(mod.parameters()) + list(mod.buffers()))
        assert {n: tuple(p.shape) for n, p in mod.get_params().items()} == \
            {n: tuple(p.shape) for n, p in before.items()}
    for n, p in m.get_params().items():
        assert p.device.type == "cpu" and torch.equal(p, before[n])
        assert p is not twin.get_params()[n]


def test_model_usable_after_planning():
    """Planning with the step run on meta tensors consumes nothing: the
    planner's optimizer is not left on the model, which then compiles
    and trains; the plan keeps the meta step's record."""
    m = _tmodel()
    plan = tplanner.plan_train_step(
        m, topt.SGD(lr=0.1, momentum=0.9),
        ((torch.Size([2, 16]), torch.int32),), {"data": 2, "model": 4})
    assert m.optimizer is None
    ops = plan.lowered.op_types()
    assert plan.lowered.num_ops > 200 and plan.lowered.flops() > 0
    assert any("mm" in k for k in ops), ops
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 16)).astype(np.int32))
    m.set_optimizer(topt.SGD(lr=0.1))
    m.compile([ids], is_train=True, use_graph=True)
    assert np.isfinite(m.train_step(ids)[1].item())


def test_sharded_bytes_exact():
    from singa_tpu_torch.parallel.mesh import Mesh, NamedSharding, P
    mesh = Mesh({"data": 2, "model": 4})
    assert tplanner._sharded_bytes(
        (8, 16), torch.float32, NamedSharding(mesh, P(None, "model"))) \
        == 8 * 4 * 4
    assert tplanner._sharded_bytes(
        (8, 16), torch.bfloat16, NamedSharding(mesh, P())) == 8 * 16 * 2
