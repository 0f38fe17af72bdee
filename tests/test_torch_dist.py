"""The port's data-parallel path (singa_tpu_torch.parallel, opt.DistOpt,
the executor's data-parallel step, multi-process checkpoints, the
sharded DataLoader and train_cnn --dist) against the JAX package's.

The reference runs in this process on the conftest's virtual CPU mesh
(``parallel.set_mesh(parallel.data_parallel_mesh(W))``, its step under
``shard_map``).  The port runs as W gloo processes: one world of 2 and
one of 4, launched together once for the module, each running every
scenario of `WORKER` (torch, numpy and singa_tpu_torch only) and
writing what it got to an .npz.  Inputs and the reference models'
initial states reach the workers through ``inputs.npz``.

Tolerances:
  * the primitives (allreduce mean/sum/max, allgather, reduce_scatter,
    ppermute, broadcast): exact.  Inputs are multiples of 1/8 below 8,
    so every sum is exact in f32 in any order;
  * quantized_allreduce (int32 and int8 wires) and the error-feedback
    ring: bitwise, results and residuals, at W = 2 and W = 4;
  * _topk_allreduce on tie-free inputs: 1e-6 (the scatter-add's order
    of duplicate indices is its own);
  * DistOpt training at W = 2 against the reference's W = 2: losses and
    parameters within 1e-5 (atol and rtol) in every mode; the port's
    W = 2 plain run against its own W = 1 big-batch run within 1e-6;
  * within the port: kill-and-resume, two independent runs, and the
    ranks against each other: bitwise.
"""

import os
import socket
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import faults as jfaults
from singa_tpu import layer as jlayer
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import parallel as jparallel
from singa_tpu import tensor as jtensor
from singa_tpu.models._base import Classifier as JClassifier
from singa_tpu.parallel import communicator as jcomm
from singa_tpu.utils import data as jdata
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import opt as topt
from singa_tpu_torch import parallel as tparallel
from singa_tpu_torch.utils import checkpoint as tcheckpoint
from singa_tpu_torch.utils import data as tdata

REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
STEPS = 4
PARITY_TOL = 1e-5       # port W=2 vs reference W=2
BIG_BATCH_TOL = 1e-6    # port W=2 vs port W=1 big batch
TOPK_TOL = 1e-6
RING_FLIP_SHARE = 0.01  # int8 ring: elements whose code may flip
RING_FLIP_TOL = 1e-3    # ... each within 10 x lr x one grid step
QUANT_LENGTHS = (1024, 300, 1000, 2055)   # 1024: a multiple of 256·W
FAULT_AT = 5
WORKER_TIMEOUT_S = 120

# mode: (DistOpt keywords, base optimizer, model)
MODES = {
    "plain": ("{}", "sgd", "mlp32"),
    "bf16": ("{'compress_dtype': torch.bfloat16}", "sgd", "mlp32"),
    "topk": ("{'topk_ratio': 0.25}", "sgd", "mlp128"),
    "int8": ("{'compress_dtype': 'int8'}", "sgd", "mlp32"),
    "ring": ("{'compression': 'int8_ring'}", "sgd", "mlp32"),
    "zero1": ("{'shard_weight_update': True}", "sgd", "mlp32"),
    "adafactor": ("{}", "adafactor", "mlp32"),
    "accum": ("{}", "accum", "mlp32"),
}

WORKER = r'''
import hashlib, os, sys, traceback
sys.path.insert(0, sys.argv[5])
import numpy as np
import torch
torch.set_num_threads(1)
from singa_tpu_torch import device, faults, layer, models, opt, parallel
from singa_tpu_torch.models._base import Classifier
from singa_tpu_torch.parallel import communicator as comm
from singa_tpu_torch.tools import train_cnn

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
CPU = device.create_device("cpu")
inp = dict(np.load(os.path.join(out, "inputs.npz")))
res = {}
MODES = %(modes)s
QUANT_LENGTHS = %(lengths)r
STEPS = %(steps)d
FAULT_AT = %(fault_at)d


class TinyBN(Classifier):
    def __init__(self):
        super().__init__(device=CPU)
        self.conv = layer.Conv2d(4, 3, 2, padding=1, device=CPU)
        self.bn = layer.BatchNorm2d(4, device=CPU)
        self.relu = layer.ReLU()
        self.flat = layer.Flatten()
        self.fc = layer.Linear(3, 6 * 6 * 4, device=CPU)

    def forward(self, x):
        return self.fc(self.flat(self.relu(self.bn(self.conv(x)))))


def build(kind):
    if kind == "bn":
        m = TinyBN()
    else:
        width = 128 if kind == "mlp128" else 32
        m = models.MLP(perceptron_size=(width,), num_classes=4,
                       input_shape=(16,), device=CPU)
    pre = kind + "/"
    models.load_reference_states(m, {k[len(pre):]: v for k, v in inp.items()
                                     if k.startswith(pre)})
    return m


def base_opt(base):
    if base == "adafactor":
        return opt.Adafactor(lr=1e-2, multiply_by_parameter_scale=False,
                             min_dim_size_to_factor=8)
    sgd = opt.SGD(lr=0.1, momentum=0.9)
    return opt.GradAccum(sgd, 2) if base == "accum" else sgd


def data(kind):
    if kind == "bn":
        return torch.from_numpy(inp["bnX"]), torch.from_numpy(inp["bnY"])
    return torch.from_numpy(inp["X"]), torch.from_numpy(inp["Y"])


def fresh(mode):
    kw, base, kind = MODES[mode]
    m = build(kind)
    m.set_optimizer(opt.DistOpt(base_opt(base), **eval(kw)))
    x, _ = data(kind)
    m.compile([x], is_train=True, use_graph=True)
    return m


def steps(m, kind, n, tag=None):
    x, y = data(kind)
    losses = []
    for i in range(n):
        o, loss = m.train_step(x, y)
        losses.append(loss.item())
        if tag and i == 0:
            res[tag + "/out0"] = o.numpy()
            res[tag + "/loss0"] = loss.numpy()
    return losses


def save(tag, m, losses=None):
    if losses is not None:
        res[tag + "/losses"] = np.asarray(losses)
    for n, t in m.get_states().items():
        res[f"{tag}/p/{n}"] = t.detach().numpy().copy()
    for n, s in m.optimizer._eager_state.items():
        if isinstance(s, dict) and "ef" in s:
            res[f"{tag}/ef/{n}"] = s["ef"].numpy().copy()


def digest(m):
    h = hashlib.sha256()
    for n in sorted(m.get_params()):
        h.update(m.get_params()[n].detach().numpy().tobytes())
    for n in sorted(m.optimizer._eager_state):
        h.update(m.optimizer._eager_state[n]["ef"].numpy().tobytes())
    return h.hexdigest()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def primitives():
    x = t(inp[f"prim{world}"][rank])
    for op in ("mean", "sum", "max"):
        res[f"prim/{op}"] = comm.allreduce(x, "data", op).numpy()
    res["prim/gather"] = comm.allgather(x, "data").numpy()
    res["prim/gather_tiled"] = comm.allgather(x, "data", tiled=True).numpy()
    res["prim/rs"] = comm.reduce_scatter(x, "data").numpy()
    ring = [(i, (i + 1) %% world) for i in range(world)]
    res["prim/ppermute"] = comm.ppermute(x, "data", ring).numpy()
    for s in range(world):
        res[f"prim/bcast{s}"] = comm.broadcast(x, "data", s).numpy()
    for n in QUANT_LENGTHS:
        q = t(inp[f"q{world}_{n}"][rank])
        r = t(inp[f"r{world}_{n}"][rank])
        res[f"q/int32/{n}"] = comm.quantized_allreduce(q, "data").numpy()
        res[f"q/int8/{n}"] = comm.quantized_allreduce(
            q, "data", wire="int8").numpy()
        o, e = comm.ef_quantized_allreduce(q, r, "data")
        res[f"q/ef_out/{n}"], res[f"q/ef_res/{n}"] = o.numpy(), e.numpy()
    res["topk"] = comm._topk_allreduce(t(inp[f"topk{world}"][rank]), "data",
                                       0.1).numpy()


def sequence():
    x = t(inp[f"prim{world}"][rank])
    comm.allreduce(x, "data", "sum")
    comm.allgather(x, "data")
    comm.reduce_scatter(x, "data")
    comm.ppermute(x, "data", [(i, (i + 1) %% world) for i in range(world)])
    comm.broadcast(x, "data", 1)
    comm.allreduce_grads({"a": x, "b": x * 2}, "data")
    comm.allreduce_grads({"a": x, "b": x * 2}, "data",
                         compress_dtype="int8_ring")
    comm.quantized_allreduce(x.reshape(-1), "data")
    comm.ef_quantized_allreduce(x.reshape(-1), torch.zeros(x.numel()),
                                "data")


def fault_site():
    with faults.active(faults.FaultPlan()) as plan:
        sequence()
    res["fault/calls"] = np.asarray(plan.calls.get("comm.collective", 0))
    spec = faults.FaultSpec("comm.collective", "error", at=FAULT_AT)
    try:
        with faults.active(faults.FaultPlan([spec])):
            sequence()
        res["fault/raised"] = np.asarray("")
    except faults.InjectedFault as e:
        res["fault/raised"] = np.asarray(str(e))
    # a DistOpt step fires its sync and its loss's allreduce
    m = fresh("plain")
    steps(m, "mlp32", 1)
    with faults.active(faults.FaultPlan()) as plan:
        steps(m, "mlp32", 1)
    res["fault/step_calls"] = np.asarray(plan.calls.get("comm.collective", 0))


def recording(fn, log):
    """fn, logging each call's gradient, residual, mean and new
    residual."""
    def wrapped(g, r, *a, **kw):
        out, new_r = fn(g, r, *a, **kw)
        log.append([x.detach().numpy().copy() for x in (g, r, out, new_r)])
        return out, new_r
    return wrapped


def training():
    for mode, (_, _, kind) in MODES.items():
        m = fresh(mode)
        if mode == "ring":
            log, real = [], comm.ef_quantized_allreduce
            comm.ef_quantized_allreduce = recording(real, log)
        save(mode, m, steps(m, kind, STEPS, tag=mode))
        if mode == "ring":
            comm.ef_quantized_allreduce = real
            for i, arrays in enumerate(log):
                for key, a in zip(("g", "r", "out", "res"), arrays):
                    res[f"ringlog/{i}/{key}"] = a
        if mode in ("plain", "zero1"):
            res[mode + "/slot_numel"] = np.asarray(sum(
                t.numel() for v in m.optimizer._eager_state.values()
                for t in opt._leaves(v)))
    # GradAccum(DistOpt(...)) is a plain optimizer to the executor, as in
    # the reference: no sync, the whole batch on every rank
    m = build("mlp32")
    m.set_optimizer(opt.GradAccum(opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9)),
                                  2))
    m.compile([data("mlp32")[0]], is_train=True, use_graph=True)
    save("outer_accum", m, steps(m, "mlp32", STEPS))
    m = build("bn")
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.05, momentum=0.9)))
    m.compile([data("bn")[0]], is_train=True, use_graph=True)
    save("bn", m, steps(m, "bn", 3, tag="bn"))
    # determinism: two independent int8-ring runs
    for i in (1, 2):
        m = fresh("ring")
        steps(m, "mlp32", 2)
        res[f"det/h{i}"] = np.asarray(digest(m))


def checkpoints():
    for mode in ("plain", "ring", "zero1"):
        path = os.path.join(out, f"ck_{mode}.npz")
        m = fresh(mode)
        steps(m, "mlp32", STEPS // 2)
        m.save_states(path)
        m2 = fresh(mode)
        m2.load_states(path)
        restored = all(
            torch.equal(a["ef"], m.optimizer._eager_state[n]["ef"])
            for n, a in m2.optimizer._eager_state.items()) \
            if mode == "ring" else True
        res[f"resume_{mode}/restored_bitwise"] = np.asarray(restored)
        save(f"resume_{mode}", m2, steps(m2, "mlp32", STEPS - STEPS // 2))
    m = fresh("plain")
    try:
        m.load_states(os.path.join(out, "ck_ring.npz"))
        res["xmode"] = np.asarray("")
    except ValueError as e:
        res["xmode"] = np.asarray(str(e))


def mesh_dropped():
    """set_mesh(None) after data-parallel steps: the executor keeps its
    mesh (outputs global, the loss replicated), a new executor runs
    single-process, and an eager update needs no group."""
    m = fresh("plain")
    steps(m, "mlp32", 2)
    parallel.set_mesh(None)
    x, y = data("mlp32")
    o, loss = m.train_step(x, y)
    res["nomesh/pinned_out"], res["nomesh/pinned_loss"] = o.numpy(), loss.numpy()
    o, loss = m.train_step(x[:4], y[:4])
    res["nomesh/new_out"], res["nomesh/new_loss"] = o.numpy(), loss.numpy()
    p = m.get_params()["head.W"]
    m.optimizer.update(p, torch.zeros_like(p))
    parallel.set_mesh(parallel.data_parallel_mesh())
    try:
        m.train_step(x[:7], y[:7])
        res["nodiv"] = np.asarray("")
    except ValueError as e:
        res["nodiv"] = np.asarray(str(e))


def cli():
    r = train_cnn.main(["--model", "mlp", "--dataset", "mnist", "--device",
                        "cpu", "--epochs", "1", "--batch-size", "64",
                        "--lr", "0.01", "--dist", "--log-every", "0"])
    res["cli/world"] = np.asarray(r["world"])
    res["cli/losses"] = np.asarray(r["epochs"][0]["losses"])
    parallel.distributed.assert_same_across_processes(
        r["epochs"][0]["losses"][-1])
    try:
        parallel.distributed.assert_same_across_processes(float(rank))
        res["cli/divergence"] = np.asarray("")
    except AssertionError as e:
        res["cli/divergence"] = np.asarray(str(e))


try:
    idx = parallel.init_distributed(f"127.0.0.1:{port}", world, rank,
                                    device="cpu")
    assert idx == rank and parallel.distributed.is_initialized()
    parallel.set_mesh(parallel.data_parallel_mesh())
    primitives()
    fault_site()
    if world == 2:
        training()
        checkpoints()
        mesh_dropped()
        cli()
    np.savez(os.path.join(out, f"w{world}_r{rank}.npz"), **res)
    parallel.finalize_distributed()
except BaseException:
    traceback.print_exc()
    sys.exit(1)
'''


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------

class JTinyBN(JClassifier):
    def __init__(self):
        super().__init__()
        self.conv = jlayer.Conv2d(4, 3, padding=1)
        self.bn = jlayer.BatchNorm2d(4)
        self.relu = jlayer.ReLU()
        self.flat = jlayer.Flatten()
        self.fc = jlayer.Linear(3)

    def forward(self, x):
        return self.fc(self.flat(self.relu(self.bn(self.conv(x)))))


def _mlp_data():
    rng = np.random.RandomState(123)
    X = rng.randn(8, 16).astype(np.float32)
    Y = rng.randint(0, 4, (8,)).astype(np.int32)
    return X, Y


def _bn_data():
    rng = np.random.RandomState(7)
    return (rng.randn(8, 6, 6, 2).astype(np.float32),
            rng.randint(0, 3, (8,)).astype(np.int32))


def _ref_model(kind):
    jtensor.set_seed(0)
    np.random.seed(0)
    if kind == "bn":
        return JTinyBN()
    return jmodels.MLP(perceptron_size=(128 if kind == "mlp128" else 32,),
                       num_classes=4)


def _ref_base(base):
    if base == "adafactor":
        return jopt.Adafactor(lr=1e-2, multiply_by_parameter_scale=False,
                              min_dim_size_to_factor=8)
    sgd = jopt.SGD(lr=0.1, momentum=0.9)
    return jopt.GradAccum(sgd, 2) if base == "accum" else sgd


@lru_cache(maxsize=None)
def _ref_init(kind):
    m = _ref_model(kind)
    x = _bn_data()[0] if kind == "bn" else _mlp_data()[0]
    m.compile([jtensor.from_numpy(x)], is_train=False, use_graph=False)
    m(jtensor.from_numpy(x))
    return {n: np.asarray(t.data) for n, t in m.get_states().items()}


def _ref_kwargs(kw):
    kw = eval(kw)   # the MODES table names torch dtypes for the port
    if kw.get("compress_dtype") is torch.bfloat16:
        kw["compress_dtype"] = jnp.bfloat16
    return kw


@lru_cache(maxsize=None)
def _ref_train(mode, world=2):
    """The reference's run of `mode` at `world` ranks: losses, the first
    step's outputs and loss, final states and residuals."""
    kw, base, kind = MODES[mode] if mode in MODES else ("{}", "sgd", mode)
    lr = 0.05 if kind == "bn" else None
    jparallel.set_mesh(jparallel.data_parallel_mesh(world))
    try:
        m = _ref_model(kind)
        b = jopt.SGD(lr=lr, momentum=0.9) if lr else _ref_base(base)
        m.set_optimizer(jopt.DistOpt(b, **_ref_kwargs(kw)))
        x, y = _bn_data() if kind == "bn" else _mlp_data()
        xt, yt = jtensor.from_numpy(x), jtensor.from_numpy(y)
        m.compile([xt], is_train=True, use_graph=True)
        init = _ref_init(kind)
        assert all(np.array_equal(np.asarray(t.data), init[n])
                   for n, t in m.get_states().items())
        out = {"losses": []}
        for i in range(3 if kind == "bn" else STEPS):
            o, loss = m.train_step(xt, yt)
            out["losses"].append(float(loss.to_numpy()))
            if i == 0:
                out["out0"] = np.asarray(o.data)
                out["loss0"] = np.asarray(loss.data)
        out["p"] = {n: np.asarray(t.data) for n, t in m.get_states().items()}
        ex = next(iter(m._executors.values()))
        out["ef"] = {n: np.asarray(s["ef"]) for n, s in ex.slots.items()
                     if isinstance(s, dict) and "ef" in s}
        return out
    finally:
        jparallel.set_mesh(None)


def _ref_map(fn, world, *arrays):
    """fn over each rank's row of `arrays` under shard_map on a data
    mesh of `world`: its outputs stacked by rank."""
    P = jparallel.mesh.P
    mesh = jparallel.data_parallel_mesh(world)

    def body(*xs):
        outs = fn(*[x[0] for x in xs])
        return tuple(o[None] for o in outs)
    f = jax.shard_map(body, mesh=mesh, in_specs=tuple(P("data")
                                                      for _ in arrays),
                      out_specs=P("data"), check_vma=False)
    return [np.asarray(o) for o in jax.jit(f)(*[jnp.asarray(a)
                                               for a in arrays])]


def _inputs(world):
    rng = np.random.RandomState(5 + world)
    arrays = {f"prim{world}": rng.randint(-64, 64, (world, 4, 3))
              .astype(np.float32) / 8.0,
              f"topk{world}": rng.permutation(world * 3000)
              .reshape(world, 3000).astype(np.float32) / 1e3
              * np.sign(rng.randn(world, 3000)).astype(np.float32)}
    for n in QUANT_LENGTHS:
        arrays[f"q{world}_{n}"] = rng.randn(world, n).astype(np.float32)
        arrays[f"r{world}_{n}"] = (rng.randn(world, n) * 1e-2).astype(
            np.float32)
    return arrays


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both port worlds, launched together: {W: [rank 0's results, ...]}
    and the directory they wrote to."""
    out = tmp_path_factory.mktemp("torch_dist")
    arrays = {}
    for kind in ("mlp32", "mlp128", "bn"):
        arrays.update({f"{kind}/{n}": a for n, a in _ref_init(kind).items()})
    arrays["X"], arrays["Y"] = _mlp_data()
    arrays["bnX"], arrays["bnY"] = _bn_data()
    for w in WORLDS:
        arrays.update(_inputs(w))
    np.savez(out / "inputs.npz", **arrays)
    script = WORKER % {"modes": repr(MODES), "lengths": QUANT_LENGTHS,
                       "steps": STEPS, "fault_at": FAULT_AT}
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK", "SINGA_COORDINATOR")}
    procs = {}
    for w in WORLDS:
        port = _free_port()
        procs[w] = [subprocess.Popen(
            [sys.executable, "-c", script, str(r), str(w), str(port),
             str(out), str(REPO)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(w)]
    logs = {}
    try:
        for w, ps in procs.items():
            for r, p in enumerate(ps):
                logs[(w, r)] = p.communicate(timeout=WORKER_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        pytest.fail(f"a worker of the port's gloo worlds hung past "
                    f"{WORKER_TIMEOUT_S} s")
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    bad = {k: v[-3000:] for k, v in logs.items()
           if procs[k[0]][k[1]].returncode != 0}
    assert not bad, f"port workers failed: {bad}"
    return ({w: [dict(np.load(out / f"w{w}_r{r}.npz")) for r in range(w)]
             for w in WORLDS}, out)


# ---------------------------------------------------------------------------
# 1-3. the communicator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_primitives_equal_the_reference_under_shard_map(worlds, world):
    """allreduce mean/sum/max, allgather (stacked and tiled),
    reduce_scatter, a forward-ring ppermute and broadcast from every
    source: exact."""
    got = worlds[0][world]
    x = _inputs(world)[f"prim{world}"]
    ring = [(i, (i + 1) % world) for i in range(world)]
    names = ["mean", "sum", "max", "gather", "gather_tiled", "rs",
             "ppermute"] + [f"bcast{s}" for s in range(world)]

    def body(v):
        outs = [jcomm.allreduce(v, "data", op) for op in ("mean", "sum",
                                                          "max")]
        outs += [jcomm.allgather(v, "data"),
                 jcomm.allgather(v, "data", tiled=True),
                 jcomm.reduce_scatter(v, "data"),
                 jcomm.ppermute(v, "data", ring)]
        return tuple(outs + [jcomm.broadcast(v, "data", s)
                             for s in range(world)])
    ref = _ref_map(body, world, x)
    for name, want in zip(names, ref):
        for r in range(world):
            np.testing.assert_array_equal(got[r][f"prim/{name}"], want[r],
                                          err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_quantized_allreduce_and_ring_are_bitwise_the_reference(worlds,
                                                               world):
    """quantized_allreduce with the int32 and the int8 wire, and the
    error-feedback ring's mean and residual, at lengths that are a
    multiple of 256·W and lengths that are not: bitwise."""
    got = worlds[0][world]
    arrays = _inputs(world)
    for n in QUANT_LENGTHS:
        ref = _ref_map(
            lambda q, r: (jcomm.quantized_allreduce(q, "data"),
                          jcomm.quantized_allreduce(q, "data", wire="int8"),
                          *jcomm.ef_quantized_allreduce(q, r, "data")),
            world, arrays[f"q{world}_{n}"], arrays[f"r{world}_{n}"])
        for key, want in zip(("int32", "int8", "ef_out", "ef_res"), ref):
            for r in range(world):
                np.testing.assert_array_equal(
                    got[r][f"q/{key}/{n}"], want[r],
                    err_msg=f"{key} n={n} rank {r} of {world}")


@pytest.mark.parametrize("world", WORLDS)
def test_topk_allreduce_matches_the_reference(worlds, world):
    """Fixed-K sparsified exchange on inputs of distinct magnitudes:
    within 1e-6."""
    got = worlds[0][world]
    ref = _ref_map(lambda g: (jcomm._topk_allreduce(g, "data", 0.1),),
                   world, _inputs(world)[f"topk{world}"])[0]
    for r in range(world):
        np.testing.assert_allclose(got[r]["topk"], ref[r], rtol=0,
                                   atol=TOPK_TOL)


def test_wire_byte_models_are_the_reference():
    from singa_tpu_torch.parallel import communicator as tcomm
    for n, w in ((8192, 8), (300, 2), (2055, 4), (10, 1)):
        assert tcomm.int8_ring_wire_bytes(n, w) == \
            jcomm.int8_ring_wire_bytes(n, w)
        assert tcomm.f32_ring_wire_bytes(n, w) == \
            jcomm.f32_ring_wire_bytes(n, w)


# ---------------------------------------------------------------------------
# 4-6. DistOpt training
# ---------------------------------------------------------------------------

def _close_but_flips(got, want, what):
    """Within 1e-5, but for the elements where an int8 code flipped:
    at most RING_FLIP_SHARE of them, each within RING_FLIP_TOL."""
    off = ~np.isclose(got, want, rtol=PARITY_TOL, atol=PARITY_TOL)
    assert off.mean() <= RING_FLIP_SHARE, (what, int(off.sum()), off.size)
    np.testing.assert_allclose(got, want, rtol=0, atol=RING_FLIP_TOL,
                               err_msg=what)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_distopt_w2_matches_the_reference(worlds, mode):
    """Every sync mode at W = 2 (SGD 0.1 / 0.9, or Adafactor, on
    tests/_mp_worker.py's MLP and data; the top-K case a 128-wide MLP
    so a tensor passes 1024 elements): losses and parameters within
    1e-5 of the reference's, and the ranks bitwise alike.

    The int8 ring's parameters and residuals are held so too but for
    flipped codes: the two packages' f32 gradients differ in their last
    bits (their products sum in other orders), and where a gradient
    lies at a quantization boundary its code differs by one, moving that
    element by lr × one grid step (absmax/127 ≈ 1e-3 here, so ~1e-4;
    the residual takes the step back on the next one).  Given the same
    gradients, the ring's sync is bitwise the reference's:
    test_distopt_ring_sync_is_bitwise_the_reference."""
    got = worlds[0][2]
    ref = _ref_train(mode)
    close = (_close_but_flips if mode == "ring" else
             lambda a, b, what: np.testing.assert_allclose(
                 a, b, rtol=PARITY_TOL, atol=PARITY_TOL, err_msg=what))
    for r in range(2):
        np.testing.assert_allclose(got[r][f"{mode}/losses"], ref["losses"],
                                   rtol=PARITY_TOL, atol=PARITY_TOL)
        for n, want in ref["p"].items():
            close(got[r][f"{mode}/p/{n}"], want, f"{mode} {n} rank {r}")
            np.testing.assert_array_equal(got[r][f"{mode}/p/{n}"],
                                          got[0][f"{mode}/p/{n}"])
        for n, want in ref["ef"].items():
            close(got[r][f"{mode}/ef/{n}"][0], want[r],
                  f"residual {n} rank {r}")
    assert (mode == "ring") == bool(ref["ef"])


def test_distopt_ring_sync_is_bitwise_the_reference(worlds):
    """Every int8-ring sync of the W = 2 run (4 steps, 4 tensors): the
    reference's ef_quantized_allreduce given both ranks' gradients and
    residuals returns the port's mean and new residual bitwise."""
    got = worlds[0][2]
    n = len({k.split("/")[1] for k in got[0] if k.startswith("ringlog/")})
    assert n == STEPS * len(_ref_init("mlp32"))

    def stack(i, key):
        return np.stack([got[r][f"ringlog/{i}/{key}"] for r in range(2)])
    for i in range(n):
        g, res = stack(i, "g"), stack(i, "r")
        res = np.broadcast_to(res, g.shape) if res.ndim == 1 else res
        out, new_res = _ref_map(
            lambda a, b: jcomm.ef_quantized_allreduce(a, b, "data"), 2,
            g, np.ascontiguousarray(res))
        np.testing.assert_array_equal(stack(i, "out"), out, err_msg=str(i))
        np.testing.assert_array_equal(stack(i, "res"), new_res,
                                      err_msg=str(i))


def test_plain_w2_equals_the_ports_w1_big_batch(worlds):
    """The port's own single-process run on the whole batch, plain SGD:
    within 1e-6 of its W = 2 run."""
    got = worlds[0][2][0]
    tparallel.set_mesh(None)
    cpu = tdevice.create_device("cpu")
    m = tmodels.MLP(perceptron_size=(32,), num_classes=4, input_shape=(16,),
                    device=cpu)
    tmodels.load_reference_states(m, _ref_init("mlp32"))
    m.set_optimizer(topt.SGD(lr=0.1, momentum=0.9))
    X, Y = (torch.from_numpy(a) for a in _mlp_data())
    m.compile([X], is_train=True, use_graph=True)
    losses = [m.train_step(X, Y)[1].item() for _ in range(STEPS)]
    np.testing.assert_allclose(got["plain/losses"], losses, rtol=0,
                               atol=BIG_BATCH_TOL)
    for n, t in m.get_params().items():
        np.testing.assert_allclose(got[f"plain/p/{n}"], t.detach().numpy(),
                                   rtol=0, atol=BIG_BATCH_TOL, err_msg=n)


def test_outer_grad_accum_runs_unsynced_as_the_reference(worlds):
    """GradAccum(DistOpt(SGD), 2) under the mesh: the executor sees a
    plain optimizer, as the reference's does, and every rank trains on
    the whole batch; within 1e-5 of the reference."""
    got = worlds[0][2]
    jparallel.set_mesh(jparallel.data_parallel_mesh(2))
    try:
        m = _ref_model("mlp32")
        m.set_optimizer(jopt.GradAccum(jopt.DistOpt(jopt.SGD(
            lr=0.1, momentum=0.9)), 2))
        X, Y = (jtensor.from_numpy(a) for a in _mlp_data())
        m.compile([X], is_train=True, use_graph=True)
        losses = [float(m.train_step(X, Y)[1].to_numpy())
                  for _ in range(STEPS)]
        params = {n: np.asarray(t.data) for n, t in m.get_params().items()}
    finally:
        jparallel.set_mesh(None)
    for r in range(2):
        np.testing.assert_allclose(got[r]["outer_accum/losses"], losses,
                                   rtol=PARITY_TOL, atol=PARITY_TOL)
        for n, want in params.items():
            np.testing.assert_allclose(got[r][f"outer_accum/p/{n}"], want,
                                       rtol=PARITY_TOL, atol=PARITY_TOL)


def test_zero1_slots_hold_one_shard_per_rank(worlds):
    """ZeRO-1's momentum holds ceil(n / W) elements of each parameter
    on each rank, against n in the plain run."""
    got = worlds[0][2][0]
    sizes = [a.size for a in _ref_init("mlp32").values()]
    assert int(got["plain/slot_numel"]) == sum(sizes)
    assert int(got["zero1/slot_numel"]) == sum(-(-n // 2) for n in sizes)


def test_batchnorm_buffers_are_mean_allreduced(worlds):
    """A tiny conv + BatchNorm classifier at W = 2, 3 steps: parameters
    and running statistics within 1e-5 of the reference's (each rank's
    statistics of its own rows, then their mean)."""
    got = worlds[0][2]
    ref = _ref_train("bn")
    for r in range(2):
        np.testing.assert_allclose(got[r]["bn/losses"], ref["losses"],
                                   rtol=PARITY_TOL, atol=PARITY_TOL)
        for n, want in ref["p"].items():
            np.testing.assert_allclose(got[r][f"bn/p/{n}"], want,
                                       rtol=PARITY_TOL, atol=PARITY_TOL,
                                       err_msg=f"{n} rank {r}")
    assert "bn.running_mean" in ref["p"]


def test_outputs_are_the_global_batch_and_the_loss_replicated(worlds):
    """A step's logits come back at the global batch on every rank and
    equal the reference's; the loss is a replicated scalar."""
    got = worlds[0][2]
    ref = _ref_train("plain")
    assert ref["out0"].shape == (8, 4) and ref["loss0"].shape == ()
    for r in range(2):
        assert got[r]["plain/out0"].shape == (8, 4)
        assert got[r]["plain/loss0"].shape == ()
        np.testing.assert_allclose(got[r]["plain/out0"], ref["out0"],
                                   rtol=PARITY_TOL, atol=PARITY_TOL)
        np.testing.assert_array_equal(got[r]["plain/loss0"],
                                      got[0]["plain/loss0"])


# ---------------------------------------------------------------------------
# 7-8. checkpoints and determinism, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "ring", "zero1"])
def test_kill_and_resume_is_bitwise(worlds, mode):
    """2 steps, save, a fresh model and optimizer restore, 2 more steps:
    the parameters (and the ring's residuals) equal the uninterrupted
    4-step run's bitwise on both ranks, and the ring's restored
    residuals are the saved ones."""
    got = worlds[0][2]
    for r in range(2):
        assert bool(got[r][f"resume_{mode}/restored_bitwise"])
        keys = [k for k in got[r] if k.startswith(f"{mode}/p/")
                or k.startswith(f"{mode}/ef/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(got[r][f"resume_{k}"], got[r][k],
                                          err_msg=f"{k} rank {r}")


def test_checkpoints_hold_the_references_layout(worlds):
    """The ring's residuals are saved as (world, *shape), every rank's
    row; ZeRO-1's slots at their parameters' natural shapes."""
    got, out = worlds
    init = _ref_init("mlp32")
    for mode, shape_of in (("ring", lambda s: (2,) + s),
                           ("zero1", lambda s: s)):
        arrays, aux = tcheckpoint.load_arrays(str(out / f"ck_{mode}.npz"))
        i = 0
        for name, n_leaves in aux["opt_slots"]:
            leaf = arrays[f"__opt__:{i + n_leaves - 1}"]
            assert leaf.shape == shape_of(init[name].shape), (mode, name)
            i += n_leaves
        if mode == "ring":
            ef = {n: got[2][r][f"resume_ring/ef/{n}"] for r in range(2)
                  for n in init}
            assert ef


def test_restores_across_modes_or_worlds_are_refused(worlds):
    """An int8-ring checkpoint into a plain DistOpt (at W = 2), and into
    an int8-ring DistOpt at another world size (here, 1): both raise."""
    got, out = worlds
    for r in range(2):
        assert "refusing to reinterpret" in str(got[2][r]["xmode"])
    tparallel.set_mesh(None)
    m = tmodels.MLP(perceptron_size=(32,), num_classes=4, input_shape=(16,),
                    device=tdevice.create_device("cpu"))
    m.set_optimizer(topt.DistOpt(topt.SGD(lr=0.1, momentum=0.9),
                                 compression="int8_ring"))
    with pytest.raises(ValueError, match="world size 2"):
        m.load_states(str(out / "ck_ring.npz"))


def test_int8_ring_runs_are_deterministic(worlds):
    """Two independent int8-ring runs at W = 2 hash to the same
    parameters and residuals, and so do the two ranks' parameters."""
    got = worlds[0][2]
    for r in range(2):
        assert str(got[r]["det/h1"]) == str(got[r]["det/h2"])


# ---------------------------------------------------------------------------
# 9-11. loader, bootstrap, fault site, train_cnn --dist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3])
def test_loader_shards_equal_the_references(world):
    x = np.arange(50 * 3, dtype=np.float32).reshape(50, 3)
    y = np.arange(50, dtype=np.int32)
    for r in range(world):
        kw = dict(batch_size=4, seed=3, rank=r, world_size=world)
        mine = list(tdata.DataLoader(x, y, **kw))
        theirs = list(jdata.DataLoader(x, y, use_native=False, **kw))
        assert len(mine) == len(theirs) > 0
        for (a, b), (c, d) in zip(mine, theirs):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_loader_refuses_bad_shards():
    x = np.zeros((3, 2), np.float32)
    for kw, msg in ((dict(rank=2, world_size=2), "outside world"),
                    (dict(rank=0, world_size=0), "world_size"),
                    (dict(rank=0, world_size=4), "shards to 0")):
        with pytest.raises(ValueError, match=msg):
            tdata.DataLoader(x, **kw)
        with pytest.raises(ValueError, match=msg):
            jdata.DataLoader(x, use_native=False, **kw)


def test_init_distributed_single_process_noop(monkeypatch):
    for k in ("SINGA_COORDINATOR", "COORDINATOR_ADDRESS", "SINGA_NUM_PROCS",
              "NUM_PROCESSES", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
              "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tparallel.init_distributed() == 0
    assert not tparallel.distributed.is_initialized()
    assert tparallel.data_parallel_mesh().shape == {"data": 1}


def test_only_the_data_axis_exists():
    # every axis of the reference exists since the pipeline and expert
    # slice; asking a mesh for an axis it lacks raises, as does a mesh
    # (a pipe axis among them) that the group's world does not fill
    with pytest.raises(ValueError, match="has no axis"):
        tparallel.make_mesh({"data": 1, "pipe": 1}).axis_size("expert")
    with pytest.raises(ValueError, match="needs 2 devices"):
        tparallel.make_mesh({"data": 1, "pipe": 2})
    with pytest.raises(ValueError, match="needs 2 devices"):
        tparallel.make_mesh({"data": 1, "model": 2})
    with pytest.raises(ValueError, match="unknown compression"):
        topt.DistOpt(topt.SGD(lr=0.1), compression="int4_ring")
    with pytest.raises(ValueError, match="exclusive"):
        topt.DistOpt(topt.SGD(lr=0.1), compression="int8_ring",
                     compress_dtype=torch.bfloat16)
    # ZeRO-1 updates flat shards: Adafactor's factored moments cannot
    with pytest.raises(NotImplementedError, match="elementwise"):
        topt.DistOpt(topt.Adafactor(), shard_weight_update=True)


def test_distopt_without_a_group_is_the_base_optimizer():
    """No mesh or no group: the sync is the identity, the half and
    partial calls restore their settings, and the signature and the
    residual slots are the reference's."""
    tparallel.set_mesh(tparallel.data_parallel_mesh())   # no group
    try:
        cpu = tdevice.create_device("cpu")
        X, Y = (torch.from_numpy(a) for a in _mlp_data())
        ms = []
        for wrap in (False, True):
            m = tmodels.MLP(perceptron_size=(32,), num_classes=4,
                            input_shape=(16,), device=cpu)
            tmodels.load_reference_states(m, _ref_init("mlp32"))
            base = topt.SGD(lr=0.1, momentum=0.9)
            m.set_optimizer(topt.DistOpt(base) if wrap else base)
            m.compile([X], is_train=True, use_graph=True)
            m.train_step(X, Y)
            ms.append(m)
        for n, t in ms[0].get_params().items():
            assert torch.equal(t, ms[1].get_params()[n]), n
        d = ms[1].optimizer
        d.backward_and_update_half(
            tautograd.softmax_cross_entropy(ms[1].forward(X), Y))
        assert d.compress_dtype is None
        d.backward_and_partial_update(
            tautograd.softmax_cross_entropy(ms[1].forward(X), Y),
            topk_ratio=0.25)
        assert d.topk_ratio == 0.0
        ring = topt.DistOpt(topt.Adam(lr=1e-2), compression="int8_ring")
        assert ring.state_signature() == "EF(int8_ring)>Adam"
        slot = ring.init_slot(torch.zeros(3, 2))
        assert sorted(slot) == ["base", "ef"] and slot["ef"].shape == (1, 3, 2)
    finally:
        tparallel.set_mesh(None)


@pytest.mark.parametrize("world", WORLDS)
def test_comm_collective_fault_site_fires_as_the_reference(worlds, world):
    """The same sequence of staged collectives fires ``comm.collective``
    as often in the port (eagerly, once) as in the reference (one
    trace), and a plan's error at call 5 raises at the same collective;
    one DistOpt step fires twice (the sync and the loss)."""
    got = worlds[0][world]
    x = _inputs(world)[f"prim{world}"]

    def sequence(v):
        jcomm.allreduce(v, "data", "sum")
        jcomm.allgather(v, "data")
        jcomm.reduce_scatter(v, "data")
        jcomm.ppermute(v, "data", [(i, (i + 1) % world)
                                   for i in range(world)])
        jcomm.broadcast(v, "data", 1)
        jcomm.allreduce_grads({"a": v, "b": v * 2}, "data")
        jcomm.allreduce_grads({"a": v, "b": v * 2}, "data",
                              compress_dtype="int8_ring")
        jcomm.quantized_allreduce(v.reshape(-1), "data")
        jcomm.ef_quantized_allreduce(v.reshape(-1), jnp.zeros(v.size),
                                     "data")
        return (v,)
    with jfaults.active(jfaults.FaultPlan()) as plan:
        _ref_map(sequence, world, x)
    calls = plan.calls.get("comm.collective", 0)
    spec = jfaults.FaultSpec("comm.collective", "error", at=FAULT_AT)
    with pytest.raises(jfaults.InjectedFault) as e:
        with jfaults.active(jfaults.FaultPlan([spec])):
            _ref_map(sequence, world, x)
    for r in range(world):
        assert int(got[r]["fault/calls"]) == calls
        assert str(got[r]["fault/raised"]) == str(e.value)
        assert int(got[r]["fault/step_calls"]) == 2


def test_set_mesh_none_keeps_the_executor_and_frees_new_ones(worlds):
    """After set_mesh(None) the executor made under the mesh still runs
    data-parallel (global outputs, a replicated loss), a new executor
    (another batch shape) runs on each rank's own batch with no
    collective, and an eager update runs (the worker would raise)."""
    got = worlds[0][2]
    for r in range(2):
        assert got[r]["nomesh/pinned_out"].shape == (8, 4)
        assert got[r]["nomesh/new_out"].shape == (4, 4)
        np.testing.assert_array_equal(got[r]["nomesh/pinned_loss"],
                                      got[0]["nomesh/pinned_loss"])


def test_a_batch_that_does_not_split_raises(worlds):
    """7 rows over 2 ranks: the data-parallel step refuses them."""
    for r in range(2):
        assert "not divisible by 2" in str(worlds[0][2][r]["nodiv"])


def test_train_cnn_dist_trains_replicated(worlds):
    """tools/train_cnn --dist at W = 2 on the CPU: each rank its shard,
    the loss replicated, equal on both ranks and finite;
    assert_same_across_processes passes on it and fails on the ranks'
    own numbers."""
    got = worlds[0][2]
    for r in range(2):
        assert "divergence: max=1.0 min=0.0" in str(got[r]["cli/divergence"])
        assert int(got[r]["cli/world"]) == 2
        assert np.isfinite(got[r]["cli/losses"]).all()
        np.testing.assert_array_equal(got[r]["cli/losses"],
                                      got[0]["cli/losses"])
