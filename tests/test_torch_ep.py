"""The port's expert parallelism (layer.MoE's experts cut over an
``expert`` mesh axis, ``ops.moe.moe_partial`` and the sum over the axis,
DistOpt over data × expert, checkpoints at full shapes) against the JAX
package's single-device MoE.

The reference runs in this process: its ``moe_forward`` under
``jax.value_and_grad`` (the setup of tests/test_moe.py's _MoENet: a MoE
layer of 4 experts, ffn 16, capacity factor 2.0, then a Linear to 4
classes; softmax cross-entropy plus 0.01 × the balance loss; SGD 0.05),
and its tiny MoE Llama's single-device training.  The port runs as one
gloo world of 4 processes, launched once for the module before the
reference's runs, each running the scenarios of `WORKER` under
{'expert': 4}, {'data': 2, 'expert': 2} and {'data': 2, 'model': 2}.

Tolerances: the layer's output, aux loss and every gradient (router and
each expert weight included), and the models' losses and parameters,
rtol 2e-4 / atol 2e-5 against the reference (the pipeline tests'
bound); a checkpoint's blocks bitwise.
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

from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.ops.moe import moe_forward as jmoe_forward
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.ops import moe as tmoe
from singa_tpu_torch.parallel import mesh as tmesh

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
RTOL, ATOL = 2e-4, 2e-5
WORKER_TIMEOUT_S = 240
NET_STEPS, NET_LR = 5, 0.05
LLAMA_STEPS, LLAMA_LR, LLAMA_SEED = 3, 0.1, 5
NET_MESHES = {"e4": {"expert": 4}, "d2e2": {"data": 2, "expert": 2}}
LLAMA_MESHES = {"d2e2": {"data": 2, "expert": 2},
                # the token cut is the same under a model axis: MoE's
                # capacity and balance loss are the whole batch's
                "d2m2": {"data": 2, "model": 2}}
N, D, E, H, C = 32, 8, 4, 16, 4
MOE_CFG = {"num_experts": 4, "moe_top_k": 2}

WORKER = r'''
import os, sys, traceback
sys.path.insert(0, sys.argv[5])
import numpy as np
import torch
torch.set_num_threads(1)
from singa_tpu_torch import autograd, device, layer, model, models, opt
from singa_tpu_torch import parallel
from singa_tpu_torch.opt import param_name

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
CPU = device.create_device("cpu")
inp = dict(np.load(os.path.join(out, "inputs.npz")))
NET_MESHES, LLAMA_MESHES = %(net)r, %(llama)r
NET_STEPS, NET_LR, LLAMA_STEPS, LLAMA_LR = %(steps)r
MOE_CFG = %(moe_cfg)r
res = {}


class Net(model.Model):
    """tests/test_moe.py's _MoENet: MoE(4 experts, ffn 16, cf 2.0), then
    a Linear to 4 classes."""

    def __init__(self):
        super().__init__(device=CPU)
        self.moe = layer.MoE(4, ffn_dim=16, capacity_factor=2.0, dim=8,
                             device=CPU)
        self.fc = layer.Linear(4, 8, device=CPU)
        self.set_params({k[4:]: v for k, v in inp.items()
                         if k.startswith("net/")})

    def forward(self, x):
        return self.fc(self.moe(x))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        aux = self.moe.pop_aux_loss()
        self.aux = aux.detach()
        loss = autograd.softmax_cross_entropy(out, y) + aux * 0.01
        self.optimizer.backward_and_update(loss)
        return out, loss


def hooked(m):
    first = {}
    update = m.optimizer.update

    def hook(p, g):
        if "done" not in first:
            first[param_name(p)] = g.detach().clone()
        update(p, g)
    m.optimizer.update = hook
    return first


def net(tag, axes):
    parallel.set_mesh(parallel.make_mesh(axes))
    m = Net()
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=NET_LR)))
    x, y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])
    m.compile([x], is_train=True, use_graph=True)
    first = hooked(m)
    losses = []
    for i in range(NET_STEPS):
        o, loss = m.train_step(x, y)
        if i == 0:
            res[f"net/{tag}/out"] = o.numpy()
            res[f"net/{tag}/aux"] = m.aux.numpy()
            first["done"] = True
        losses.append(loss.item())
    res[f"net/{tag}/losses"] = np.asarray(losses)
    for n, p in m.get_params().items():
        res[f"net/{tag}/g/{n}"] = first[n].numpy()
        res[f"net/{tag}/p/{n}"] = p.detach().numpy().copy()
        res[f"net/{tag}/spec/{n}"] = np.asarray(repr(tuple(p.tp_spec)))
    if tag == "d2e2":
        m.save_states(os.path.join(out, "ep_ck.npz"))
    parallel.set_mesh(None)


def llama(tag, axes):
    parallel.set_mesh(parallel.make_mesh(axes))
    cfg = models.LlamaConfig(**{**vars(models.LlamaConfig.tiny()),
                                **MOE_CFG})
    m = models.Llama(cfg, device=CPU)
    models.load_reference_states(m, {k[6:]: v for k, v in inp.items()
                                     if k.startswith("llama/")})
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=LLAMA_LR)))
    ids = torch.from_numpy(inp["ids"])
    m.compile([ids], is_train=True, use_graph=True)
    res[f"llama/{tag}/losses"] = np.asarray(
        [m.train_step(ids)[1].item() for _ in range(LLAMA_STEPS)])
    for n, p in m.get_params().items():
        res[f"llama/{tag}/p/{n}"] = p.detach().numpy().copy()
        res[f"llama/{tag}/spec/{n}"] = np.asarray(repr(tuple(p.tp_spec)))
    parallel.set_mesh(None)


try:
    parallel.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    for tag, axes in NET_MESHES.items():
        net(tag, axes)
    for tag, axes in LLAMA_MESHES.items():
        llama(tag, axes)
    np.savez(os.path.join(out, f"r{rank}.npz"), **res)
    parallel.finalize_distributed()
except BaseException:
    traceback.print_exc()
    sys.exit(1)
'''


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------

def _net_weights():
    rng = np.random.RandomState(4)
    return {"moe.router": rng.randn(D, E).astype(np.float32) * 0.5,
            "moe.w_in": rng.randn(E, D, H).astype(np.float32) * 0.3,
            "moe.w_out": rng.randn(E, H, D).astype(np.float32) * 0.3,
            "fc.W": rng.randn(D, C).astype(np.float32) * 0.3,
            "fc.b": np.zeros(C, np.float32)}


def _batch():
    rng = np.random.RandomState(1)
    return (rng.randn(N, D).astype(np.float32),
            rng.randint(0, C, N).astype(np.int32))


def _ref_net_loss(w, x, y):
    out, aux = jmoe_forward(x, w["moe.router"], w["moe.w_in"],
                            w["moe.w_out"], capacity_factor=2.0,
                            return_aux=True, top_k=1,
                            dispatch_mode="scatter")
    logits = out @ w["fc.W"] + w["fc.b"]
    ce = -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                       y[:, None], axis=1))
    return ce + 0.01 * aux, (logits, aux)


@lru_cache(maxsize=None)
def _ref_net():
    """The reference's first step (logits, aux loss, gradients) and the
    losses of NET_STEPS SGD steps."""
    x, y = (jnp.asarray(a) for a in _batch())
    w = {k: jnp.asarray(v) for k, v in _net_weights().items()}
    vg = jax.jit(jax.value_and_grad(_ref_net_loss, has_aux=True))
    (loss, (logits, aux)), g = vg(w, x, y)
    first = (np.asarray(logits), float(aux),
             {k: np.asarray(v) for k, v in g.items()})
    losses = []
    for _ in range(NET_STEPS):
        (loss, _), gs = vg(w, x, y)
        losses.append(float(loss))
        w = {k: w[k] - NET_LR * gs[k] for k in w}
    return first, losses, {k: np.asarray(v) for k, v in w.items()}


def _ids():
    return np.random.RandomState(0).randint(0, 256, (4, 16)).astype(np.int32)


def _ref_llama():
    jtensor.set_seed(LLAMA_SEED)
    np.random.seed(LLAMA_SEED)
    return jmodels.Llama(jmodels.LlamaConfig(
        **{**vars(jmodels.LlamaConfig.tiny()), **MOE_CFG}))


@lru_cache(maxsize=None)
def _ref_llama_init():
    m = _ref_llama()
    ids = jtensor.from_numpy(_ids())
    m.compile([ids], is_train=False, use_graph=False)
    m(ids)
    return {n: np.asarray(t.data) for n, t in m.get_states().items()}


@lru_cache(maxsize=None)
def _ref_llama_run():
    m = _ref_llama()
    m.set_optimizer(jopt.SGD(lr=LLAMA_LR))
    ids = jtensor.from_numpy(_ids())
    m.compile([ids], is_train=True, use_graph=True)
    init = _ref_llama_init()
    assert all(np.array_equal(np.asarray(t.data), init[n])
               for n, t in m.get_states().items())
    losses = [float(m.train_step(ids)[1].to_numpy())
              for _ in range(LLAMA_STEPS)]
    return losses, {n: np.asarray(t.data) for n, t in m.get_params().items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's world of 4, launched before the reference's runs: [rank
    0's results, ...] and their directory."""
    out = tmp_path_factory.mktemp("torch_ep")
    x, y = _batch()
    arrays = {"x": x, "y": y, "ids": _ids()}
    arrays.update({f"net/{k}": v for k, v in _net_weights().items()})
    arrays.update({f"llama/{k}": v for k, v in _ref_llama_init().items()})
    np.savez(out / "inputs.npz", **arrays)
    script = WORKER % {"net": NET_MESHES, "llama": LLAMA_MESHES,
                       "steps": (NET_STEPS, NET_LR, LLAMA_STEPS, LLAMA_LR),
                       "moe_cfg": MOE_CFG}
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK", "SINGA_COORDINATOR")}
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(WORLD), str(port),
         str(out), str(REPO)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = {}
    try:
        _ref_net()
        _ref_llama_run()
        for r, p in enumerate(procs):
            logs[r] = p.communicate(timeout=WORKER_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        pytest.fail(f"a worker of the port's gloo world hung past "
                    f"{WORKER_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = {r: v[-3000:] for r, v in logs.items() if procs[r].returncode}
    assert not bad, f"port workers failed: {bad}"
    return [dict(np.load(out / f"r{r}.npz")) for r in range(WORLD)], out


def _coords(axes, rank):
    return dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))


def _slice(full, spec, axes, rank):
    c = _coords(axes, rank)
    for d, ax in enumerate(spec):
        if ax is not None:
            n = full.shape[d] // axes[ax]
            full = np.take(full, range(c[ax] * n, (c[ax] + 1) * n), axis=d)
    return full


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", list(NET_MESHES))
def test_moe_layer_matches_the_reference_single_device(world, tag):
    """_MoENet under `tag`'s mesh, each rank holding E/ep experts: the
    first step's logits (gathered), aux loss and every gradient DistOpt
    applies (the router's: the combine's share summed over the expert
    ranks, the balance loss's once; each rank's experts') are the
    reference's single-device ones, and so are the losses of the
    following steps and the parameters after them."""
    axes = NET_MESHES[tag]
    (logits, aux, grads), losses, final = _ref_net()
    ep = axes["expert"]
    for i, r in enumerate(world[0]):
        assert r[f"net/{tag}/p/moe.w_in"].shape[0] == E // ep
        np.testing.assert_allclose(r[f"net/{tag}/out"], logits, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(r[f"net/{tag}/aux"], aux, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(r[f"net/{tag}/losses"], losses,
                                   rtol=RTOL, atol=ATOL)
        for n in grads:
            spec = eval(str(r[f"net/{tag}/spec/{n}"]))
            np.testing.assert_allclose(
                r[f"net/{tag}/g/{n}"], _slice(grads[n], spec, axes, i),
                rtol=RTOL, atol=ATOL, err_msg=f"grad {n} rank {i}")
            np.testing.assert_allclose(
                r[f"net/{tag}/p/{n}"], _slice(final[n], spec, axes, i),
                rtol=RTOL, atol=ATOL, err_msg=f"param {n} rank {i}")


def test_expert_checkpoint_holds_full_shapes(world):
    """The checkpoint of the run at {'data': 2, 'expert': 2} holds every
    expert (each rank's block its slice, bitwise) and loads into a
    single-device model."""
    from singa_tpu_torch import layer, model
    ranks, out = world
    ck = dict(np.load(out / "ep_ck.npz"))
    axes = NET_MESHES["d2e2"]
    assert ck["moe.w_in"].shape == (E, D, H)
    for i, r in enumerate(ranks):
        for n in _net_weights():
            spec = eval(str(r[f"net/d2e2/spec/{n}"]))
            assert np.array_equal(_slice(ck[n], spec, axes, i),
                                  r[f"net/d2e2/p/{n}"]), (n, i)
    cpu = tdevice.create_device("cpu")
    m = model.Model(device=cpu)
    m.moe = layer.MoE(E, ffn_dim=H, capacity_factor=2.0, dim=D, device=cpu)
    m.fc = layer.Linear(C, D, device=cpu)
    m.load_states(str(out / "ep_ck.npz"))
    for n, p in m.get_params().items():
        assert np.array_equal(p.detach().numpy(), ck[n])


# ---------------------------------------------------------------------------
# a MoE Llama
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", list(LLAMA_MESHES))
def test_moe_llama_trains_as_the_reference_single_device(world, tag):
    """Tiny Llama with 4 top-2 experts through DistOpt under data ×
    expert, and under data × model, whose step cuts the tokens alike:
    the losses and parameters are the reference's single-device ones
    (the capacity and the balance loss are the whole batch's, as the
    reference's GSPMD step computes them)."""
    axes = LLAMA_MESHES[tag]
    losses, final = _ref_llama_run()
    for i, r in enumerate(world[0]):
        np.testing.assert_allclose(r[f"llama/{tag}/losses"], losses,
                                   rtol=RTOL, atol=ATOL)
        for n, want in final.items():
            spec = eval(str(r[f"llama/{tag}/spec/{n}"]))
            np.testing.assert_allclose(
                r[f"llama/{tag}/p/{n}"], _slice(want, spec, axes, i),
                rtol=RTOL, atol=ATOL, err_msg=f"{n} rank {i}")


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------

def test_auto_resolves_by_the_mesh():
    """'auto' is the einsum dispatch under an expert axis above 1 and the
    scatter dispatch otherwise, as the reference resolves it."""
    try:
        for axes, want in (({"expert": 2}, "einsum"),
                           ({"data": 2, "expert": 4}, "einsum"),
                           ({"expert": 1}, "scatter"),
                           ({"data": 2}, "scatter")):
            tmesh.set_mesh(tmesh.Mesh(axes))
            assert tmoe.resolve_dispatch("auto") == want, axes
        tmesh.set_mesh(None)
        assert tmoe.resolve_dispatch("auto") == "scatter"
        assert tmoe.resolve_dispatch("scatter") == "scatter"
    finally:
        tmesh.set_mesh(None)


@pytest.mark.parametrize("mode", ["einsum", "scatter"])
@pytest.mark.parametrize("cf,k,gate", [(4.0, 1, False), (0.6, 2, True)])
@pytest.mark.parametrize("ep", [2, 4])
def test_expert_shares_sum_to_the_reference(mode, cf, k, gate, ep):
    """ep ranks' shares (moe_partial, in one process) summed: the output
    and the gradients of Σ out² + aux, router included, equal the
    reference's single-device moe_forward, capacity drops included."""
    rng = np.random.RandomState(7)
    x = rng.randn(24, D).astype(np.float32)
    rw = rng.randn(D, E).astype(np.float32)
    wi = rng.randn(E, D, H).astype(np.float32) * 0.3
    wo = rng.randn(E, H, D).astype(np.float32) * 0.3
    wg = rng.randn(E, D, H).astype(np.float32) * 0.3 if gate else None

    def ref(rw, wi, wo, wg):
        out, aux = jmoe_forward(jnp.asarray(x), rw, wi, wo,
                                capacity_factor=cf, return_aux=True,
                                top_k=k, w_gate=wg, dispatch_mode="scatter")
        return jnp.sum(out ** 2) + aux, out
    args = [jnp.asarray(a) for a in (rw, wi, wo)] + \
        [None if wg is None else jnp.asarray(wg)]
    (_, want), g = jax.value_and_grad(
        ref, argnums=(0, 1, 2, 3) if gate else (0, 1, 2),
        has_aux=True)(*args)
    ts = [torch.from_numpy(a).requires_grad_() if a is not None else None
          for a in (rw, wi, wo, wg)]
    El = E // ep
    out, aux = None, None
    for r in range(ep):
        sl = slice(r * El, (r + 1) * El)
        o, a = tmoe.moe_partial(
            torch.from_numpy(x), ts[0], ts[1][sl], ts[2][sl], cf, k,
            None if wg is None else ts[3][sl], mode, r * El)
        out = o if out is None else out + o
        aux = a if aux is None else aux
    got = torch.autograd.grad((out ** 2).sum() + aux,
                              [t for t in ts if t is not None])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(got, g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
