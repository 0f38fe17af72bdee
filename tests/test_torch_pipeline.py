"""The port's pipeline stages (parallel.pipeline, layer.PipelineStack,
Llama and GPT-2 with ``pipeline_stages``, DistOpt's pipe sync, pipelined
checkpoints) against the JAX package.

The reference runs in this process: its sequential single-device runs
of the same models from the same weights (its own pipelined runs are
held to those at rtol 2e-4 / atol 2e-5, tests/test_pipeline.py), and its
``gpipe`` body under ``shard_map`` on the conftest's virtual CPU mesh.
The port runs as gloo worlds of 2, 4 and 8 processes, launched together
once for the module before the reference's runs, each running the
scenarios of `WORKER` (torch, numpy and singa_tpu_torch only) and writing
what it got to an .npz; inputs and the reference models' initial states
reach the workers through ``inputs.npz``.

Tolerances:
  * losses, the first step's gradients (every class of parameter: a
    stage's blocks, the embedding, the final norm, the head) and the
    parameters after the steps, against the reference's sequential run:
    rtol 2e-4, atol 2e-5;
  * gpipe's output and gradients against the reference's gpipe: rtol
    1e-5 / atol 1e-6 and rtol 1e-4 / atol 1e-5 (tests/test_pipeline.py's);
  * within the port: replicated parameters across ranks and a
    checkpoint's round trip bitwise; a masked stack against the port's
    own single-device stack 1e-5.
"""

import os
import socket
import subprocess
import sys
import warnings
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import parallel as jparallel
from singa_tpu import tensor as jtensor
from singa_tpu.parallel import pipeline as jpp
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import kernel_check as kc
from singa_tpu_torch import models as tmodels
from singa_tpu_torch.parallel import pipeline as tpp

REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 4, 8)
STEPS = 3
LR = 0.1
RTOL, ATOL = 2e-4, 2e-5
WORKER_TIMEOUT_S = 240
LLAMA_SEED, GPT2_SEED = 5, 3
LAYERS = {"llama": 4, "gpt2": 2}
B, T = 8, 16

# tag: (model, mesh axes, config changes); each runs in the world of its
# mesh's size, SGD(LR) through DistOpt for STEPS steps
RUNS = {
    "llama_p2": ("llama", {"pipe": 2}, {"pipeline_stages": 2}),
    "gpt2_p2": ("gpt2", {"pipe": 2}, {"pipeline_stages": 2}),
    "llama_dp": ("llama", {"data": 2, "pipe": 2}, {"pipeline_stages": 2}),
    "llama_dp_m4": ("llama", {"data": 2, "pipe": 2},
                    {"pipeline_stages": 2, "pipeline_microbatches": 4}),
    "llama_dp_remat": ("llama", {"data": 2, "pipe": 2},
                       {"pipeline_stages": 2, "remat": True}),
    "llama_p4": ("llama", {"pipe": 4},
                 {"pipeline_stages": 4, "pipeline_microbatches": 8}),
    "llama_dmp": ("llama", {"data": 2, "model": 2, "pipe": 2},
                  {"pipeline_stages": 2}),
}
# the reference's gpipe test: S stages of relu(x W + b) over N_MICRO
# microbatches of MB rows of width D
GPIPE = dict(S=4, N_MICRO=8, MB=4, D=16)

WORKER = r'''
import os, sys, traceback, warnings
sys.path.insert(0, sys.argv[5])
import numpy as np
import torch
torch.set_num_threads(1)
from singa_tpu_torch import autograd, device, layer, models, opt, parallel
from singa_tpu_torch.opt import param_name
from singa_tpu_torch.parallel import pipeline

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
CPU = device.create_device("cpu")
inp = dict(np.load(os.path.join(out, "inputs.npz")))
RUNS = %(runs)r
LAYERS = %(layers)r
GPIPE = %(gpipe)r
STEPS, LR = %(steps)d, %(lr)r
res = {}


def build(kind, changes):
    pre = kind + "/"
    changes = {"num_layers": LAYERS[kind], **changes}
    if kind == "llama":
        cfg = models.LlamaConfig(**{**vars(models.LlamaConfig.tiny()),
                                    **changes})
        m = models.Llama(cfg, device=CPU)
    else:
        cfg = models.GPT2Config(**{**vars(models.GPT2Config.tiny()),
                                   **changes})
        m = models.GPT2(cfg, device=CPU,
                        generator=torch.Generator().manual_seed(0))
    if not changes.get("num_experts"):       # MoE: the model's own init
        models.load_reference_states(
            m, {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)})
    return m


def fresh(kind, axes, changes, momentum=0.0):
    parallel.set_mesh(parallel.make_mesh(axes))
    m = build(kind, changes)
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=LR, momentum=momentum)))
    ids = torch.from_numpy(inp["ids"])
    m.compile([ids], is_train=True, use_graph=True)
    return m, ids


def train(tag, kind, axes, changes):
    m, ids = fresh(kind, axes, changes)
    first = {}
    update = m.optimizer.update

    def hook(p, g):
        if not first.get("done"):
            first[param_name(p)] = g.detach().clone()
        update(p, g)
    m.optimizer.update = hook
    losses = []
    for _ in range(STEPS):
        losses.append(m.train_step(ids)[1].item())
        first["done"] = True
    res[tag + "/losses"] = np.asarray(losses)
    for n, p in m.get_params().items():
        res[f"{tag}/p/{n}"] = p.detach().numpy().copy()
        res[f"{tag}/g/{n}"] = first[n].numpy()
        res[f"{tag}/spec/{n}"] = np.asarray(repr(tuple(p.tp_spec)))
        res[f"{tag}/stage/{n}"] = np.asarray(
            -1 if pipeline.stage_of(p) is None else pipeline.stage_of(p))
    dead = pipeline.held_elsewhere(m)
    res[tag + "/dead"] = np.asarray(len(dead))
    res[tag + "/dead_numel"] = np.asarray(sum(
        dict(m.named_parameters())[n].numel() for n in dead))
    res[tag + "/gspmd"] = np.asarray(next(iter(m._executors.values())).gspmd)
    parallel.set_mesh(None)
    return m, ids


def gpipe():
    """The reference's gpipe case on a pipe axis of GPIPE['S']."""
    parallel.set_mesh(parallel.make_mesh({"pipe": GPIPE["S"]}))
    W = torch.from_numpy(inp["gpipe_W"]).requires_grad_()
    b = torch.from_numpy(inp["gpipe_b"]).requires_grad_()
    x = torch.from_numpy(inp["gpipe_x"])
    body = pipeline.gpipe(lambda p, h: torch.relu(h @ p["W"] + p["b"]),
                          GPIPE["N_MICRO"])
    o = body({"W": W, "b": b}, x)
    gW, gb = torch.autograd.grad((o ** 2).sum(), (W, b))
    res["gpipe/out"], res["gpipe/gW"], res["gpipe/gb"] = (
        o.detach().numpy(), gW.numpy(), gb.numpy())
    parallel.set_mesh(None)


def masked():
    """GPT-2's blocks as a cut stack with a padding mask as the extra:
    features and the gradients of their mean square, pipelined."""
    parallel.set_mesh(parallel.make_mesh({"pipe": 2}))
    m = build("gpt2", {"pipeline_stages": 2})
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=LR)))
    ids = torch.from_numpy(inp["ids"])
    mask = torch.from_numpy(inp["mask"])
    m.compile([ids], is_train=True, use_graph=True)
    autograd.set_training(True)
    f = m.features(ids, mask)
    params = m.get_params()
    grads = torch.autograd.grad((f ** 2).mean(), list(params.values()),
                                allow_unused=True)
    autograd.set_training(False)
    res["masked/f"] = f.detach().numpy()
    for (n, p), g in zip(params.items(), grads):
        if pipeline.stage_of(p) is not None:
            res[f"masked/g/{n}"] = g.numpy()
    parallel.set_mesh(None)


def fallbacks():
    """Blocks with dropout, and MoE blocks: the stack is not cut, warns
    as the reference, and trains sequentially on every rank."""
    for tag, kind, changes in (
            ("dropout", "gpt2", {"pipeline_stages": 2, "dropout": 0.1}),
            ("moe", "llama", {"pipeline_stages": 2, "num_experts": 2})):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m, ids = fresh(kind, {"pipe": 2}, changes)
            losses = [m.train_step(ids)[1].item() for _ in range(2)]
        res[f"fallback/{tag}/losses"] = np.asarray(losses)
        res[f"fallback/{tag}/warned"] = np.asarray(
            [str(w.message) for w in caught
             if "running sequentially" in str(w.message)][:1] or [""])
        res[f"fallback/{tag}/cut"] = np.asarray(m.blocks.cut is not None)
        parallel.set_mesh(None)


class Blk(layer.Layer):
    """h -> tanh(h W + b + e): a block with one extra."""

    def __init__(self, i, d):
        super().__init__(device=CPU)
        self.fc = layer.Linear(d, d, device=CPU,
                               generator=torch.Generator().manual_seed(i))

    def forward(self, h, e):
        return torch.tanh(self.fc(h) + e)


def cut_extras():
    """A stack of 4 Blks cut into 2 stages, called in training with an
    extra that is not batch-leading, and with one that carries a
    gradient; beside the uncut stack's results on the same inputs."""
    x = torch.from_numpy(inp["gpipe_x"][0])          # (MB, D)
    d = x.shape[-1]
    e = torch.linspace(-0.5, 0.5, d)                 # (D,): not batch-leading
    stacks = [layer.PipelineStack([Blk(i, d) for i in range(4)], 2)
              for _ in range(2)]
    mesh = parallel.make_mesh({"pipe": 2})
    pipeline.shard_stages(stacks[1], mesh)
    autograd.set_training(True)
    try:
        for tag, st in (("seq", stacks[0]), ("cut", stacks[1])):
            parallel.set_mesh(mesh if tag == "cut" else None)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                xg = x.clone().requires_grad_(True)
                y = st(xg, e)
            ps = [p for p in st.parameters() if getattr(p, "pipe_held", True)]
            grads = torch.autograd.grad((y ** 2).sum(), [xg] + ps)
            res[f"extras/{tag}/y"] = y.detach().numpy()
            res[f"extras/{tag}/gx"] = grads[0].numpy()
            for (n, p), g in zip([(n, p) for n, p in st.named_parameters()
                                  if getattr(p, "pipe_held", True)],
                                 grads[1:]):
                res[f"extras/{tag}/g/{n}"] = g.numpy()
            res[f"extras/{tag}/warned"] = np.asarray(
                " | ".join(str(w.message) for w in caught))
        try:
            stacks[1](x, e.clone().requires_grad_(True))
            res["extras/grad_refused"] = np.asarray("")
        except ValueError as err:
            res["extras/grad_refused"] = np.asarray(str(err))
    finally:
        autograd.set_training(False)
        parallel.set_mesh(None)


def checkpoint(m, ids):
    """The pipelined run's checkpoint (every block) and its eval logits;
    then a fresh pipelined model loads the sequential checkpoint."""
    parallel.set_mesh(parallel.make_mesh({"pipe": 2}))
    m.save_states(os.path.join(out, "pp_ck.npz"))
    m.eval()
    res["ck/logits"] = m(ids).numpy()
    try:
        m.init_caches(2, 32)
        res["ck/decode_refused"] = np.asarray(False)
    except NotImplementedError as e:
        res["ck/decode_refused"] = np.asarray("pipeline stages" in str(e))
    m2, _ = fresh("llama", {"pipe": 2}, {"pipeline_stages": 2}, 0.9)
    aux = m2.load_states(os.path.join(out, "seq_ck.npz"))
    seq = dict(np.load(os.path.join(out, "seq_ck.npz")))
    res["ck/loaded_bitwise"] = np.asarray(all(
        np.array_equal(p.detach().numpy(), seq[n])
        for n, p in m2.get_params().items()))
    res["ck/loaded"] = np.asarray(len(m2.get_params()))
    res["ck/slots"] = np.asarray(sorted(m2.optimizer._eager_state))
    parallel.set_mesh(None)


try:
    parallel.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    for tag, (kind, axes, changes) in RUNS.items():
        if int(np.prod(list(axes.values()))) == world:
            m, ids = train(tag, kind, axes, changes)
            if tag == "llama_p2":
                checkpoint(m, ids)
    if world == 2:
        masked()
        fallbacks()
        cut_extras()
    if world == GPIPE["S"]:
        gpipe()
    np.savez(os.path.join(out, f"w{world}_r{rank}.npz"), **res)
    parallel.finalize_distributed()
except BaseException:
    traceback.print_exc()
    sys.exit(1)
'''


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------

def _ids():
    return np.random.RandomState(0).randint(0, 256, (B, T)).astype(np.int32)


def _mask():
    m = np.ones((B, T), np.int32)
    m[1, 11:] = 0
    m[6, 5:] = 0
    return m


def _ref_model(kind):
    seed = LLAMA_SEED if kind == "llama" else GPT2_SEED
    jtensor.set_seed(seed)
    np.random.seed(seed)
    if kind == "llama":
        return jmodels.Llama(jmodels.LlamaConfig(
            **{**vars(jmodels.LlamaConfig.tiny()), "num_layers": 4}))
    return jmodels.GPT2(jmodels.GPT2Config.tiny())


@lru_cache(maxsize=None)
def _ref_init(kind):
    m = _ref_model(kind)
    ids = jtensor.from_numpy(_ids())
    m.compile([ids], is_train=False, use_graph=False)
    m(ids)
    return {n: np.asarray(t.data) for n, t in m.get_states().items()}


@lru_cache(maxsize=None)
def _ref_run(kind):
    """The reference's sequential single-device run: STEPS SGD(LR) steps
    from _ref_init's weights: (losses, first step's gradients, the
    parameters after the steps)."""
    m = _ref_model(kind)
    m.set_optimizer(jopt.SGD(lr=LR))
    ids = jtensor.from_numpy(_ids())
    m.compile([ids], is_train=True, use_graph=True)
    init = _ref_init(kind)
    assert all(np.array_equal(np.asarray(t.data), init[n])
               for n, t in m.get_states().items())
    losses, grads = [], None
    for i in range(STEPS):
        before = {n: np.asarray(t.data) for n, t in m.get_params().items()}
        losses.append(float(m.train_step(ids)[1].to_numpy()))
        if i == 0:
            grads = {n: (before[n] - np.asarray(t.data)) / np.float32(LR)
                     for n, t in m.get_params().items()}
    return (losses, grads,
            {n: np.asarray(t.data) for n, t in m.get_params().items()})


def _gpipe_inputs():
    g = GPIPE
    rng = np.random.RandomState(2)
    W = np.stack([rng.randn(g["D"], g["D"]).astype(np.float32) * 0.3
                  for _ in range(g["S"])])
    b = np.stack([rng.randn(g["D"]).astype(np.float32) * 0.1
                  for _ in range(g["S"])])
    x = np.random.RandomState(3).randn(g["N_MICRO"], g["MB"], g["D"]) \
        .astype(np.float32)
    return W, b, x


@lru_cache(maxsize=None)
def _ref_gpipe():
    """The reference's gpipe under shard_map over a pipe mesh of S
    virtual devices: the output and the gradients of Σ out²."""
    P = jparallel.mesh.P
    W, b, x = _gpipe_inputs()
    mesh = jpp.pipeline_mesh(GPIPE["S"])
    f = jax.jit(jax.shard_map(
        jpp.gpipe(lambda p, h: jax.nn.relu(h @ p["W"] + p["b"]),
                  GPIPE["N_MICRO"]), mesh=mesh, in_specs=(P("pipe"), P()),
        out_specs=P(), check_vma=False))
    sp = {"W": jnp.asarray(W), "b": jnp.asarray(b)}
    out = f(sp, jnp.asarray(x))
    g = jax.grad(lambda sp: jnp.sum(f(sp, jnp.asarray(x)) ** 2))(sp)
    return np.asarray(out), np.asarray(g["W"]), np.asarray(g["b"])


def _seq_checkpoint(path):
    """A sequential port Llama from the reference's weights, one SGD
    momentum step, saved: what the pipelined model loads."""
    m = _port_model("llama", {})
    m.set_optimizer(_sgd(0.9))
    ids = torch.from_numpy(_ids())
    m.compile([ids], is_train=True, use_graph=True)
    m.train_step(ids)
    m.save_states(str(path))


def _sgd(momentum):
    from singa_tpu_torch import opt
    return opt.SGD(lr=LR, momentum=momentum)


def _port_model(kind, changes):
    cpu = tdevice.create_device("cpu")
    changes = {"num_layers": LAYERS[kind], **changes}
    if kind == "llama":
        m = tmodels.Llama(tmodels.LlamaConfig(
            **{**vars(tmodels.LlamaConfig.tiny()), **changes}), device=cpu)
    else:
        m = tmodels.GPT2(tmodels.GPT2Config(
            **{**vars(tmodels.GPT2Config.tiny()), **changes}), device=cpu,
            generator=torch.Generator().manual_seed(0))
    tmodels.load_reference_states(m, _ref_init(kind))
    return m


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three port worlds, launched together before the reference's
    runs: {W: [rank 0's results, ...]} and their directory."""
    out = tmp_path_factory.mktemp("torch_pipeline")
    W, b, x = _gpipe_inputs()
    arrays = {"ids": _ids(), "mask": _mask(), "gpipe_W": W, "gpipe_b": b,
              "gpipe_x": x}
    for kind in ("llama", "gpt2"):
        arrays.update({f"{kind}/{n}": a for n, a in _ref_init(kind).items()})
    np.savez(out / "inputs.npz", **arrays)
    _seq_checkpoint(out / "seq_ck.npz")
    script = WORKER % {"runs": RUNS, "layers": LAYERS, "gpipe": GPIPE,
                       "steps": STEPS, "lr": LR}
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
        # the reference's runs while the workers run
        for kind in ("llama", "gpt2"):
            _ref_run(kind)
        _ref_gpipe()
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


def _world_of(axes):
    return int(np.prod(list(axes.values())))


def _coords(axes, rank):
    return dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))


def _slice(full, spec, axes, rank):
    """This rank's block of `full` under the recorded spec."""
    c = _coords(axes, rank)
    for d, ax in enumerate(spec):
        if ax is not None:
            n = full.shape[d] // axes[ax]
            full = np.take(full, range(c[ax] * n, (c[ax] + 1) * n), axis=d)
    return full


def _names(r, tag, key):
    pre = f"{tag}/{key}/"
    return [k[len(pre):] for k in r if k.startswith(pre)]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", list(RUNS))
def test_losses_match_the_reference_sequential_run(worlds, tag):
    """STEPS steps on the mesh: every rank reports the same losses,
    within rtol 2e-4 / atol 2e-5 of the reference's sequential
    single-device run from the same weights (with remat, and with more
    microbatches than stages, alike)."""
    kind, axes, _ = RUNS[tag]
    ranks = worlds[0][_world_of(axes)]
    losses = ranks[0][tag + "/losses"]
    for r in ranks:
        assert bool(r[tag + "/gspmd"])
        np.testing.assert_array_equal(r[tag + "/losses"], losses)
    np.testing.assert_allclose(losses, _ref_run(kind)[0], rtol=RTOL,
                               atol=ATOL)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("tag", ["llama_p2", "gpt2_p2", "llama_dp",
                                 "llama_p4", "llama_dmp"])
def test_every_class_of_gradient_is_the_reference_one(worlds, tag):
    """The gradient each rank applies at the first step (DistOpt's
    synced one) and its parameters after the steps equal the
    reference's single-device ones, class by class: the blocks of a
    rank's stage (held by that rank alone), the embedding (whose
    gradient comes only on stage 0 and is broadcast), the final norm and
    the head (computed whole on every stage and not summed)."""
    kind, axes, _ = RUNS[tag]
    _, g_ref, p_ref = _ref_run(kind)
    classes = {"block": 0, "embedding": 0, "final_norm": 0, "head": 0}
    for i, r in enumerate(worlds[0][_world_of(axes)]):
        for n in _names(r, tag, "g"):
            spec = eval(str(r[f"{tag}/spec/{n}"]))
            for key, ref in (("g", g_ref), ("p", p_ref)):
                np.testing.assert_allclose(
                    r[f"{tag}/{key}/{n}"], _slice(ref[n], spec, axes, i),
                    rtol=RTOL, atol=ATOL, err_msg=f"{key} {n} rank {i}")
            if int(r[f"{tag}/stage/{n}"]) >= 0:
                classes["block"] += 1
            elif n in ("tok_emb.table", "wte.table"):
                classes["embedding"] += 1
            elif n in ("norm_f.gamma", "ln_f.gamma"):
                classes["final_norm"] += 1
            elif n == "lm_head.W" or n == "wte.table":
                classes["head"] += 1
    assert classes["block"] and classes["embedding"] and \
        classes["final_norm"], classes
    assert classes["head"] or kind == "gpt2"     # GPT-2's head is wte


@pytest.mark.parametrize("tag", ["llama_p2", "llama_dp", "llama_p4",
                                 "llama_dmp"])
def test_a_rank_holds_its_stage_alone_and_replicas_agree(worlds, tag):
    """A pipe rank keeps only its own stage's blocks (the others' are
    freed and out of get_params()); a replicated parameter is bitwise
    the same on every rank after the steps, a stage's block on every
    rank of that stage and model coordinate."""
    kind, axes, changes = RUNS[tag]
    ranks = worlds[0][_world_of(axes)]
    S = axes["pipe"]
    per_stage = LAYERS[kind] // S
    block_params = len([n for n in _ref_init(kind)
                        if n.startswith("blocks.0.")])
    for i, r in enumerate(ranks):
        stage = _coords(axes, i)["pipe"]
        stages = {int(r[f"{tag}/stage/{n}"]) for n in _names(r, tag, "p")}
        assert stages == {-1, stage}, (i, stages)
        assert int(r[tag + "/dead"]) == (S - 1) * per_stage * block_params
        assert int(r[tag + "/dead_numel"]) == 0
        for n in _names(r, tag, "p"):
            cut = "model" in str(r[f"{tag}/spec/{n}"])
            for j, o in enumerate(ranks):
                # a rank that holds n holds the same block of it where
                # the model coordinates agree (or n is not cut)
                same = _coords(axes, j).get("model") == \
                    _coords(axes, i).get("model")
                if f"{tag}/p/{n}" in o and (same or not cut):
                    assert np.array_equal(r[f"{tag}/p/{n}"],
                                          o[f"{tag}/p/{n}"]), (n, i, j)


# ---------------------------------------------------------------------------
# the schedule's body
# ---------------------------------------------------------------------------

def test_gpipe_matches_the_reference_gpipe(worlds):
    """gpipe over a pipe axis of 4 gloo ranks (8 microbatches of relu(x W
    + b) stages): every rank's output, and the stages' gradients (each
    rank's row of the stack), equal the reference's gpipe under
    shard_map."""
    out, gW, gb = _ref_gpipe()
    ranks = worlds[0][GPIPE["S"]]
    for r in ranks:
        np.testing.assert_allclose(r["gpipe/out"], out, rtol=1e-5,
                                   atol=1e-6)
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["gpipe/gW"][i], gW[i], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["gpipe/gb"][i], gb[i], rtol=1e-4,
                                   atol=1e-5)
        others = [j for j in range(GPIPE["S"]) if j != i]
        assert not r["gpipe/gW"][others].any()


def test_stage_count_mismatch_raises():
    """Stacking 3 stages for a pipe of 2 raises, as the reference's
    gpipe does, rather than dropping a stage."""
    W, b, x = _gpipe_inputs()
    body = tpp.gpipe(lambda p, h: torch.relu(h @ p["W"] + p["b"]), 8,
                     hop=kc.LocalPipe(2).endpoint(0))
    with pytest.raises(ValueError, match="stage count"):
        body({"W": torch.from_numpy(W[:3]), "b": torch.from_numpy(b[:3])},
             torch.from_numpy(x))


def test_bad_stage_division_raises():
    cpu = tdevice.create_device("cpu")
    cfg = tmodels.LlamaConfig.tiny()       # 2 layers
    cfg.pipeline_stages = 4
    with pytest.raises(ValueError, match="stages"):
        tmodels.Llama(cfg, device=cpu)
    with pytest.raises(ValueError, match="stages"):
        tmodels.GPT2(tmodels.GPT2Config(
            **{**vars(tmodels.GPT2Config.tiny()), "pipeline_stages": 3}),
            device=cpu)


@pytest.mark.parametrize("case", list(kc.PIPE_CASES))
def test_in_process_pipe_holds_and_catches_its_faults(case):
    """kernel_check's in-process pipeline (LocalPipe) over tiny Llama
    blocks on the CPU: output and gradients within the f32 pipe limits
    of the blocks in order; each planted pipe fault, on 4 stages,
    outside them."""
    from singa_tpu_torch.models import llama
    S, M = kc.PIPE_CASES[case]
    cfg = tmodels.LlamaConfig(**{**vars(tmodels.LlamaConfig.tiny()),
                                 "num_layers": 4})
    g = torch.Generator().manual_seed(S * 10 + M)
    blocks = [llama._LlamaBlock(cfg, device=tdevice.create_device("cpu"),
                                generator=g)
              for _ in range(4)]
    x, do = (torch.randn(8, T, cfg.dim, generator=g) for _ in range(2))
    want = kc.seq_run(blocks, x, do)
    assert kc.pipe_errors(kc.pipe_run(blocks, x, do, S, M), want,
                          torch.float32)["ok"]
    if S == 4:
        for name in kc.PIPE_FAULTS:
            with kc.pipe_fault(name):
                r = kc.pipe_errors(kc.pipe_run(blocks, x, do, S, M), want,
                                   torch.float32)
            assert not r["ok"], (name, r)


def test_masked_stack_pipelines_its_extras(worlds):
    """GPT-2's blocks as a cut stack of 2 stages, a padding mask cut into
    microbatches beside x: the features and each rank's blocks'
    gradients equal the port's single-device stack's."""
    m = _port_model("gpt2", {})
    from singa_tpu_torch import autograd
    autograd.set_training(True)
    try:
        f = m.features(torch.from_numpy(_ids()), torch.from_numpy(_mask()))
        params = m.get_params()
        grads = dict(zip(params, torch.autograd.grad(
            (f ** 2).mean(), list(params.values()))))
    finally:
        autograd.set_training(False)
    got = 0
    for r in worlds[0][2]:
        np.testing.assert_allclose(r["masked/f"], f.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        for n in _names(r, "masked", "g"):
            np.testing.assert_allclose(r[f"masked/g/{n}"], grads[n].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=n)
            got += 1
    assert got == len([n for n in grads if n.startswith("blocks.")])


def test_dropout_and_moe_blocks_fall_back_with_the_warning(worlds):
    """A stack whose blocks hold Dropout(p>0) or MoE layers is not cut:
    it warns as the reference does and trains sequentially, every rank
    alike."""
    for tag, words in (("dropout", "Dropout(p>0)"), ("moe", "side-channel")):
        ranks = worlds[0][2]
        for r in ranks:
            assert words in str(r[f"fallback/{tag}/warned"]), r
            assert not bool(r[f"fallback/{tag}/cut"])
            np.testing.assert_array_equal(r[f"fallback/{tag}/losses"],
                                          ranks[0][f"fallback/{tag}/losses"])
            assert np.isfinite(r[f"fallback/{tag}/losses"]).all()


def test_cut_stack_runs_a_non_batch_leading_extra_on_the_whole_batch(
        worlds):
    """On a stack cut into stages, an extra that is not batch-leading
    cannot be cut into microbatches: the call warns and runs the stages
    in turn on the whole batch, the extra whole, and its output, each
    rank's blocks' gradients and x's gradient (stage 0's; the other
    ranks' are zero, as the embedding's gradient before DistOpt's sum
    over pipe) equal the uncut stack's."""
    ranks = worlds[0][2]
    for i, r in enumerate(ranks):
        assert "batch-leading" in str(r["extras/cut/warned"]), r
        assert "one microbatch" in str(r["extras/cut/warned"])
        assert str(r["extras/seq/warned"]) == ""
        np.testing.assert_allclose(r["extras/cut/y"], r["extras/seq/y"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            r["extras/cut/gx"], r["extras/seq/gx"] if i == 0 else 0.0,
            rtol=1e-6, atol=1e-6, err_msg=f"rank {i}")
        names = _names(r, "extras/cut", "g")
        assert len(names) == 4            # 2 of the 4 blocks, W and b
        for n in names:
            np.testing.assert_allclose(r[f"extras/cut/g/{n}"],
                                       r[f"extras/seq/g/{n}"], rtol=1e-6,
                                       atol=1e-6, err_msg=n)


def test_cut_stack_refuses_a_gradient_carrying_extra(worlds):
    """A cut stack takes no gradient through an extra and cannot fall
    back to a sequential run, its other stages' blocks being on other
    ranks: it raises, naming the reason."""
    for r in worlds[0][2]:
        assert "gradient-carrying extra" in str(r["extras/grad_refused"]), r


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_pipelined_checkpoint_loads_into_a_sequential_model_and_back(worlds):
    """The pipelined run's checkpoint holds every block (each from the
    rank that held it) and loads into a sequential model, whose eval
    logits equal the pipelined model's; a pipelined model loads a
    sequential checkpoint: its stage's blocks bitwise, the other
    stages' slots left out.  KV-cached decoding of a cut model is
    refused (decode with the sequential one)."""
    ranks, out = worlds[0][2], worlds[1]
    ck = dict(np.load(out / "pp_ck.npz"))
    for i, r in enumerate(ranks):
        for n in _names(r, "llama_p2", "p"):
            assert np.array_equal(ck[n], r[f"llama_p2/p/{n}"]), (n, i)
    m = _port_model("llama", {})
    names = list(m.get_params())
    assert set(names) <= set(ck)
    m.load_states(str(out / "pp_ck.npz"))
    m.eval()
    logits = m(torch.from_numpy(_ids())).detach().numpy()
    for r in ranks:
        np.testing.assert_allclose(r["ck/logits"], logits, rtol=RTOL,
                                   atol=ATOL)
        assert bool(r["ck/loaded_bitwise"])
        assert bool(r["ck/decode_refused"])
        held = int(r["ck/loaded"])
        assert held == len(names) - len(
            [n for n in names if n.startswith("blocks.")]) // 2
        slots = [str(s) for s in r["ck/slots"]]
        assert len(slots) == held


def test_warnings_module_is_quiet_on_an_uncut_stack():
    """Without a pipe axis the stack runs its blocks in order, silently,
    as the reference's sequential path."""
    m = _port_model("llama", {"pipeline_stages": 2})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m.train()
        out = m(torch.from_numpy(_ids()))
        m.eval()
    ref = _port_model("llama", {})
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref(torch.from_numpy(_ids())).detach()
                                  .numpy())
