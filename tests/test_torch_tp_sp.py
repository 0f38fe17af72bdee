"""The port's tensor and sequence parallelism (parallel.tensor_parallel,
the Megatron forms of layer.Linear / Embedding, ops.ring_attention, the
executor's multi-axis step, DistOpt over data × seq, TP checkpoints)
against the JAX package's GSPMD path.

The reference runs in this process on the conftest's virtual CPU mesh:
its multi-axis training runs (``parallel.make_mesh(axes)``, the step
jitted with rule-derived shardings) and its single-device run, and
``ring_attention_local`` under ``shard_map``.  The port runs as gloo
worlds of 2, 4 and 8 processes, launched together once for the module
before the reference's runs, each running the scenarios of `WORKER`
(torch, numpy and singa_tpu_torch only) and writing what it got to an
.npz.  Inputs and the reference models' initial states reach the
workers through ``inputs.npz``.

Tolerances:
  * training losses, four SGD steps, against the reference's run on the
    same mesh and its single-device run: rtol 2e-4, atol 1e-5 (the
    bounds of tests/test_spmd.py);
  * ring attention's output and its q, k, v gradients against the
    reference's ``ring_attention_local`` under ``shard_map`` and its
    ``_sdpa_reference``: 1e-5 (atol and rtol);
  * within the port: replicated parameters across ranks, a parameter's
    block across the ranks that hold it, a checkpoint's round trip: bitwise;
    a single-device model's steps from a TP checkpoint against the TP
    run's: rtol 2e-4, atol 1e-5.
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
from singa_tpu import parallel as jparallel
from singa_tpu import tensor as jtensor
from singa_tpu.ops.attention import _sdpa_reference as jsdpa
from singa_tpu.ops.ring_attention import ring_attention_local as jring
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import opt as topt

REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 4, 8)
STEPS = 4
LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-5
RING_TOL = 1e-5
WORKER_TIMEOUT_S = 240
LLAMA_SEED, GPT2_SEED = 5, 3

# tag: (model, mesh axes, DistOpt data_axis, config changes); each runs
# in the world of its mesh's size
RUNS = {
    "llama_dm": ("llama", {"data": 2, "model": 2}, "data", {}),
    "llama_ms": ("llama", {"model": 2, "seq": 2}, "data", {}),
    "llama_dps": ("llama", {"dp": 2, "seq": 2}, "dp", {}),
    "llama_dms": ("llama", {"data": 2, "model": 2, "seq": 2}, "data", {}),
    "llama_dms_fused": ("llama", {"data": 2, "model": 2, "seq": 2}, "data",
                        {"fused_loss": True}),
    # model = 4 cuts q_proj by heads but not tiny()'s two kv heads
    "llama_dm4": ("llama", {"data": 2, "model": 4}, "data", {}),
    "gpt2_dm": ("gpt2", {"data": 2, "model": 2}, "data", {}),
    "gpt2_ms_fused": ("gpt2", {"model": 2, "seq": 2}, "data",
                      {"fused_loss": True}),
}
# a run with dropout: only its ranks' agreement is checked (each rank
# draws its masks at its local shapes, the reference at global ones)
DROPOUT_RUN = ("gpt2", {"data": 2, "model": 2}, "data", {"dropout": 0.1})

# ring inputs: (B, T per rank, H, K, D); the flash path's blocks tile
RING = {"einsum": (2, 8, 4, 4, 8), "flash": (1, 128, 4, 2, 32)}

WORKER = r'''
import os, sys, traceback
sys.path.insert(0, sys.argv[5])
import numpy as np
import torch
torch.set_num_threads(1)
from singa_tpu_torch import device, models, opt, parallel
from singa_tpu_torch.ops import ring_attention_local

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
CPU = device.create_device("cpu")
inp = dict(np.load(os.path.join(out, "inputs.npz")))
RUNS = %(runs)s
DROPOUT_RUN = %(dropout)r
RING = %(ring)r
STEPS = %(steps)d
res = {}


def build(kind, changes):
    pre = kind + "/"
    if kind == "llama":
        cfg = models.LlamaConfig(**{**vars(models.LlamaConfig.tiny()),
                                    **changes})
        m = models.Llama(cfg, device=CPU)
    else:
        cfg = models.GPT2Config(**{**vars(models.GPT2Config.tiny()),
                                   **changes})
        m = models.GPT2(cfg, device=CPU,
                        generator=torch.Generator().manual_seed(0))
    models.load_reference_states(m, {k[len(pre):]: v for k, v in inp.items()
                                     if k.startswith(pre)})
    return m


def fresh(spec, momentum=0.0, **kw):
    kind, axes, data_axis, changes = spec
    parallel.set_mesh(parallel.make_mesh(axes))
    m = build(kind, changes)
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1, momentum=momentum),
                                data_axis=data_axis, **kw))
    ids = torch.from_numpy(inp["ids"])
    m.compile([ids], is_train=True, use_graph=True)
    return m, ids


def save(tag, m, losses):
    res[tag + "/losses"] = np.asarray(losses)
    for n, p in m.get_params().items():
        res[f"{tag}/p/{n}"] = p.detach().numpy().copy()
        res[f"{tag}/spec/{n}"] = np.asarray(repr(tuple(p.tp_spec)))
    ex = next(iter(m._executors.values()))
    res[tag + "/gspmd"] = np.asarray(ex.gspmd)


def train(tag, spec):
    m, ids = fresh(spec)
    save(tag, m, [m.train_step(ids)[1].item() for _ in range(STEPS)])
    parallel.set_mesh(None)


def checkpoint():
    """{'data': 2, 'model': 2}: two steps with momentum, a save, two
    more; a fresh TP model loads the file and makes the same two."""
    path = os.path.join(out, "tp_ck.npz")
    spec = RUNS["llama_dm"]
    m, ids = fresh(spec, momentum=0.9)
    first = [m.train_step(ids)[1].item() for _ in range(2)]
    m.save_states(path)
    for n, p in m.get_params().items():
        res[f"ck/local/{n}"] = p.detach().numpy().copy()
    for n, s in m.optimizer._eager_state.items():
        res[f"ck/slot/{n}"] = s.detach().numpy().copy()
    res["ck/first"] = np.asarray(first)
    res["ck/then"] = np.asarray([m.train_step(ids)[1].item()
                                 for _ in range(2)])
    m2, _ = fresh(spec, momentum=0.9)
    m2.load_states(path)
    res["ck/restored_bitwise"] = np.asarray(all(
        np.array_equal(p.detach().numpy(), res[f"ck/local/{n}"])
        for n, p in m2.get_params().items()) and all(
        np.array_equal(s.numpy(), res[f"ck/slot/{n}"])
        for n, s in m2.optimizer._eager_state.items()))
    res["ck/resumed"] = np.asarray([m2.train_step(ids)[1].item()
                                    for _ in range(2)])
    parallel.set_mesh(None)


def sync_modes():
    """{'data': 2, 'model': 2} with momentum: plain, ZeRO-1 over the data
    axis of the TP blocks, and int8_ring (ignored on a multi-axis mesh,
    with the reference's warning)."""
    import warnings
    for mode, kw in (("plain", {}), ("zero1", {"shard_weight_update": True}),
                     ("ring", {"compression": "int8_ring"})):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m, ids = fresh(RUNS["llama_dm"], momentum=0.9, **kw)
            losses = [m.train_step(ids)[1].item() for _ in range(STEPS)]
        res[f"mode/{mode}/losses"] = np.asarray(losses)
        res[f"mode/{mode}/warned"] = np.asarray(
            any("ignored" in str(w.message) for w in caught))
        res[f"mode/{mode}/slot_numel"] = np.asarray(sum(
            t.numel() for v in m.optimizer._eager_state.values()
            for t in opt._leaves(v)))
        for n, p in m.get_params().items():
            res[f"mode/{mode}/p/{n}"] = p.detach().numpy().copy()
        parallel.set_mesh(None)


def ring():
    parallel.set_mesh(parallel.make_mesh({"seq": world}))
    for path, (B, Tl, H, K, D) in RING.items():
        for causal in (True, False):
            key = f"ring_{path}_{world}"
            ql, kl, vl = (torch.from_numpy(np.ascontiguousarray(
                inp[f"{key}_{x}"][:, rank * Tl:(rank + 1) * Tl]))
                .requires_grad_() for x in "qkv")
            o = ring_attention_local(ql, kl, vl, "seq", causal, D ** -0.5,
                                     use_flash=path == "flash")
            (o ** 2).sum().backward()
            for x, t in (("o", o), ("dq", ql.grad), ("dk", kl.grad),
                         ("dv", vl.grad)):
                res[f"ring/{path}/{causal}/{x}"] = t.detach().numpy()
    parallel.set_mesh(None)


try:
    parallel.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    ring()
    for tag, spec in RUNS.items():
        axes = spec[1]
        if int(np.prod(list(axes.values()))) == world:
            train(tag, spec)
    if world == 4:
        train("dropout", DROPOUT_RUN)
        checkpoint()
        sync_modes()
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
    return np.random.RandomState(0).randint(0, 256, (4, 16)).astype(np.int32)


def _ref_model(kind, changes=None):
    seed = LLAMA_SEED if kind == "llama" else GPT2_SEED
    jtensor.set_seed(seed)
    np.random.seed(seed)
    if kind == "llama":
        return jmodels.Llama(jmodels.LlamaConfig(
            **{**vars(jmodels.LlamaConfig.tiny()), **(changes or {})}))
    return jmodels.GPT2(jmodels.GPT2Config(
        **{**vars(jmodels.GPT2Config.tiny()), **(changes or {})}))


@lru_cache(maxsize=None)
def _ref_init(kind):
    m = _ref_model(kind)
    ids = jtensor.from_numpy(_ids())
    m.compile([ids], is_train=False, use_graph=False)
    m(ids)
    return {n: np.asarray(t.data) for n, t in m.get_states().items()}


@lru_cache(maxsize=None)
def _ref_losses(kind, axes_items=None, data_axis="data"):
    """The reference's four SGD(0.1) steps: single-device without
    `axes_items`, else under make_mesh(dict(axes_items)) through
    DistOpt (its GSPMD path)."""
    axes = dict(axes_items) if axes_items else None
    jparallel.set_mesh(jparallel.make_mesh(axes) if axes else None)
    try:
        m = _ref_model(kind)
        base = jopt.SGD(lr=0.1)
        m.set_optimizer(jopt.DistOpt(base, data_axis=data_axis) if axes
                        else base)
        ids = jtensor.from_numpy(_ids())
        m.compile([ids], is_train=True, use_graph=True)
        init = _ref_init(kind)
        assert all(np.array_equal(np.asarray(t.data), init[n])
                   for n, t in m.get_states().items())
        losses = [float(m.train_step(ids)[1].to_numpy())
                  for _ in range(STEPS)]
        if axes:
            assert next(iter(m._executors.values())).gspmd
        return losses
    finally:
        jparallel.set_mesh(None)
        jparallel.mesh.set_data_axis("data")


def _ring_inputs(path, S):
    B, Tl, H, K, D = RING[path]
    rng = np.random.RandomState(100 * S + len(path))
    return {x: rng.randn(B, Tl * S, H if x == "q" else K, D)
            .astype(np.float32) for x in "qkv"}


@lru_cache(maxsize=None)
def _ref_ring(path, S, causal, how):
    """The reference's output and the gradients of Σ o² with respect to
    q, k, v: `how` "shard_map" is its einsum ring over a seq mesh of S
    (kv heads repeated for grouped inputs), "sdpa" its plain attention."""
    a = _ring_inputs(path, S)
    q, k, v = (jnp.asarray(a[x]) for x in "qkv")
    D = q.shape[-1]
    scale = 1.0 / np.sqrt(D)
    rep = q.shape[2] // k.shape[2]
    if how == "sdpa":
        def f(q, k, v):
            return jsdpa(q, k, v, causal, None, scale)
    else:
        P = jparallel.mesh.P
        mesh = jparallel.make_mesh({"seq": S})
        ring = jax.shard_map(
            lambda x, y, z: jring(x, y, z, "seq", causal, scale,
                                  use_flash=False),
            mesh=mesh, in_specs=(P(None, "seq"),) * 3,
            out_specs=P(None, "seq"), check_vma=False)

        def f(q, k, v):
            return ring(q, jnp.repeat(k, rep, axis=2),
                        jnp.repeat(v, rep, axis=2))
    def both(q, k, v):
        return f(q, k, v), jax.grad(lambda *x: jnp.sum(f(*x) ** 2),
                                    (0, 1, 2))(q, k, v)
    o, g = jax.jit(both)(q, k, v)
    return (np.asarray(o),) + tuple(np.asarray(x) for x in g)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three port worlds, launched together before the reference's
    runs: {W: [rank 0's results, ...]} and their directory."""
    out = tmp_path_factory.mktemp("torch_tp_sp")
    arrays = {"ids": _ids()}
    for kind in ("llama", "gpt2"):
        arrays.update({f"{kind}/{n}": a for n, a in _ref_init(kind).items()})
    for w in WORLDS:
        for path in RING:
            arrays.update({f"ring_{path}_{w}_{x}": a
                           for x, a in _ring_inputs(path, w).items()})
    np.savez(out / "inputs.npz", **arrays)
    script = WORKER % {"runs": repr(RUNS), "dropout": DROPOUT_RUN,
                       "ring": RING, "steps": STEPS}
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
        for kind, axes, data_axis, changes in RUNS.values():
            _ref_losses(kind)
            _ref_losses(kind, tuple(axes.items()), data_axis)
        for w, path, how in RING_CHECKS:
            for causal in (True, False):
                _ref_ring(path, w, causal, how)
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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", list(RUNS))
def test_losses_match_the_reference_multi_axis_and_single_runs(worlds, tag):
    """Four steps on the mesh: every rank reports the same loss, within
    2e-4 of the reference's run on the same mesh and of its
    single-device run."""
    kind, axes, data_axis, _ = RUNS[tag]
    ranks = worlds[0][_world_of(axes)]
    losses = ranks[0][tag + "/losses"]
    for r in ranks:
        assert bool(r[tag + "/gspmd"])
        np.testing.assert_array_equal(r[tag + "/losses"], losses)
    np.testing.assert_allclose(
        losses, _ref_losses(kind, tuple(axes.items()), data_axis),
        rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(losses, _ref_losses(kind), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    assert losses[-1] < losses[0]


def _coords(axes, rank):
    return dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))


@pytest.mark.parametrize("tag", list(RUNS) + ["dropout"])
def test_parameters_agree_across_ranks(worlds, tag):
    """A replicated parameter is bitwise the same on every rank after
    the steps (its gradient equal on the model ranks, averaged over the
    others); a cut one on every rank of the same model coordinate; the
    blocks are the ranks' slices of the recorded spec's dims."""
    kind, axes = (DROPOUT_RUN if tag == "dropout" else RUNS[tag])[:2]
    ranks = worlds[0][_world_of(axes)]
    names = [k[len(tag) + 3:] for k in ranks[0] if k.startswith(tag + "/p/")]
    assert names
    M = axes.get("model", 1)
    cut = 0
    for n in names:
        spec = eval(str(ranks[0][f"{tag}/spec/{n}"]))
        for i, r in enumerate(ranks):
            same = [j for j in range(len(ranks))
                    if _coords(axes, j).get("model", 0)
                    == _coords(axes, i).get("model", 0)] if spec else \
                range(len(ranks))
            for j in same:
                assert np.array_equal(r[f"{tag}/p/{n}"],
                                      ranks[j][f"{tag}/p/{n}"]), (n, i, j)
        if "model" in spec:
            cut += 1
            d = spec.index("model")
            assert ranks[0][f"{tag}/p/{n}"].shape[d] * M == \
                _ref_init(kind)[n].shape[d], n
    assert cut > 0 or "model" not in axes


def test_q_proj_holds_its_share_of_the_heads(worlds):
    """At model = 2 each rank's q_proj.W holds out/2 columns (two of
    tiny()'s four heads) and its k/v projections one of its two kv
    heads; at model = 4 q_proj holds one head and the kv projections,
    which would cut a head, stay whole (each rank reads its kv head)."""
    r2 = worlds[0][4][0]
    assert r2["llama_dm/p/blocks.0.attn.q_proj.W"].shape == (64, 32)
    assert r2["llama_dm/p/blocks.0.attn.k_proj.W"].shape == (64, 16)
    assert r2["llama_dm/p/blocks.0.attn.o_proj.W"].shape == (32, 64)
    assert r2["llama_dm/p/lm_head.W"].shape == (64, 128)
    assert r2["llama_dm/p/tok_emb.table"].shape == (256, 32)
    r4 = worlds[0][8][0]
    assert r4["llama_dm4/p/blocks.0.attn.q_proj.W"].shape == (64, 16)
    assert r4["llama_dm4/p/blocks.0.attn.k_proj.W"].shape == (64, 32)
    assert str(r4["llama_dm4/spec/blocks.0.attn.k_proj.W"]) == "()"
    g = worlds[0][4][0]
    assert g["gpt2_dm/p/blocks.0.attn.q_proj.b"].shape == (32,)
    assert g["gpt2_dm/p/blocks.0.attn.out_proj.b"].shape == (64,)


def test_zero1_and_compression_on_a_multi_axis_mesh(worlds):
    """{'data': 2, 'model': 2}, SGD with momentum: ZeRO-1 shards each TP
    block's slot over the data axis (half the slot elements a rank) and
    trains as the plain sync does; int8_ring warns and is ignored (the
    plain sync runs), as the reference's GSPMD path does."""
    for r in worlds[0][4]:
        plain = r["mode/plain/losses"]
        np.testing.assert_allclose(r["mode/zero1/losses"], plain,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(r["mode/ring/losses"], plain)
        assert bool(r["mode/ring/warned"]) and not bool(
            r["mode/plain/warned"])
        assert 2 * int(r["mode/zero1/slot_numel"]) >= int(
            r["mode/plain/slot_numel"]) > int(r["mode/zero1/slot_numel"])
        for k in r:
            if k.startswith("mode/plain/p/"):
                np.testing.assert_allclose(
                    r[k.replace("plain", "zero1")], r[k], rtol=1e-6,
                    atol=1e-7, err_msg=k)
                np.testing.assert_array_equal(r[k.replace("plain", "ring")],
                                              r[k])


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

# (world, path, how): the reference's einsum ring under shard_map at
# every world, and (its kv heads repeated) against the port's grouped
# flash blocks at a world of 4; its plain attention at every world
RING_CHECKS = [(w, p, h) for w in WORLDS for p in RING
               for h in ("shard_map", "sdpa")
               if not (p == "flash" and h == "shard_map" and w != 4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("world,path,how", RING_CHECKS)
def test_ring_attention_matches_the_reference(worlds, world, path, causal,
                                              how):
    """The port's ring over a seq axis of `world` gloo ranks, its blocks
    gathered: the output and the gradients of Σ o² equal the reference's
    einsum ring under shard_map (kv heads repeated for the grouped flash
    inputs, which the port's flash blocks take without repetition) and
    its plain attention."""
    ranks = worlds[0][world]
    got = [np.concatenate([r[f"ring/{path}/{causal}/{x}"] for r in ranks],
                          axis=1) for x in ("o", "dq", "dk", "dv")]
    for name, g, want in zip(("o", "dq", "dk", "dv"), got,
                             _ref_ring(path, world, causal, how)):
        np.testing.assert_allclose(g, want, rtol=RING_TOL, atol=RING_TOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_tp_checkpoint_round_trips_and_loads_into_one_device(worlds):
    """A checkpoint of the run at {'data': 2, 'model': 2} holds the full
    shapes: each rank's block of a parameter or its momentum is its
    slice of the file's array; a fresh TP model restores its blocks
    bitwise and continues bitwise; a single-device model loads the file
    and its next two steps match the TP run's."""
    ranks, out = worlds[0][4], worlds[1]
    axes = RUNS["llama_dm"][1]
    for r in ranks:
        assert bool(r["ck/restored_bitwise"])
        np.testing.assert_array_equal(r["ck/resumed"], ranks[0]["ck/then"])
    m = tmodels.Llama(tmodels.LlamaConfig.tiny(),
                      device=tdevice.create_device("cpu"))
    m.set_optimizer(topt.SGD(lr=0.1, momentum=0.9))
    ids = torch.from_numpy(_ids())
    m.compile([ids], is_train=True, use_graph=True)
    m.load_states(str(out / "tp_ck.npz"))
    full = {n: p.detach().numpy() for n, p in m.get_params().items()}
    slots = {n: s.numpy() for n, s in m.optimizer._eager_state.items()}
    for i, r in enumerate(ranks):
        mi = _coords(axes, i)["model"]
        for n, a in full.items():
            for key, src in ((f"ck/local/{n}", a), (f"ck/slot/{n}", slots[n])):
                local = r[key]
                d = next((k for k in range(a.ndim)
                          if local.shape[k] != a.shape[k]), None)
                want = src if d is None else np.take(
                    src, range(mi * local.shape[d],
                               (mi + 1) * local.shape[d]), axis=d)
                assert np.array_equal(local, want), (key, i)
    losses = [m.train_step(ids)[1].item() for _ in range(2)]
    np.testing.assert_allclose(losses, ranks[0]["ck/then"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)


# ---------------------------------------------------------------------------
# the card's in-process ring (kernel_check), on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,causal", [(2, True), (4, True), (4, False)])
def test_in_process_ring_holds_and_catches_its_faults(S, causal):
    """kernel_check's ring over S shards of one device, run here with
    the kernels' plain versions at a small grouped shape: within the f32
    flash limits of the plain whole-sequence attention; each planted
    ring fault, on the causal case of 4 shards, outside them (on 2, a
    hop either way reaches the same rank)."""
    from singa_tpu_torch import kernel_check as kc
    g = torch.Generator().manual_seed(S)
    q, k, v, do = (torch.randn(shape, generator=g) * 0.3 for shape in
                   ((1, 512, 4, 32), (1, 512, 2, 32), (1, 512, 2, 32),
                    (1, 512, 4, 32)))
    assert kc.ring_errors(q, k, v, do, S, causal, torch.float32)["ok"]
    if causal and S > 2:
        for name in kc.RING_FAULTS:
            with kc.ring_fault(name):
                assert not kc.ring_errors(q, k, v, do, S, causal,
                                          torch.float32)["ok"], name
