"""The port's fault-tolerant run orchestration (singa_tpu_torch.train:
RunState, AsyncCheckpointManager, PreemptionHandler, TrainRunner; the
ckpt_fsck tool) and the trainer's utils (timing, profiler, metrics,
prefetch_to_device) against the JAX package's, on the CPU.

Across the packages, in one process: an MLP with Adam from the
reference's weights, the same DataLoader seeds, through both
TrainRunners — ten losses within rtol 1e-5 (f32 on both sides; op order
differs), the same committed steps, retained files and marker keys, the
same RunState fields apart from the RNG bundle (the reference stores a
JAX key, the port torch generator states, under versions each refuses
of the other), records that validate under both packages' schemas, and
each package's fsck accepting the other's directory and flagging the
same torn file.  Within the port: a tiny GPT-2 with dropout 0.1 and
AdamW killed and resumed — losses, parameters, moments, the optimizer
counter and the generator state bitwise.  The orchestration cases of
``tests/test_train.py`` run against a stub model (no step executor), as
the reference's do; ZeRO-1 state round-trips through the orchestrator
in one module-scoped world of 2 gloo processes, bitwise.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import unittest.mock as mock
from pathlib import Path

import numpy as np
import pytest
import torch

from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu import train as jtrain
from singa_tpu.obs import record as jrecord
from singa_tpu.obs import schema as jschema
from singa_tpu.utils import data as jdata
from singa_tpu.utils import metrics as jmetrics
from singa_tpu.utils import timing as jtiming
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import faults as tfaults
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import opt as topt
from singa_tpu_torch import train as ttrain
from singa_tpu_torch.obs import events as tevents
from singa_tpu_torch.obs import record as trecord
from singa_tpu_torch.obs import schema as tschema
from singa_tpu_torch.tools import ckpt_fsck
from singa_tpu_torch.train import (AsyncCheckpointManager,
                                   CheckpointCorrupt, PreemptionHandler,
                                   RunState, TrainAborted, TrainRunner)
from singa_tpu_torch.utils import checkpoint as tcheckpoint
from singa_tpu_torch.utils import data as tdata
from singa_tpu_torch.utils import failure as tfailure
from singa_tpu_torch.utils import metrics as tmetrics
from singa_tpu_torch.utils import profiler as tprofiler
from singa_tpu_torch.utils import timing as ttiming

REPO = Path(__file__).resolve().parents[1]
N, DIM, CLASSES, BS = 32, 8, 4, 8
STEPS = 10


@pytest.fixture(autouse=True)
def _cpu_and_clean():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tevents.configure()
    tfaults.uninstall()
    tdevice.set_default_device(None)


def _arrays(seed=7, n=N, dim=DIM):
    r = np.random.RandomState(seed)
    return (r.randn(n, dim).astype(np.float32),
            r.randint(0, CLASSES, n).astype(np.int32))


def _loader(x, y, bs=BS):
    return tdata.DataLoader(x, y, batch_size=bs, seed=3, drop_last=True)


class TinyModel:
    """Minimal checkpointable model stub, as the reference's tests use:
    each train_step adds 1 to a weight, no step executor."""

    def __init__(self):
        self.w = torch.zeros(4)
        self.optimizer = None
        self._step_count = 0
        self._executors = {}          # dropped by a restore

    def get_states(self):
        return {"w": self.w}

    def set_states(self, s):
        self.w = torch.as_tensor(np.asarray(s["w"])).clone()

    def train_step(self, x, y):
        self.w = self.w + 1.0
        self._step_count += 1
        return None, torch.tensor(0.5)


def _tiny_runner(tmp_path, model=None, total=6, save_every=100, **kw):
    x, y = _arrays()
    kw.setdefault("to_batch", tuple)
    return TrainRunner(
        model if model is not None else TinyModel(), _loader(x, y),
        total_steps=total,
        ckpt=AsyncCheckpointManager(str(tmp_path / "ck"),
                                    save_every=save_every), **kw)


# ---------------------------------------------------------------------------
# across the packages: an MLP with Adam through both TrainRunners
# ---------------------------------------------------------------------------

def _ref_run(d, store):
    np.random.seed(0)
    jtensor.set_seed(0)
    m = jmodels.MLP(perceptron_size=(8,), num_classes=CLASSES)
    m.set_optimizer(jopt.Adam(lr=1e-2))
    xb = np.random.RandomState(5).randn(BS, DIM).astype(np.float32)
    m.compile([jtensor.from_numpy(xb)], is_train=True, use_graph=True)
    init = {n: np.asarray(t.data) for n, t in m.get_states().items()}
    x, y = _arrays()
    losses = []
    r = jtrain.TrainRunner(
        m, jdata.DataLoader(x, y, batch_size=BS, seed=3, drop_last=True,
                            use_native=False), STEPS,
        ckpt=jtrain.AsyncCheckpointManager(d, keep_last=2, save_every=3),
        record_store=store,
        on_step=lambda s, o: losses.append(float(np.asarray(o[1].data))))
    res = r.run()
    r.__exit__()
    return init, losses, res


def _port_run(d, store, init):
    m = tmodels.MLP(perceptron_size=(8,), num_classes=CLASSES,
                    input_shape=(DIM,), device=tdevice.create_device("cpu"))
    tmodels.load_reference_states(m, init)
    m.set_optimizer(topt.Adam(lr=1e-2))
    x, y = _arrays()
    m.compile([torch.as_tensor(x[:BS])], is_train=True, use_graph=True)
    losses = []
    r = TrainRunner(m, _loader(x, y), STEPS,
                    ckpt=AsyncCheckpointManager(d, keep_last=2, save_every=3),
                    record_store=store,
                    on_step=lambda s, o: losses.append(float(o[1])))
    res = r.run()
    r.__exit__()
    return losses, res


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's and the port's runs: ((dir, store, losses, result)
    of the reference, the same of the port)."""
    root = tmp_path_factory.mktemp("both")
    jd, td = str(root / "ref"), str(root / "port")
    js, ts = str(root / "ref.jsonl"), str(root / "port.jsonl")
    init, jl, jr = _ref_run(jd, js)
    tl, tr = _port_run(td, ts, init)
    return (jd, js, jl, jr), (td, ts, tl, tr)


def test_mlp_losses_match_the_reference_through_both_runners(both):
    (_, _, jl, jr), (_, _, tl, tr) = both
    assert len(jl) == len(tl) == STEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert (tr.outcome, tr.steps, tr.ckpt_count) == \
        (jr.outcome, jr.steps, jr.ckpt_count) == ("completed", STEPS, 4)


def test_committed_steps_files_and_markers_match_the_reference(both):
    (jd, _, _, _), (td, _, _, _) = both
    assert ttrain.AsyncCheckpointManager(td).steps() == \
        jtrain.AsyncCheckpointManager(jd).steps() == [9, 10]
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for f in os.listdir(td):
        if f.endswith(".commit"):
            tm = json.loads(Path(td, f).read_text())
            jm = json.loads(Path(jd, f).read_text())
            assert tm.keys() == jm.keys()
            assert tm["step"] == jm["step"]


def test_run_state_fields_match_apart_from_the_rng_bundle(both):
    (jd, _, _, _), (td, _, _, _) = both
    name = "ckpt_000000000010.npz"
    _, jaux = tcheckpoint.load_arrays(os.path.join(jd, name))
    _, taux = tcheckpoint.load_arrays(os.path.join(td, name))
    jrs, trs = jaux["run_state"], taux["run_state"]
    for k in ("step", "epoch", "data_state", "model_step_count"):
        assert trs[k] == jrs[k], k
    assert (jrs["version"], trs["version"]) == (1, 2)
    assert "rng_key" in jrs and "rng_states" in trs
    assert taux["optimizer"] == jaux["optimizer"]
    assert taux["opt_signature"] == jaux["opt_signature"]
    assert taux["opt_slots"] == jaux["opt_slots"]
    # neither package resumes the other's RNG trajectory
    with pytest.raises(tschema.SchemaError, match="version"):
        RunState.from_aux(jrs)
    with pytest.raises(jschema.SchemaError, match="version"):
        jtrain.RunState.from_aux(trs)


def test_train_run_records_validate_under_both_schemas(both):
    (_, js, _, _), (_, ts, _, _) = both
    assert trecord.RunRecord(ts).validate() == []
    assert jrecord.RunRecord(ts).validate() == []
    for store in (js, ts):
        for line in Path(store).read_text().splitlines():
            entry = json.loads(line)
            tschema.validate_entry(entry)
            jschema.validate_entry(entry)
    port = [json.loads(ln) for ln in Path(ts).read_text().splitlines()]
    assert [e["kind"] for e in port] == ["train_run"]
    assert (port[0]["platform"], port[0]["smoke"]) == ("cpu", True)
    assert port[0]["payload"]["outcome"] == "completed"


def test_each_packages_fsck_reads_the_others_directory(both, tmp_path):
    import shutil

    from tools.lint import audit
    (jd, _, _, _), (td, _, _, _) = both
    assert audit.fsck_ckpt_dir(td) == ([], [])
    assert ckpt_fsck.fsck_dir(jd) == ([], [])
    for src in (td, jd):
        d = tmp_path / Path(src).name
        shutil.copytree(src, d)
        p = d / "ckpt_000000000010.npz"
        with open(p, "r+b") as f:
            f.truncate(p.stat().st_size - 16)
        (je, _), (te, _) = audit.fsck_ckpt_dir(str(d)), ckpt_fsck.fsck_dir(
            str(d))
        assert len(je) == len(te) == 1
        assert p.name in je[0] and p.name in te[0]
        assert "torn" in te[0]


def test_ckpt_fsck_cli_exit_codes(both, tmp_path, capsys):
    (_, _, _, _), (td, _, _, _) = both
    assert ckpt_fsck.main([td]) == 0
    assert ckpt_fsck.main([]) == 2
    assert ckpt_fsck.main([str(tmp_path / "missing")]) == 1
    r = subprocess.run([sys.executable, "-m",
                        "singa_tpu_torch.tools.ckpt_fsck", td],
                       cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0 and "intact" in r.stdout


# ---------------------------------------------------------------------------
# within the port: kill-and-resume with dropout, bitwise
# ---------------------------------------------------------------------------

def _gpt2():
    import dataclasses

    from singa_tpu_torch.models import GPT2, GPT2Config
    cfg = dataclasses.replace(GPT2Config.tiny(), dropout=0.1,
                              fused_loss=True, num_layers=1)
    m = GPT2(cfg, device=tdevice.create_device("cpu"),
             generator=torch.Generator().manual_seed(0))
    m.set_optimizer(topt.AdamW(lr=1e-3, weight_decay=0.1))
    m.compile([torch.zeros(4, 16, dtype=torch.int32)], is_train=True,
              use_graph=True)
    return m


def test_gpt2_with_dropout_kill_and_resume_is_bitwise(tmp_path):
    data = np.random.RandomState(0).randint(0, 256, (32, 16)).astype(
        np.int32)

    def run(d, total, m):
        losses = {}
        r = TrainRunner(m, tdata.DataLoader(data, batch_size=4, seed=1,
                                            drop_last=True), total,
                        ckpt=AsyncCheckpointManager(str(tmp_path / d),
                                                    save_every=3),
                        on_step=lambda s, o: losses.__setitem__(
                            s, float(o[1])))
        res = r.run()
        r.__exit__()
        return losses, res

    straight = _gpt2()
    want, _ = run("a", 10, straight)
    killed = _gpt2()
    first, _ = run("b", 7, killed)     # saves at 3, 6 and (final) 7
    del killed                          # nothing carries over but files
    resumed = _gpt2()
    rest, res = run("b", 10, resumed)
    assert res.resumed_from == 7 and res.start_step == 7
    assert {**first, **rest} == want
    assert len(set(want.values())) > 1
    for n, t in straight.get_states().items():
        assert torch.equal(resumed.get_states()[n], t), n
    sm, rm = straight.optimizer.slot_arrays(), resumed.optimizer.slot_arrays()
    assert sm.keys() == rm.keys()
    for n in sm:
        assert len(sm[n]) == len(rm[n]) == 2          # AdamW m, v
        for a, b in zip(sm[n], rm[n]):
            assert torch.equal(a, b), n
    assert resumed.optimizer.step_counter == \
        straight.optimizer.step_counter == 10
    assert resumed._step_count == straight._step_count
    assert torch.equal(resumed.device.generator.get_state(),
                       straight.device.generator.get_state())


def test_run_state_carries_every_generator_the_step_draws_from():
    from singa_tpu_torch import layer
    m = _gpt2()
    own = torch.Generator().manual_seed(5)
    m.blocks[0].drop = layer.Dropout(0.1, device=m.device, generator=own)
    gens = ttrain.state.step_generators(m)
    assert gens[0] is m.device.generator and gens[-1] is own
    assert len(gens) == 2
    rs = RunState.capture(m, None, 3, "r")
    assert RunState.from_aux(rs.to_aux()) == rs
    own.manual_seed(9)
    m.device.generator.manual_seed(9)
    rs.apply(m)
    assert torch.equal(own.get_state(), torch.tensor(rs.rng_states[1],
                                                     dtype=torch.uint8))
    with pytest.raises(ValueError, match="generator"):
        RunState(**{**rs.to_aux(), "rng_states": rs.rng_states[:1]}).apply(m)
    bad = rs.to_aux()
    bad["version"] = 99
    with pytest.raises(tschema.SchemaError, match="version"):
        RunState.from_aux(bad)


# ---------------------------------------------------------------------------
# crash consistency: commit markers, torn writes, retention
# ---------------------------------------------------------------------------

def test_torn_npz_rejected_and_falls_back(tmp_path):
    mgr = AsyncCheckpointManager(str(tmp_path), save_every=1)
    m = TinyModel()
    m.train_step(None, None)
    mgr.save(1, m, run_state=RunState.capture(m, None, 1, "r"), block=True)
    m.train_step(None, None)
    mgr.save(2, m, run_state=RunState.capture(m, None, 2, "r"), block=True)
    p2 = mgr.path(2)
    with open(p2, "r+b") as f:
        f.truncate(os.path.getsize(p2) - 16)
    with pytest.raises(CheckpointCorrupt, match="sha256|size"):
        mgr.load_step(2, TinyModel())
    fresh = TinyModel()
    with pytest.warns(UserWarning, match="torn"):
        aux = mgr.restore_latest(fresh)
    assert aux is not None and aux["step"] == 1
    assert torch.equal(fresh.w, torch.ones(4))


def test_torn_fault_site_tears_after_the_marker(tmp_path):
    mgr = AsyncCheckpointManager(str(tmp_path), save_every=1)
    m = TinyModel()
    plan = tfaults.FaultPlan([tfaults.FaultSpec("ckpt.torn", "torn_write",
                                                at=2)])
    with tfaults.active(plan):
        for s in (1, 2):
            mgr.save(s, m, block=True)
    assert mgr.steps() == [1, 2] and plan.fire_count() == 1
    with pytest.raises(CheckpointCorrupt, match="torn"):
        mgr.verify(2)
    errors, warns = ckpt_fsck.fsck_dir(str(tmp_path))
    assert len(errors) == 1 and "ckpt_000000000002.npz" in errors[0]
    assert warns == []


def test_uncommitted_npz_never_loadable(tmp_path):
    mgr = AsyncCheckpointManager(str(tmp_path), save_every=1)
    m = TinyModel()
    mgr.save(1, m, block=True)
    os.unlink(mgr.marker_path(1))   # crash between write and commit
    assert mgr.steps() == []
    assert mgr.restore_latest(TinyModel()) is None
    errors, warns = ckpt_fsck.fsck_dir(str(tmp_path))
    assert errors == [] and any("no commit marker" in w for w in warns)
    Path(tmp_path, "x.tmp").write_bytes(b"")
    assert any("stray temp" in w for w in ckpt_fsck.fsck_dir(
        str(tmp_path))[1])


def test_retention_keep_last_plus_keep_every(tmp_path):
    mgr = AsyncCheckpointManager(str(tmp_path), keep_last=2, keep_every=3,
                                 save_every=1)
    m = TinyModel()
    for s in range(1, 8):
        mgr.save(s, m, block=True)
    assert mgr.steps() == [3, 6, 7]
    files = sorted(os.listdir(str(tmp_path)))
    assert [f for f in files if f.endswith(".npz")] == \
        [f"ckpt_{s:012d}.npz" for s in (3, 6, 7)]


@pytest.mark.parametrize("kw", [dict(keep_last=0), dict(keep_every=-1)])
def test_manager_refuses_bad_retention(tmp_path, kw):
    with pytest.raises(ValueError):
        AsyncCheckpointManager(str(tmp_path), **kw)


def test_snapshot_is_a_copy_on_the_cpu(tmp_path):
    """The writer serialises what the step thread snapshotted, even when
    the next step updates the parameters in place before it runs."""
    m = _gpt2()
    gate = __import__("threading").Event()
    real = tcheckpoint.save_arrays

    def slow(arrays, fpath, aux=None):
        gate.wait(5)
        real(arrays, fpath, aux)
    want = {n: t.detach().clone() for n, t in m.get_states().items()}
    mgr = AsyncCheckpointManager(str(tmp_path))
    with mock.patch.object(tcheckpoint, "save_arrays", slow):
        mgr.save(1, m)
        with torch.no_grad():
            for t in m.get_params().values():
                t.add_(1.0)
        gate.set()
        mgr.close()
    arrays, _ = tcheckpoint.load_arrays(mgr.path(1))
    for n, t in want.items():
        assert np.array_equal(arrays[n], t.numpy()), n


# ---------------------------------------------------------------------------
# the orchestrator: preemption, retries, aborts, heartbeat, telemetry
# ---------------------------------------------------------------------------

def test_sigterm_checkpoints_at_step_boundary(tmp_path):
    store = str(tmp_path / "records.jsonl")

    def hook(step, outs):
        if step == 1:
            signal.raise_signal(signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    r = _tiny_runner(tmp_path, total=6, record_store=store, on_step=hook)
    res = r.run()
    assert res.outcome == "preempted" and res.steps == 2
    assert r.ckpt.steps() == [2]
    assert signal.getsignal(signal.SIGTERM) is prev
    entry = trecord.RunRecord(store).entries()[-1]
    assert entry["kind"] == "train_run"
    assert entry["payload"]["steps"] == 2
    assert entry["payload"]["outcome"] == "preempted"

    m2 = TinyModel()
    res2 = _tiny_runner(tmp_path, model=m2, total=6,
                        record_store=store).run()
    assert res2.resumed_from == 2 and res2.outcome == "completed"
    assert res2.steps == 6
    assert torch.equal(m2.w, 6 * torch.ones(4))
    assert trecord.RunRecord(store).validate() == []


def test_transient_failures_retry_with_backoff(tmp_path):
    class Flaky(TinyModel):
        fails_left = 2

        def train_step(self, x, y):
            if self.fails_left:
                self.fails_left -= 1
                raise RuntimeError("transient device error")
            return super().train_step(x, y)

    sleeps = []
    r = _tiny_runner(tmp_path, model=Flaky(), total=2, max_retries=3,
                     backoff_base=0.01, _sleep=sleeps.append)
    with pytest.warns(UserWarning, match="retrying"):
        res = r.run()
    assert res.outcome == "completed" and res.steps == 2
    assert sleeps == [0.01, 0.02]


def test_train_step_fault_site_is_retried_and_counted(tmp_path):
    ev = str(tmp_path / "events.jsonl")
    tevents.configure(path=ev)
    m = TinyModel()
    plan = tfaults.FaultPlan([tfaults.FaultSpec("train.step", "error",
                                                at=2)])
    r = _tiny_runner(tmp_path, model=m, total=3, _sleep=lambda s: None)
    with tfaults.active(plan), pytest.warns(UserWarning, match="retrying"):
        res = r.run()
    tevents.configure()
    assert res.steps == 3 and m._step_count == 3
    lines = [json.loads(ln) for ln in Path(ev).read_text().splitlines()]
    assert sum(1 for e in lines if e["name"] == "train.retries") == 1
    assert any(e["name"] == "train.step" and e.get("attempt") == 1
               for e in lines)


def test_liveness_probe_runs_on_the_models_device(tmp_path):
    probed = []

    def probe(device=None, timeout=30.0):
        probed.append(device)
        return True

    class Flaky(TinyModel):
        device = tdevice.create_device("cpu")
        fails_left = 1

        def train_step(self, x, y):
            if self.fails_left:
                self.fails_left -= 1
                raise OSError("transient")
            return super().train_step(x, y)

    m = Flaky()
    r = _tiny_runner(tmp_path, model=m, total=1, _sleep=lambda s: None)
    with mock.patch.object(tfailure, "device_liveness_check", probe), \
            pytest.warns(UserWarning, match="retrying"):
        r.run()
    assert probed == [m.device]


def test_repeated_failure_emergency_ckpt_record_fatal(tmp_path):
    class Dead(TinyModel):
        def train_step(self, x, y):
            raise RuntimeError("device gone")

    store = str(tmp_path / "records.jsonl")
    fatals = []
    r = _tiny_runner(tmp_path, model=Dead(), total=4, max_retries=1,
                     backoff_base=0.001, _sleep=lambda s: None,
                     record_store=store, on_fatal=fatals.append)
    with pytest.warns(UserWarning, match="retrying"):
        with pytest.raises(TrainAborted):
            r.run()
    assert fatals and "failed after 2 attempt" in fatals[0]
    assert r.ckpt.steps() == [0]
    entry = trecord.RunRecord(store).entries()[-1]
    assert entry["payload"]["outcome"] == "aborted"
    assert entry["payload"]["steps"] == 0
    ref = entry["payload"]["flight_ref"]
    assert (tmp_path / ref).exists()
    assert trecord.RunRecord(store).validate() == []


def test_emergency_ckpt_replays_the_failed_steps_batch(tmp_path):
    seen = []

    class Rec(TinyModel):
        def train_step(self, x, y):
            seen.append(np.asarray(x).copy())
            return super().train_step(x, y)

    class Dies(Rec):
        def train_step(self, x, y):
            if self._step_count >= 2:
                raise RuntimeError("device gone")
            return super().train_step(x, y)

    r = _tiny_runner(tmp_path, model=Dies(), total=4, max_retries=0,
                     on_fatal=lambda m: None)
    with pytest.raises(TrainAborted):
        r.run()
    m2 = Rec()
    res = _tiny_runner(tmp_path, model=m2, total=4).run()
    assert res.resumed_from == 2 and res.steps == 4
    x, y = _arrays()
    expected = [bx for bx, _ in _loader(x, y)][:4]
    assert len(seen) == 4
    for got, exp in zip(seen, expected):
        np.testing.assert_array_equal(got, exp)


def test_resume_without_run_state_uses_completed_step_convention(tmp_path):
    m = TinyModel()
    for _ in range(3):
        m.train_step(None, None)
    AsyncCheckpointManager(str(tmp_path / "ck")).save(3, m, block=True)
    m2 = TinyModel()
    r = _tiny_runner(tmp_path, model=m2, total=6)
    with pytest.warns(UserWarning, match="without run_state"):
        res = r.run()
    assert res.start_step == 3 and res.resumed_from == 3
    assert res.steps == 6
    assert torch.equal(m2.w, 6 * torch.ones(4))


def test_background_write_failure_takes_fatal_path(tmp_path, monkeypatch):
    def boom(arrays, fpath, aux=None):
        raise OSError("No space left on device")

    monkeypatch.setattr(tcheckpoint, "save_arrays", boom)
    store = str(tmp_path / "records.jsonl")
    fatals = []
    r = _tiny_runner(tmp_path, total=6, save_every=2, record_store=store,
                     on_fatal=fatals.append)
    with pytest.warns(UserWarning, match="emergency checkpoint failed"):
        with pytest.raises(TrainAborted, match="checkpoint write"):
            r.run()
    assert fatals and "No space left" in fatals[0]
    entry = trecord.RunRecord(store).entries()[-1]
    assert entry["payload"]["outcome"] == "aborted"
    assert trecord.RunRecord(store).validate() == []


def test_ckpt_write_fault_site_takes_fatal_path(tmp_path):
    fatals = []
    plan = tfaults.FaultPlan([tfaults.FaultSpec("ckpt.write", "error",
                                                at=1)])
    r = _tiny_runner(tmp_path, total=4, save_every=2, on_fatal=fatals.append)
    with tfaults.active(plan), pytest.raises(TrainAborted,
                                             match="checkpoint write"):
        r.run()
    # the step-2 write failed on the writer; the save at 4 met it and
    # took the fatal path, whose emergency save at 4 landed
    assert fatals and "InjectedFault" in fatals[0]
    assert r.ckpt.steps() == [4]


def test_final_save_not_duplicated_on_cadence_boundary(tmp_path):
    writes = []
    orig = tcheckpoint.save_arrays

    def counting(arrays, fpath, aux=None):
        writes.append(fpath)
        return orig(arrays, fpath, aux)

    r = _tiny_runner(tmp_path, total=4, save_every=2)
    with mock.patch.object(tcheckpoint, "save_arrays", counting):
        res = r.run()
    assert res.outcome == "completed"
    assert len(writes) == len(set(writes)) == 2


def test_programming_errors_do_not_retry(tmp_path):
    class Buggy(TinyModel):
        def train_step(self, x, y):
            raise ValueError("shape bug")

    r = _tiny_runner(tmp_path, model=Buggy(), total=2,
                     on_fatal=lambda m: None)
    with pytest.raises(ValueError, match="shape bug"):
        r.run()


def test_heartbeat_hang_appends_record_and_fires(tmp_path):
    store = str(tmp_path / "records.jsonl")
    fatals = []

    def hook(step, outs):
        if step == 0:
            time.sleep(0.5)

    r = _tiny_runner(tmp_path, total=2, record_store=store, on_step=hook,
                     on_fatal=fatals.append)
    r.heartbeat = tfailure.Heartbeat(timeout=0.15, check_every=0.03,
                                     on_failure=r._heartbeat_failure)
    res = r.run()
    r.__exit__()
    assert r.heartbeat.fired and fatals
    assert "no heartbeat" in fatals[0]
    entry = trecord.RunRecord(store).entries()[-1]
    assert entry["payload"]["outcome"] == "hung"
    assert (tmp_path / entry["payload"]["flight_ref"]).exists()
    assert res.steps == 2
    assert len(trecord.RunRecord(store).entries()) == 1   # exactly once


def test_async_write_overlaps_stepping(tmp_path, monkeypatch):
    ev = str(tmp_path / "events.jsonl")
    tevents.configure(path=ev)
    real = tcheckpoint.save_arrays

    def slow_save(arrays, fpath, aux=None):
        time.sleep(0.25)
        real(arrays, fpath, aux)

    monkeypatch.setattr(tcheckpoint, "save_arrays", slow_save)
    r = _tiny_runner(tmp_path, total=8, save_every=3,
                     on_step=lambda s, o: time.sleep(0.01))
    res = r.run()
    r.__exit__()
    tevents.configure()
    assert res.outcome == "completed"
    spans = [json.loads(ln) for ln in open(ev)]
    spans = [s for s in spans if s["kind"] == "span"]

    def window(s):
        return s["t"] - s["dur_ms"] / 1e3, s["t"]

    writes = [window(s) for s in spans if s["name"] == "train.ckpt.write"]
    steps = [window(s) for s in spans if s["name"] == "train.step"]
    assert writes and steps
    overlapped = sum(1 for (s0, s1) in steps
                     if any(w0 < s0 and s1 < w1 for (w0, w1) in writes))
    assert overlapped >= 1, (writes, steps)
    snaps = [s["dur_ms"] for s in spans if s["name"] == "train.ckpt.snapshot"]
    assert snaps and max(snaps) < 200.0
    # the writer carries the run's trace
    assert {s.get("trace") for s in spans
            if s["name"] == "train.ckpt.write"} == {r.run_id}


def test_preemption_handler_restores_handlers():
    p = PreemptionHandler(signals=(signal.SIGTERM,))
    prev = signal.getsignal(signal.SIGTERM)
    with p:
        assert not p.requested
        signal.raise_signal(signal.SIGTERM)
        assert p.requested and p.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is prev


def test_second_sigint_raises_keyboard_interrupt():
    p = PreemptionHandler(signals=(signal.SIGINT,))
    with p:
        signal.raise_signal(signal.SIGINT)
        assert p.requested
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGINT)


def test_preemption_handler_off_the_main_thread_warns():
    import threading
    got = []

    def body():
        with pytest.warns(UserWarning, match="main thread"):
            p = PreemptionHandler().install()
        got.append(p._installed)
    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert got == [False]


@pytest.mark.parametrize("total", [0, -1])
def test_runner_refuses_no_steps(total):
    with pytest.raises(ValueError, match="total_steps"):
        TrainRunner(TinyModel(), None, total)


def test_runner_turns_batches_into_tensors_on_the_models_device(tmp_path):
    m = tmodels.MLP(perceptron_size=(8,), num_classes=CLASSES,
                    input_shape=(DIM,), device=tdevice.create_device("cpu"))
    r = TrainRunner(m, None, 1)
    x, y = _arrays()
    bx, by = r._to_tensors((x[:BS], y[:BS]))
    assert bx.dtype == torch.float32 and by.dtype == torch.int32
    assert bx.device.type == "cpu" and np.array_equal(by.numpy(), y[:BS])
    ids, none = r._to_tensors((np.zeros((2, 4), np.int32), None))
    assert ids.dtype == torch.int32 and none is None


# ---------------------------------------------------------------------------
# ZeRO-1: sharded optimizer state through the orchestrator, world of 2
# ---------------------------------------------------------------------------

ZERO1_WORKER = r'''
import os, sys, traceback
sys.path.insert(0, sys.argv[4])
import numpy as np
import torch
torch.set_num_threads(1)
from singa_tpu_torch import device, models, opt, parallel
from singa_tpu_torch.train import AsyncCheckpointManager, TrainRunner
from singa_tpu_torch.utils.data import DataLoader

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
CPU = device.create_device("cpu")
r = np.random.RandomState(1)
X = r.randn(64, 16).astype(np.float32)
Y = r.randint(0, 4, 64).astype(np.int32)


def build():
    m = models.MLP(perceptron_size=(16,), num_classes=4, input_shape=(16,),
                   device=CPU, generator=torch.Generator().manual_seed(0))
    m.set_optimizer(opt.DistOpt(opt.Adam(lr=1e-2), shard_weight_update=True))
    m.compile([torch.from_numpy(X)], is_train=True, use_graph=True)
    return m


def run(m, d, total):
    ld = DataLoader(X, Y, batch_size=64, seed=3, drop_last=True)
    rn = TrainRunner(m, ld, total, ckpt=AsyncCheckpointManager(
        os.path.join(out, d), save_every=1))
    res = rn.run()
    rn.__exit__()
    return res


try:
    parallel.init_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
    parallel.set_mesh(parallel.data_parallel_mesh())
    straight = build()
    run(straight, "a", 4)
    run(build(), "b", 3)
    resumed = build()
    res = run(resumed, "b", 4)
    arrays = {"resumed_from": np.asarray(res.resumed_from)}
    for tag, m in (("straight", straight), ("resumed", resumed)):
        for n, t in m.get_params().items():
            arrays[f"{tag}/{n}"] = t.detach().numpy()
        for n, leaves in m.optimizer.slot_arrays().items():
            for i, leaf in enumerate(leaves):
                arrays[f"{tag}/slot/{n}/{i}"] = leaf.detach().numpy()
    np.savez(os.path.join(out, f"r{rank}.npz"), **arrays)
    parallel.finalize_distributed()
except BaseException:
    traceback.print_exc()
    sys.exit(1)
'''


@pytest.fixture(scope="module")
def zero1_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero1")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK", "SINGA_COORDINATOR")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", ZERO1_WORKER, str(r), str(port), str(out),
         str(REPO)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [lg[-3000:] for lg in logs]
    return [dict(np.load(out / f"r{r}.npz")) for r in range(2)], out


def test_zero1_state_round_trips_through_the_orchestrator(zero1_world):
    ranks, out = zero1_world
    for res in ranks:
        assert int(res["resumed_from"]) == 3
        straight = {k[len("straight/"):]: v for k, v in res.items()
                    if k.startswith("straight/")}
        assert any(k.startswith("slot/") for k in straight)
        for k, v in straight.items():
            np.testing.assert_array_equal(res["resumed/" + k], v,
                                          err_msg=k)
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)
    # the commits hold natural-shaped moments that fsck accepts
    assert ckpt_fsck.fsck_dir(str(out / "b")) == ([], [])


# ---------------------------------------------------------------------------
# timing, metrics, profiler, prefetch
# ---------------------------------------------------------------------------

def test_windowed_and_fenced_steps_keep_the_references_api():
    calls = []

    def step():
        calls.append(1)
        return torch.ones(3)

    sec, stats = ttiming.windowed_steps(step, windows=3, window_len=4,
                                        warmup=2)
    _, jstats = jtiming.windowed_steps(lambda: np.ones(3), windows=3,
                                       window_len=4, warmup=2)
    assert stats.keys() == jstats.keys()
    assert (stats["method"], stats["windows"], stats["n"]) == \
        ("windowed", 3, 12)
    assert len(calls) == 14 and sec >= 0
    sec, stats = ttiming.fenced_steps(step, steps=5, warmup=1)
    _, jstats = jtiming.fenced_steps(lambda: np.ones(3), steps=5, warmup=1)
    assert stats.keys() == jstats.keys() and stats["n"] == 5
    assert stats["min"] <= stats["median"] <= stats["max"]


def test_windowed_steps_budget_keeps_one_window_and_emits_a_gauge(tmp_path):
    ev = str(tmp_path / "e.jsonl")
    tevents.configure(path=ev)
    left = iter([100.0] * 6 + [0.0] * 50)
    sec, stats = ttiming.windowed_steps(lambda: None, windows=5,
                                        window_len=4, warmup=1,
                                        budget_left=lambda: next(left))
    tevents.configure()
    assert stats["windows"] == 1 and sec >= 0
    gauges = [json.loads(ln) for ln in Path(ev).read_text().splitlines()]
    assert [g["name"] for g in gauges] == ["timing.windowed.step_ms"]
    assert gauges[0]["method"] == "windowed"


def test_accuracy_mfu_and_peaks():
    rng = np.random.RandomState(0)
    logits = rng.randn(16, 5).astype(np.float32)
    labels = rng.randint(0, 5, 16)
    assert tmetrics.accuracy(logits, labels) == \
        jmetrics.accuracy(logits, labels)
    assert tmetrics.accuracy(torch.from_numpy(logits),
                             torch.from_numpy(labels)) == \
        jmetrics.accuracy(logits, labels)
    h100 = "NVIDIA H100 80GB HBM3"
    assert tmetrics.peak_hbm_bw(h100) == 3.35e12
    assert tmetrics.peak_flops(h100) == 989e12
    for fn in (tmetrics.peak_hbm_bw, tmetrics.peak_flops):
        # other H100 parts have other rates: no SXM peak for them
        for kind in ("cpu", "NVIDIA H100 PCIe", "NVIDIA H100 NVL"):
            with pytest.raises(ValueError, match="known"):
                fn(kind)
    with mock.patch.dict(os.environ, {"SINGA_PEAK_TFLOPS": "989"}):
        want = jmetrics.mfu(3.0e15, 0.5, 2, device_kind="x")
    assert tmetrics.mfu(3.0e15, 0.5, 2, device_kind=h100) == want


def test_metrics_logger_lines_equal_the_references(tmp_path, capsys):
    kw = dict(t=1.5, step=np.int64(3), loss=np.float32(0.25),
              lr=torch.tensor(0.5), name="run")
    for mod, name in ((tmetrics, "port"), (jmetrics, "ref")):
        lg = mod.MetricsLogger(str(tmp_path / f"{name}.jsonl"), echo=True)
        lg.log(**kw)
        lg.close()
    port, ref = ((tmp_path / f"{n}.jsonl").read_text() for n in ("port",
                                                                  "ref"))
    assert port == ref and json.loads(port)["loss"] == 0.25
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]


def test_step_profiler_and_device_trace(tmp_path):
    prof = tprofiler.StepProfiler(warmup=1)
    for _ in range(3):
        with prof.step():
            pass
    s = prof.summary()
    assert s["steps_timed"] == 2 and "mfu" not in s
    with tprofiler.device_trace(str(tmp_path / "tr")) as d:
        torch.ones(8).add_(1)
    files = list(Path(d).glob("trace.*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0


def test_profile_model_counts_the_train_graph():
    m = tmodels.MLP(perceptron_size=(8,), num_classes=CLASSES,
                    input_shape=(DIM,), device=tdevice.create_device("cpu"))
    m.set_optimizer(topt.SGD(lr=0.1))
    x, y = _arrays()
    bx, by = torch.from_numpy(x[:BS]), torch.from_numpy(y[:BS])
    m.compile([bx], is_train=True, use_graph=True)
    s = tprofiler.profile_model(m, (bx, by), steps=2, warmup=1)
    assert s["steps_timed"] == 2 and s["bytes_accessed_per_step"] > 0
    assert s["arithmetic_intensity"] > 0 and "mfu" not in s


def test_prefetch_to_device_yields_the_references_batches():
    rng = np.random.RandomState(0)
    batches = [(rng.randn(2, 3).astype(np.float32), None,
                {"y": rng.randint(0, 4, 2)}) for _ in range(5)]
    got = list(tdata.prefetch_to_device(iter(batches), size=2,
                                        device=tdevice.create_device("cpu")))
    want = list(jdata.prefetch_to_device(iter(batches), size=2))
    assert len(got) == len(want) == 5
    for (gx, gn, gd), (wx, wn, wd) in zip(got, want):
        assert isinstance(gx, torch.Tensor) and gn is None and wn is None
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gd["y"].numpy(), np.asarray(wd["y"]))
    assert list(tdata.prefetch_to_device(iter([]), device="cpu")) == []
    lists = list(tdata.prefetch_to_device([[np.zeros(1)]], size=4,
                                          device="cpu"))
    assert isinstance(lists[0], list)
