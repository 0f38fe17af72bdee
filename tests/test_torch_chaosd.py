"""The port's chaos-campaign driver (singa_tpu_torch.tools.chaosd)
against the JAX package's (tools/chaosd.py), on the CPU: the seeded
schedule, its composition and the event tables equal the reference's
for several seeds and prefixes; the invariant checks and the death and
respawn clocks on stand-in tiers; and, in the slow lane (as the
reference marks its own), the chaos smoke against a live process tier
whose record the port's schema accepts."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from singa_tpu_torch.obs import record as trecord
from singa_tpu_torch.obs import schema as tschema
from singa_tpu_torch.tools import chaosd as tchaos
from singa_tpu_torch.tools import loadgen as tload
from tools import chaosd as jchaos

SEEDS = (0, 1, 7, 19, 2024, 2 ** 31 - 1)


def test_tables_equal_the_reference():
    assert tchaos.EVENT_KINDS == jchaos.EVENT_KINDS
    assert tchaos.FAULT_PLANS == jchaos.FAULT_PLANS
    assert tchaos.CHAOS_OP_TIMEOUTS == jchaos.CHAOS_OP_TIMEOUTS
    assert tchaos.CHAOS_COMPILE_TIMEOUT_S == jchaos.CHAOS_COMPILE_TIMEOUT_S
    assert tchaos.ENGINE_KW == jchaos.ENGINE_KW
    assert (tchaos._PROMPT_LENS, tchaos._NEW_TOKENS, tchaos.SMOKE_SEED) == \
        (jchaos._PROMPT_LENS, jchaos._NEW_TOKENS, jchaos.SMOKE_SEED)


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_events_equal_the_reference(seed):
    for n in (0, 1, 6, 40):
        got = tchaos.plan_events(seed, n)
        assert got == jchaos.plan_events(seed, n)
        assert tchaos.composition(got) == jchaos.composition(got)
        assert sum(tchaos.composition(got).values()) == n
        # a schedule's prefix is the shorter schedule
        assert tchaos.plan_events(seed, n // 2) == got[:n // 2]
    for parts in (("kind", 0), ("role", 5), ("plan", 3), ("nd", 9),
                  ("wl", 2), ("victim", 1)):
        assert tchaos._det_u32(seed, *parts) == jchaos._det_u32(seed, *parts)


def test_the_schedule_covers_every_kind():
    seen = set()
    for seed in range(20):
        seen |= {ev["kind"] for ev in tchaos.plan_events(seed, 6)}
    assert seen == set(tchaos.EVENT_KINDS)


class _Proc:
    def __init__(self, pid, alive):
        self.pid, self._alive = pid, alive

    def poll(self):
        return None if self._alive else 0


class _Worker:
    def __init__(self, name, pid, compiles=(1, 1), handoff=1, alive=True):
        self.name, self.alive = name, alive
        self.proc = _Proc(pid, alive)
        self._rep = {"compiles": list(compiles), "handoff_compiles": handoff}

    def call(self, hdr):
        assert hdr == {"op": "health"}
        return dict(self._rep), b""


def _tier(workers, procs):
    return SimpleNamespace(workers=lambda: workers,
                           fabric=SimpleNamespace(procs=procs))


def test_check_invariants_finds_each_violation(tmp_path):
    good = [_Worker("p0", 11), _Worker("d0", 12)]
    procs = [w.proc for w in good] + [_Proc(13, False)]
    assert tchaos.check_invariants(_tier(good, procs), None) == []
    bad = [_Worker("p0", 11, compiles=(1, 2)), _Worker("d0", 12, handoff=2)]
    orphan = _Proc(14, True)
    problems = tchaos.check_invariants(
        _tier(bad, [w.proc for w in bad] + [orphan]), None)
    assert len(problems) == 3
    assert "p0: compiled_counts() grew to [1, 2]" in problems[0]
    assert "handoff program recompiled" in problems[1]
    assert "orphan worker process pid=14" in problems[2]
    store = tmp_path / "records.jsonl"
    (tmp_path / "incidents").mkdir()
    (tmp_path / "incidents" / "ok.jsonl").write_text("{}\n")
    store.write_text(json.dumps({"payload": {"flight_ref":
                                             "incidents/ok.jsonl"}}) + "\n"
                     + json.dumps({"payload": {"flight_ref":
                                               "incidents/gone.jsonl"}})
                     + "\nnot json\n")
    problems = tchaos.check_invariants(_tier(good, []), str(store))
    ref = jchaos.check_invariants(_tier(good, []), str(store))
    assert problems == ref and len(problems) == 2
    assert "gone.jsonl" in problems[0] and "unparseable" in problems[1]


def test_the_clock_times_deaths_and_respawns(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(tchaos.time, "monotonic", lambda: now[0])
    metrics = SimpleNamespace(worker_deaths=0, respawns=0)
    clock = tchaos._Clock(SimpleNamespace(metrics=metrics))
    clock.fired()                   # a kill at t = 100
    now[0] = 100.5
    metrics.worker_deaths = 1
    clock.poll()
    now[0] = 104.0
    clock.fired()                   # a hang at t = 104
    now[0] = 112.0
    metrics.worker_deaths, metrics.respawns = 2, 1
    clock.poll()
    now[0] = 115.0
    metrics.respawns = 2
    clock.poll()
    assert clock.detect_s == [0.5, 8.0]
    assert clock.respawn_s == [11.5, 3.0]


def test_loadgen_hands_a_campaign_to_chaosd(monkeypatch):
    """--chaos-campaign builds the reference's chaosd argv, plus the
    port's model and device flags."""
    got, ref = [], []
    monkeypatch.setattr(tchaos, "main", lambda argv: got.append(argv) or 0)
    monkeypatch.setattr(jchaos, "main", lambda argv: ref.append(argv) or 0)
    from tools import loadgen as jload
    argv = ["--chaos-campaign", "--seed", "5", "--chaos-events", "3",
            "--rate", "12", "--prefill-workers", "1", "--decode-workers",
            "2", "--store", "x.jsonl", "--no-record"]
    assert jload.main(argv) == 0
    assert tload.main(argv + ["--device", "cpu", "--layers", "1"]) == 0
    (g,), (r,) = got, ref
    port_only = {"--config": "tiny", "--device": "cpu", "--layers": "1"}
    pairs = dict(zip(g[::2], g[1::2]))
    assert {k: pairs[k] for k in port_only} == port_only
    rest = [a for i, a in enumerate(g)
            if a not in port_only and (i == 0 or g[i - 1] not in port_only)]
    assert rest == r


def test_cli_refuses_a_device_it_cannot_make():
    rc = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.tools.chaosd", "--smoke",
         "--device", "tpu"], capture_output=True, text=True)
    assert rc.returncode != 0 and "unknown device kind" in rc.stderr


@pytest.mark.slow
def test_chaos_smoke_commits_a_reassertable_record(tmp_path):
    """The chaos smoke end to end on the CPU (1 SIGKILL + 1 SIGSTOP
    against a live 2-process 1:1 tier), plus the record contract: the
    campaign entry validates, its flight evidence resolves, and both
    deaths were timed."""
    store = str(tmp_path / "records.jsonl")
    fails, res = tchaos.run_smoke(store, device="cpu")
    assert fails == []
    ents = [e for e in trecord.RunRecord(store).entries()
            if e["kind"] == "chaos_campaign"]
    assert len(ents) == 1
    p = ents[0]["payload"]
    tschema.validate_chaos_campaign_payload(p)
    assert p["bitwise_ok"] is True and p["completed"] == p["requests"]
    assert p["worker_deaths"] >= 2 and p["respawns"] >= 2
    assert (tmp_path / p["flight_ref"]).exists()
    assert len(res["timings"]["detect_s"]) == 2
    assert len(res["timings"]["respawn_s"]) == 2


@pytest.mark.slow
def test_seeded_campaign_matches_its_schedule(tmp_path):
    """A seeded campaign's record re-derives from plan_events."""
    store = str(tmp_path / "records.jsonl")
    res = tchaos.run_campaign(19, 3, per_phase=3, store=store,
                              device="cpu")
    assert res["ok"], res["problems"]
    comp = tchaos.composition(tchaos.plan_events(19, 3))
    p = res["payload"]
    assert (p["kills"], p["hangs"], p["fault_plans"], p["resizes"]) == \
        (comp["kill"], comp["hang"], comp["fault"], comp["resize"])
