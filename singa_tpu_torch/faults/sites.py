"""Injection-site registry: the named seams where faults can be fired,
a copy of ``singa_tpu/faults/sites.py`` (the two registries are equal,
so a plan names the same sites in either package).

A *site* is a host-side hook (`faults.fire(name, ...)` or
`faults.corrupt(name, value)`) placed at a failure seam the robustness
machinery claims to survive.  The registry is the contract between the
chaos tests and the code under test: a :class:`~singa_tpu_torch.faults.
plan.FaultPlan` naming an unregistered site fails at construction
(catching typos before a chaos run silently injects nothing).  The
port wires ``device.execute`` (the step executor and generate()
sessions), ``comm.collective`` (each staged collective of
``parallel.communicator``: once per eager call and once when a step is
captured, never on a replay) and the serve engine's ``serve.prefill``,
``serve.decode`` and ``serve.block_alloc``; the other sites name seams
of modules still to be ported.

Every site fires host-side Python, never inside a captured CUDA graph,
so activating a plan cannot change a captured program.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["SITES", "INCIDENT_SITES", "supported_kinds", "is_known",
           "is_incident_site"]

#: site name -> (description, kinds the site supports).
#: ``error``/``hang`` are raised/slept by :func:`faults.fire` before the
#: guarded operation dispatches; ``torn_write`` truncates the file named
#: by the site's ``path`` context; ``torn_frame`` truncates the bytes
#: payload flowing past the site (applied by :func:`faults.tear`);
#: ``nan`` is applied by :func:`faults.corrupt` to the value flowing
#: PAST the site.
SITES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "device.execute": (
        "compiled step-graph dispatch (model step executor); nan "
        "corrupts the step outputs (loss) after a clean dispatch",
        ("error", "hang", "nan")),
    "comm.collective": (
        "collective staging in parallel.communicator (allreduce / "
        "allgather / reduce_scatter / ppermute / broadcast); fires "
        "host-side at staging, so an injected error surfaces at trace "
        "time like a failed collective launch.  Collectives are "
        "in-graph ops: the site counts graph (re)traces, NOT "
        "executions — at=/every= triggers count traces, and a plan "
        "activated after warmup injects nothing until something "
        "retraces",
        ("error", "hang")),
    "ckpt.write": (
        "checkpoint serialization in train.ckpt (before the npz is "
        "written); an injected error surfaces through "
        "AsyncCheckpointManager.wait() exactly like ENOSPC",
        ("error", "hang")),
    "ckpt.torn": (
        "after the commit marker lands (ctx: path) — torn_write "
        "truncates the committed npz, simulating a crash/bit-rot torn "
        "file that the sha-checked restore path must skip",
        ("torn_write",)),
    "serve.prefill": (
        "serve engine prefill-into-slot dispatch (per admission)",
        ("error", "hang")),
    "serve.decode": (
        "serve engine decode-over-block-tables dispatch (per tick)",
        ("error", "hang")),
    "serve.block_alloc": (
        "paged KV arena block allocation (admission reserve and "
        "decode-time growth); fires BEFORE the host-side allocation, "
        "so refcounts/tables are untouched — an injected error at "
        "admission quarantines the request, mid-stream (growth) it "
        "escalates to an arena rebuild that reconstructs block tables "
        "and refcounts",
        ("error", "hang")),
    "serve.verify": (
        "speculative verify-round dispatch (draft propose-k + target "
        "verify-k over the paged arena, serve/spec.py); fires BEFORE "
        "the jitted call, so the donated arenas survive — an injected "
        "error past the retry budget makes THAT tick fall back to "
        "plain decode instead of wedging the slot or rebuilding the "
        "arena: the accepted stream is unchanged (plain decode is the "
        "same target argmax), only the draft cache takes a gap that "
        "can lower later accept rates",
        ("error", "hang")),
    "serve.handoff": (
        "disaggregated-tier KV block handoff (the Router moving a "
        "finished prefill's blocks from a prefill worker to a decode "
        "worker); fires BEFORE extraction, so an injected error models "
        "a worker dying mid-handoff with the source arena's host state "
        "intact — the router re-routes: the request re-prefills from "
        "prompt (+ tokens so far) on a prefill worker and its greedy "
        "stream is unchanged",
        ("error", "hang")),
    "serve.spill": (
        "KV spill tier seams (serve/mem.py, both directions): the "
        "spill WRITE when an evicted refcount-0 prefix block's bytes "
        "are copied to the host store, and the prefetch READ when a "
        "prefix hit restores a spilled block into a free physical "
        "block; fires BEFORE either copy, so an injected error only "
        "DEGRADES — the block dies unspilled / the prefix re-prefills, "
        "exactly the pre-spill behavior — streams stay bitwise "
        "identical and the fault lands as a serve.spill incident with "
        "a flight dump",
        ("error", "hang")),
    "serve.router": (
        "disaggregated-tier routing decision (per Router.submit, "
        "before a prefill worker is chosen); an injected error "
        "surfaces to the submitter like a routing outage — requests "
        "already inside the tier are unaffected",
        ("error", "hang")),
    "serve.transport": (
        "multi-process KV wire transport (serve/net: every framed "
        "handoff payload, send and receive side); fires BEFORE the "
        "bytes move, and torn_frame truncates the serialized package "
        "mid-wire (faults.tear on the payload).  NEVER retried in "
        "place: the codec's digest check rejects a torn frame before "
        "inject, the supervisor treats any transport fault as a dead "
        "handoff and re-routes the request via replay (prompt + tokens "
        "so far on a surviving prefill worker), so streams stay "
        "bitwise and a torn transfer is never injected",
        ("error", "hang", "torn_frame")),
    "serve.resize": (
        "elastic pool resize (serve/net supervisor, before a grow "
        "spawn or drain-shrink mutates the tier); an injected error "
        "aborts THAT resize cleanly — the worker set, in-flight "
        "streams and admission are untouched, and the autoscaler "
        "simply re-evaluates on a later round (no quarantine: resizes "
        "are idempotent tier-shape goals, not per-request work)",
        ("error", "hang")),
    "serve.respawn": (
        "self-healing respawn decision (serve/net supervisor, before "
        "a replacement worker spawn is scheduled for a dead one); an "
        "injected error makes THAT attempt fail — it counts toward "
        "the capped exponential backoff and is retried at a later "
        "step boundary — and a hang delays the decision; the tier is "
        "otherwise untouched (the dead worker's requests already "
        "replayed on survivors before respawn runs)",
        ("error", "hang")),
    "train.step": (
        "TrainRunner's retried step region (the shared injector the "
        "train retry/backoff path is exercised through)",
        ("error", "hang")),
    "data.next": (
        "DataLoader batch draw; nan corrupts the float parts of the "
        "yielded batch",
        ("error", "hang", "nan")),
}


#: subsystem seams that appear in incident records / flight-recorder
#: dumps but are NOT injection sites (nothing fires there — they name
#: where the SYSTEM acted, not where a fault was injected):
#: ``serve.arena`` (arena rebuild/recovery), ``serve.crashloop`` (the
#: respawn circuit breaker giving up on a role after K deaths in a
#: window — the tier degrades to survivors), ``train.fatal`` (retry
#: exhaustion / checkpoint-write failure), ``train.hung`` (heartbeat
#: hang abort).  ``FlightRecorder.dump`` accepts SITES plus these, so
#: a typo'd dump site fails loudly instead of silently never dumping.
INCIDENT_SITES: Tuple[str, ...] = ("serve.arena", "serve.crashloop",
                                   "train.fatal", "train.hung")


def is_known(site: str) -> bool:
    return site in SITES


def is_incident_site(site: str) -> bool:
    """Valid name for an incident record / flight dump: any injection
    site, or one of the recovery/fatal seams in INCIDENT_SITES."""
    return site in SITES or site in INCIDENT_SITES


def supported_kinds(site: str) -> Tuple[str, ...]:
    return SITES[site][1] if site in SITES else ()
