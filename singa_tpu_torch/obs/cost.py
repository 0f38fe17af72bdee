"""Per-program analytic features of a live serving engine, the port's
counterpart of ``tools/lint/perf.py``'s ``engine_features``.

The reference lowers each engine program to optimized HLO and runs its
cost model over the text.  The port has no HLO: each engine program
(``serve/program.py`` :class:`~singa_tpu_torch.serve.program.Program`)
is recorded at its first dispatch as a
:class:`~singa_tpu_torch.graph.CapturedGraph`, which counts the FLOPs
of its matrix products and the bytes every aten op of one dispatch
reads and writes.  Those two numbers are a program's modeled side in
:func:`~singa_tpu_torch.obs.attr.attribution_payload`.

:func:`perf_attr_payload` joins an attribution ledger's snapshot
against them: on a card the achieved fraction is taken against the
card's peaks (:data:`CARD_PEAKS`), on the CPU against the nominal box
of ``obs.attr``.
"""

from __future__ import annotations

from typing import Any, Dict, List

from . import attr

__all__ = ["engine_features", "attr_source_engines", "perf_attr_payload",
           "CARD_PEAKS"]

#: (FLOP/s, bytes/s) the achieved fraction is taken against on a card:
#: an NVIDIA H100 SXM's data-sheet dense bf16 peak and HBM3 bandwidth
CARD_PEAKS = (989e12, 3.35e12)


def engine_features(engine) -> Dict[str, Dict[str, float]]:
    """``{program key: {"flops", "hbm_bytes"}}`` of every program
    ``engine`` has dispatched, keyed as its dispatch seam notes them in
    the ledger (``prefill_chunk``, ``decode`` — ``decode_int8`` on an
    int8 arena —, ``verify``).  A program not yet dispatched has no
    recorded graph and no row."""
    out: Dict[str, Dict[str, float]] = {}
    progs = {"serve.prefill": engine._prefill,
             "serve.decode": engine._decode,
             "serve.verify": engine._verify}
    for site, prog in progs.items():
        g = getattr(prog, "graph", None)
        if g is None:
            continue
        out[engine._attr_program(site)] = {
            "flops": float(g.flops()), "hbm_bytes": float(g.bytes_accessed())}
    return out


def attr_source_engines(target) -> List[Any]:
    """The ServeEngines whose programs ran ``target``'s dispatches: the
    engine itself, or an in-process tier's workers' engines (decode
    workers first).  Empty for a process tier: its engines live in
    other processes."""
    if hasattr(target, "_attr_program"):
        return [target]
    pools = (getattr(target, "decode", None) or []) + \
        (getattr(target, "prefill", None) or [])
    return [w.engine for w in pools if getattr(w, "engine", None)]


def perf_attr_payload(snapshot: Dict[str, Dict[str, float]], target,
                      window_s: float) -> Dict[str, Any]:
    """The ``perf_attr`` payload of a load window: the ledger's
    ``snapshot`` joined against :func:`engine_features` of the engines
    behind ``target`` (a tier's workers run the same programs at the
    same shapes: the first engine that dispatched a program gives its
    row).  Raises when there is no engine to attribute against or no
    program of the snapshot has a feature row."""
    engines = attr_source_engines(target)
    if not engines:
        raise RuntimeError("no in-process engine to attribute against "
                           "(a process tier keeps its ledgers in its "
                           "workers)")
    features: Dict[str, Dict[str, float]] = {}
    for eng in engines:
        for name, row in engine_features(eng).items():
            features.setdefault(name, row)
    peaks = {}
    if engines[0]._device.type == "cuda":
        peaks = dict(zip(("flops_per_s", "bytes_per_s"), CARD_PEAKS))
    payload = attr.attribution_payload(snapshot, features, window_s,
                                       **peaks)
    if not payload["programs"]:
        raise RuntimeError(f"no dispatched program of the ledger "
                           f"({sorted(snapshot)}) has a feature row")
    return payload
