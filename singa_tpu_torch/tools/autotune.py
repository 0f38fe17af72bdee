"""autotune — the port's record-driven autotuner, ported from the JAX
package's ``tools/autotune.py``: sweep the knobs the port exposes,
fit the deterministic predictor on the records, and commit the port's
best-config table that ``ServeEngine``, the elastic policy and the
load driver consult by default::

    # measure a knob grid -> one autotune_sweep record per point (on
    # the card: the card sweep, CARD_SWEEP; --grid and the workload
    # flags override it)
    python -m singa_tpu_torch.tools.autotune sweep --domain serve
    python -m singa_tpu_torch.tools.autotune sweep --domain train

    # fit the predictor on the newest sweep, print the LOO report,
    # append the fit record, and (reviewed flow) rewrite the table
    python -m singa_tpu_torch.tools.autotune fit --domain serve \\
        --platform cuda --update-best

    # what would a consumer resolve right now?
    python -m singa_tpu_torch.tools.autotune best --domain serve \\
        --model llama-d2048-L2 --platform cuda

    # validate the committed table against the port's record store
    python -m singa_tpu_torch.tools.autotune check

    # a tiny 2-point sweep -> fit -> table round trip in a temporary
    # store, plus the committed-table check
    python -m singa_tpu_torch.tools.autotune smoke --device cpu

Sweep measurements go through the same entry points a user calls.  A
serve point builds a fresh ``ServeEngine`` at the point's arena shape
(its programs captured anew: ``num_slots``, ``block_size`` and
``spec_k`` change every captured shape) and drives the load driver's
open-loop workload through it (``loadgen.build_workload`` /
``run_load``); its features are the tick program's recorded FLOPs and
bytes (``obs.cost.engine_features``: the decode program, or the verify
program of a speculative engine) and the programs' graph pool bytes.
A train point builds the configuration with the point's fused-loss
chunk, wraps SGD in ``DistOpt`` (``int8_ring`` or not) over a process
group of one (NCCL on the card, gloo on the CPU) and times replays of
the captured step; its features are the captured step's FLOPs and
graph pool bytes and the communicator's wire-byte model at the
group's world size (0 at a world of 1).  On the card base() at
T = 1024 runs the three flash kernels in every train point.  Every
point's graphs and engine are freed before the next point.

``--device auto`` (the default) is the card and raises without one.
A sweep's defaults follow its device: on the card the card sweep
(:data:`CARD_SWEEP`, :data:`CARD_GRIDS`: base() cut to 2 layers, the
serve points under the chat traffic of the load driver's
``CHAT_WORKLOAD``), on the CPU the reference's tiny sizes.  The
records go to the autotuner's store (``runs/torch/autotune.jsonl``,
:data:`STORE`: the committed table's evidence, apart from the load
driver's ``runs/torch/records.jsonl``), entries are keyed
``domain/model/platform`` with the port's ``model_key``
(``train/llama-d2048-L2-dp1/cuda``), and a fit records the card's name
and power limit beside its objective (``--card``, nvidia-smi's
``name,power.limit``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import socket
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

__all__ = ["main", "serve_measure", "train_measure", "train_model_key",
           "check_errors", "sweep_defaults", "CARD_SWEEP", "CARD_GRIDS",
           "STORE"]

#: the autotuner's record store, relative to the repository: the
#: committed table cites only run ids of this store
STORE = os.path.join("runs", "torch", "autotune.jsonl")

#: the card sweep that made the committed table's cuda entries:
#: base() cut to 2 layers from seed 0.  Serve points run the load
#: driver's chat traffic (``loadgen.CHAT_WORKLOAD``), 96 requests
#: offered at 1,000/s, far above capacity, so that the engine is ranked
#: and not the Poisson clock, in arenas of 1,024 positions (a chat
#: prompt and its budget need up to 832); median tokens/s of 3 runs.
#: Train points run T = 1024, so every point launches the three flash
#: kernels, and time 8 replays of the captured step
CARD_SWEEP = dict(config="base", layers=2, requests=96, rate=1000.0,
                  trials=3, max_len=1024, seq=1024, steps=8)

#: the card sweep's grids.  Serve slots run past the traffic's 96
#: requests, so that tokens/s turns down inside the grid.  The train
#: objective is the reference's ``step_ms``, which a smaller batch
#: always wins: batch is swept for the record, and the table's batch is
#: the grid's smallest
CARD_GRIDS: Dict[str, Dict[str, List[int]]] = {
    "serve": {"num_slots": [8, 16, 32, 48, 64, 96, 128],
              "block_size": [16, 32, 64], "spec_k": [0, 3]},
    "train": {"batch": [4, 8], "ce_chunk": [512, 2048],
              "int8_ring": [0, 1]},
}

#: a sweep on the CPU: the reference's tiny sizes and small grids
#: (>= 6 points across >= 2 knobs; a train sweep cut to 1 layer),
#: generation-heavy budgets over short prompts, far above capacity
_CPU_SWEEP = dict(config="tiny", layers=None, requests=48, rate=1000.0,
                  trials=3, max_len=80, seq=16, steps=8)
_CPU_GRIDS: Dict[str, Dict[str, List[int]]] = {
    "serve": {"num_slots": [4, 8, 12], "block_size": [4, 8]},
    "train": {"batch": [2, 4], "ce_chunk": [16, 64],
              "int8_ring": [0, 1]},
}
_CPU_WORKLOAD = dict(prompt_lens=(6, 10, 16), new_tokens=(16, 32))


def sweep_defaults(platform: str, domain: str) -> Dict[str, Any]:
    """A sweep's sizes, grid (``"grid"``) and serve workload
    (``"workload"``: ``loadgen.build_workload``'s keywords) on
    ``platform`` ("cuda": the card sweep; else the CPU's)."""
    if platform == "cuda":
        from .loadgen import CHAT_WORKLOAD
        return {**CARD_SWEEP, "grid": CARD_GRIDS[domain],
                "workload": dict(CHAT_WORKLOAD)}
    layers = 1 if domain == "train" else _CPU_SWEEP["layers"]
    return {**_CPU_SWEEP, "layers": layers, "grid": _CPU_GRIDS[domain],
            "workload": dict(_CPU_WORKLOAD)}


def _log(msg: str) -> None:
    print(f"# autotune: {msg}", file=sys.stderr)


def _parse_grid(specs: List[str]) -> Dict[str, List[int]]:
    """``--grid num_slots=4,8`` (repeatable) -> {"num_slots": [4, 8]}."""
    grid: Dict[str, List[int]] = {}
    for spec in specs:
        if "=" not in spec:
            raise ValueError(f"--grid: expected KNOB=V1,V2,..., got "
                             f"{spec!r}")
        name, _, vals = spec.partition("=")
        try:
            grid[name.strip()] = [int(v) for v in vals.split(",")
                                  if v.strip()]
        except ValueError:
            raise ValueError(f"--grid {spec!r}: values must be "
                             f"integers")
        if not grid[name.strip()]:
            raise ValueError(f"--grid {spec!r}: no values")
    return grid


def _ints(spec: str) -> Tuple[int, ...]:
    return tuple(int(t) for t in spec.split(",") if t.strip())


def _free(device) -> None:
    """Drop the previous point's graphs and tensors from the card."""
    gc.collect()
    if device.torch_device.type == "cuda":
        import torch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _tick_features(eng) -> Dict[str, float]:
    """A serve point's features: the tick program's (verify on a
    speculative engine, else decode) recorded FLOPs and bytes, and the
    graph pool bytes of the engine's captured programs."""
    from ..obs import cost as obs_cost

    feats = obs_cost.engine_features(eng)
    tick = feats.get("verify") or feats.get("decode") \
        or feats.get("decode_int8") or {}
    pool = sum(p.graph.pool_bytes for p in (eng._prefill, eng._decode,
                                            eng._verify)
               if p is not None and p.graph is not None)
    return {"tick_flops": float(tick.get("flops", 0.0)),
            "tick_bytes": float(tick.get("hbm_bytes", 0.0)),
            "graph_pool_bytes": float(pool)}


def serve_measure(model, *, requests: int, rate: float, seed: int,
                  max_len: int, deadline: float, trials: int = 3,
                  workload: Optional[Dict[str, Any]] = None
                  ) -> Callable[[Dict[str, Any]],
                                Tuple[float, Dict[str, Any]]]:
    """Measure one serve knob point: a fresh ServeEngine at the point's
    arena shape (bf16 weights on the card), warmed (its programs
    captured), then the SAME open-loop Poisson workload every point
    sees (``loadgen.build_workload`` with ``workload``'s keywords,
    default the CPU's); objective = median delivered tokens/s over
    ``trials`` runs.

    A rate far above capacity saturates the engine: an arrival-bound
    workload measures the Poisson clock, not the knobs."""
    import torch

    from ..serve import ServeEngine
    from ..serve.metrics import ServeMetrics
    from .loadgen import build_workload, run_load

    on_card = model.device.torch_device.type == "cuda"
    pdt = torch.bfloat16 if on_card else None

    def measure(knobs: Dict[str, Any]) -> Tuple[float, Dict[str, Any]]:
        spec = {}
        if int(knobs.get("spec_k", 0)):
            spec = {"draft_model": model, "spec_k": int(knobs["spec_k"])}
        eng = ServeEngine(model, int(knobs["num_slots"]), max_len,
                          block_size=int(knobs["block_size"]),
                          max_queue=2 * requests, param_dtype=pdt, **spec)
        try:
            warm = build_workload(1, 1.0, seed + 1,
                                  vocab=model.cfg.vocab_size)
            eng.submit(warm[0].prompt, max_new_tokens=2)
            eng.run_until_idle()
            results = []
            for _ in range(max(1, trials)):
                eng.metrics = ServeMetrics(flight=eng.flight)
                wl = build_workload(requests, rate, seed,
                                    vocab=model.cfg.vocab_size,
                                    **(workload or _CPU_WORKLOAD))
                payload = run_load(eng, wl, deadline_s=deadline)
                if payload["completed"] != requests:
                    raise RuntimeError(f"serve point {knobs}: "
                                       f"{payload['completed']} of "
                                       f"{requests} requests completed")
                results.append(float(payload["tokens_per_s"]))
            feats = _tick_features(eng)
        finally:
            eng.close()
            del eng
            _free(model.device)
        results.sort()
        return results[len(results) // 2], feats

    return measure


def train_model_key(config: str, layers: Optional[int],
                    world: int = 1) -> str:
    """The table key of the train sweep's model: the port's
    ``model_key`` of the configuration, with the data-parallel world
    (``llama-d2048-L2-dp1``)."""
    from ..autotune import table
    from ..models import Llama
    from .loadgen import _model_config
    return (f"{table.arch_key(Llama.__name__, _model_config(config, layers))}"
            f"-dp{world}")


def train_measure(device, *, config: str, layers: Optional[int],
                  seq: int, steps: int = 8, seed: int = 0,
                  launches: Optional[List[Dict[str, int]]] = None
                  ) -> Callable[[Dict[str, Any]],
                                Tuple[float, Dict[str, Any]]]:
    """Measure one train knob point: ``config`` cut to ``layers`` with
    the fused loss at the point's chunk, SGD(0.01, momentum 0.9) in
    ``DistOpt`` (``int8_ring`` or the plain sync) over the current
    process group, a (batch, ``seq``) batch of token ids; two eager
    steps and the capture, then ``steps`` timed replays (the device
    synchronised around them).  The caller holds the group and the
    data mesh.  ``launches``, when given, collects each point's
    hand-written kernel launches over its timed replays, as the kernels
    counted them on the card."""
    import numpy as np
    import torch

    from .. import opt
    from ..models import Llama
    from ..ops import flash_attention as fa
    from ..parallel import communicator
    from .loadgen import _model_config

    on_card = device.torch_device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def measure(knobs: Dict[str, Any]) -> Tuple[float, Dict[str, Any]]:
        cfg = dataclasses.replace(_model_config(config, layers),
                                  fused_loss=True,
                                  fused_loss_chunk=int(knobs["ce_chunk"]))
        gen = torch.Generator(device.torch_device.type).manual_seed(seed)
        m = Llama(cfg, device=device, generator=gen)
        ring = bool(int(knobs.get("int8_ring", 0)))
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.01, momentum=0.9),
                                    compression="int8_ring" if ring
                                    else None))
        rng = np.random.RandomState(seed)
        ids = torch.as_tensor(
            rng.randint(0, cfg.vocab_size, (int(knobs["batch"]), seq))
            .astype(np.int32), device=device.torch_device)
        try:
            m.compile([ids], is_train=True, use_graph=True)
            for _ in range(3):                # eager, eager, capture
                m.train_step(ids)
            sync()
            if on_card:
                fa.reset_device_launches()
            t0 = time.perf_counter()
            for _ in range(steps):
                m.train_step(ids)
            sync()
            dt_ms = (time.perf_counter() - t0) / steps * 1e3
            if launches is not None:
                launches.append(fa.device_launches() if on_card
                                else dict.fromkeys(fa.KERNELS, 0))
            g = m.get_graph("train")
            world = (torch.distributed.get_world_size()
                     if torch.distributed.is_initialized() else 1)
            n = m.num_params()
            wire = (communicator.int8_ring_wire_bytes(n, world) if ring
                    else communicator.f32_ring_wire_bytes(n, world))
            feats = {"flops": float(g.flops()),
                     "graph_pool_bytes": float(g.pool_bytes),
                     "wire_bytes": float(wire)}
        finally:
            del m, ids
            _free(device)
        return dt_ms, feats

    return measure


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class _group_of_one:
    """A process group of one (NCCL on the card, gloo on the CPU) and
    the data mesh over it, for the train sweep; torn down on exit (an
    existing group is left alone)."""

    def __init__(self, device):
        self.device = device
        self.owned = False

    def __enter__(self):
        import torch

        from .. import parallel
        if not torch.distributed.is_initialized():
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
            parallel.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                      device=self.device)
            self.owned = True
        parallel.set_mesh(parallel.data_parallel_mesh())
        return self

    def __exit__(self, *exc):
        from .. import parallel
        if self.owned:
            parallel.finalize_distributed()
        else:
            parallel.set_mesh(None)
        return False


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _store(args) -> str:
    return args.store or os.path.join(_REPO, STORE)


def cmd_sweep(args) -> int:
    import torch

    from ..autotune import knobs as at_knobs
    from ..autotune import sweep as at_sweep
    from ..autotune import table as at_table
    from ..device import create_device
    from ..obs import record as obs_record
    from .loadgen import tier_model

    grid = _parse_grid(args.grid) if args.grid else None
    store = _store(args)
    device = create_device(args.device)
    platform, kind = obs_record.device_kind(device.torch_device)
    d = sweep_defaults(platform, args.domain)
    for k in ("config", "layers", "requests", "rate", "trials", "max_len",
              "seq", "steps"):
        if getattr(args, k) is None:
            setattr(args, k, d[k])
    grid = grid or dict(d["grid"])
    workload = d["workload"]
    if args.prompt_lens:
        workload["prompt_lens"] = _ints(args.prompt_lens)
    if args.new_tokens:
        workload["new_tokens"] = _ints(args.new_tokens)
    points = at_knobs.grid_points(args.domain, grid)
    if args.domain == "train":
        measure = train_measure(device, config=args.config,
                                layers=args.layers, seq=args.seq,
                                steps=args.steps, seed=args.seed)
        with _group_of_one(device):
            model_key = train_model_key(args.config, args.layers,
                                        torch.distributed.get_world_size())
            sid = _run(args, at_sweep, points, model_key, measure, store,
                       platform, kind, grid)
    else:
        model = tier_model(device, args.config, args.layers, args.seed)
        model_key = at_table.model_key(model)
        measure = serve_measure(
            model, requests=args.requests, rate=args.rate, seed=args.seed,
            max_len=args.max_len, deadline=args.deadline,
            trials=args.trials, workload=workload)
        sid = _run(args, at_sweep, points, model_key, measure, store,
                   platform, kind, grid)
    print(sid)
    return 0


def _run(args, at_sweep, points, model_key, measure, store, platform,
         kind, grid) -> str:
    _log(f"{args.domain} sweep over {len(points)} points "
         f"({', '.join(f'{k}={v}' for k, v in sorted(grid.items()))}) "
         f"model={model_key} platform={platform}")
    sweep_id, entries = at_sweep.run_sweep(
        args.domain, model_key, points, measure, store,
        platform=platform, device=kind, smoke=platform != "cuda",
        log=_log)
    _log(f"{len(entries)} autotune_sweep entries (sweep {sweep_id}) "
         f"appended to {store}")
    return sweep_id


def cmd_fit(args) -> int:
    from ..autotune import predictor as at_predictor
    from ..autotune import sweep as at_sweep
    from ..autotune import table as at_table
    from ..obs import record as obs_record

    store = _store(args)
    sweep_id, pts, old_fit = at_sweep.sweep_points_from_store(
        store, args.domain, model=args.model, platform=args.platform,
        sweep_id=args.sweep)
    model_key = pts[0]["model"]
    pred, report = at_predictor.fit_points(args.domain, pts)
    best = at_predictor.best_point(args.domain, pts)
    _log(f"fit {args.domain}/{model_key}/{args.platform}: "
         f"{report['n']} points, loo_rel_err mean="
         f"{report['loo_rel_err']:.4f} max="
         f"{report['loo_rel_err_max']:.4f}")
    _log(f"measured argbest: {best['knobs']} -> "
         f"{best['objective_name']}={best['objective']:.3f} "
         f"(run {best['run_id']})")

    knobs = dict(best["knobs"])
    spec_evidence = None
    if args.domain == "serve" and "spec_k" not in knobs:
        # spec_k from the load driver's --spec-compare pair records
        entries = obs_record.RunRecord(store).entries()
        picked = at_table.pick_spec_k(entries, args.platform,
                                      model=model_key)
        if picked is not None:
            knobs["spec_k"] = picked["spec_k"]
            spec_evidence = picked
            _log(f"spec_k={picked['spec_k']} from pair "
                 f"{picked['pair_id']} (accept_rate="
                 f"{picked['accept_rate']}, tokens/dispatch="
                 f"{picked['tokens_per_dispatch']})")
        else:
            knobs["spec_k"] = 0
            _log("no spec pair in the store shows a tokens/s win; "
                 "spec_k=0")

    if old_fit is None or args.refit:
        at_sweep.append_fit(
            store, domain=args.domain, model=model_key,
            platform=args.platform,
            device=pts[0].get("device", args.platform),
            sweep_id=sweep_id, best=best, report=report,
            smoke=args.platform != "cuda", spec_evidence=spec_evidence)
        _log(f"fit record appended to {store}")
    else:
        _log(f"sweep {sweep_id} already has a fit record "
             f"(--refit to supersede the fit values)")

    doc = {
        "knobs": knobs,
        "objective_name": best["objective_name"],
        "objective": best["objective"],
        "sweep_id": sweep_id,
        "run_id": best["run_id"],
        "loo_rel_err": report["loo_rel_err"],
    }
    if args.card:
        doc["card"] = args.card
    if spec_evidence is not None:
        doc["spec_evidence"] = {
            "pair_id": spec_evidence["pair_id"],
            "run_id": spec_evidence["run_id"],
            "accept_rate": spec_evidence["accept_rate"],
            "tokens_per_dispatch":
                spec_evidence["tokens_per_dispatch"],
        }
    key = at_table.config_key(args.domain, model_key, args.platform)
    print(json.dumps({key: doc}, indent=2, sort_keys=True))
    if args.update_best:
        path = at_table.update_table(key, doc, args.table)
        _log(f"best-config table updated: {path} [{key}]")
    else:
        _log("dry run (pass --update-best to rewrite the table)")
    return 0


def cmd_best(args) -> int:
    from ..autotune import table as at_table

    knobs = at_table.resolve(args.domain, args.model, args.platform,
                             {}, path=args.table)
    print(json.dumps({at_table.config_key(args.domain, args.model,
                                          args.platform): knobs},
                     indent=2, sort_keys=True))
    return 0


def check_errors(store: str, table: Optional[str] = None) -> List[str]:
    """The autotune layer's record hygiene: the store validates, every
    ``autotune_sweep`` entry's knob NAMES are registered, and the
    best-config table (when one exists) validates against the schema
    version and cites only run_ids that exist in the store."""
    from ..autotune import knobs as at_knobs
    from ..autotune import table as at_table
    from ..obs import record as obs_record
    from ..obs import schema

    errors: List[str] = []
    run_ids: Optional[set] = None
    if os.path.exists(store):
        rec = obs_record.RunRecord(store)
        errors.extend(rec.validate())
        try:
            entries = rec.entries()
        except schema.SchemaError:
            entries = []
        else:
            run_ids = {e["run_id"] for e in entries}
        for e in entries:
            if e["kind"] != "autotune_sweep":
                continue
            p = e["payload"]
            errors.extend(at_knobs.validate_knobs(
                p.get("domain"), p.get("knobs"),
                ctx=f"{store}: {e['run_id']}"))
    path = at_table.table_path(table)
    if os.path.exists(path):
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            errors.append(f"{path}: {e}")
        else:
            errors.extend(at_table.validate_table(
                doc, ctx=path, store_run_ids=run_ids))
    return errors


def cmd_check(args) -> int:
    """Validate the table and the sweep records of a store."""
    from ..autotune import table as at_table

    store = _store(args)
    errors = check_errors(store, args.table)
    if not os.path.exists(at_table.table_path(args.table)):
        _log(f"note: no best-config table at "
             f"{at_table.table_path(args.table)} (consumers fall back "
             f"to built-in defaults)")
    for e in errors:
        print(f"autotune check: {e}", file=sys.stderr)
    if errors:
        print(f"autotune check: {len(errors)} error(s)", file=sys.stderr)
        return 1
    print(f"autotune check: table + sweep records valid ({store})")
    return 0


def cmd_smoke(args) -> int:
    """(a) the committed table and the port's store validate; (b) a real
    tiny 2-point serve sweep -> fit -> table write -> resolve round
    trip in a temporary store proves the loop end to end without
    touching committed state."""
    from ..autotune import knobs as at_knobs
    from ..autotune import predictor as at_predictor
    from ..autotune import sweep as at_sweep
    from ..autotune import table as at_table
    from ..device import create_device
    from ..obs import record as obs_record
    from .loadgen import tier_model

    rc = cmd_check(argparse.Namespace(store=None, table=None))
    if rc != 0:
        return rc
    device = create_device(args.device)
    platform, kind = obs_record.device_kind(device.torch_device)
    with tempfile.TemporaryDirectory(prefix="autotune-smoke-") as tmp:
        store = os.path.join(tmp, "records.jsonl")
        table = os.path.join(tmp, "best.json")
        model = tier_model(device, "tiny")
        model_key = at_table.model_key(model)
        points = at_knobs.grid_points("serve", {"num_slots": [2, 4]})
        for p in points:
            p["block_size"] = 8
        measure = serve_measure(model, requests=6, rate=50.0, seed=0,
                                max_len=64, deadline=30.0)
        sweep_id, _ = at_sweep.run_sweep(
            "serve", model_key, points, measure, store,
            platform=platform, device=kind, smoke=True, log=_log)
        _, pts, _ = at_sweep.sweep_points_from_store(store, "serve")
        _, report = at_predictor.fit_points("serve", pts)
        best = at_predictor.best_point("serve", pts)
        at_sweep.append_fit(store, domain="serve", model=model_key,
                            platform=platform, device=kind,
                            sweep_id=sweep_id, best=best,
                            report=report, smoke=True)
        key = at_table.config_key("serve", model_key, platform)
        at_table.update_table(key, {
            "knobs": dict(best["knobs"]),
            "objective_name": best["objective_name"],
            "objective": best["objective"], "sweep_id": sweep_id,
            "run_id": best["run_id"],
            "loo_rel_err": report["loo_rel_err"]}, table)
        resolved = at_table.resolve("serve", model_key, platform, {},
                                    path=table)
        if resolved["num_slots"] != best["knobs"]["num_slots"]:
            print(f"autotune smoke: FAIL — round-trip resolve "
                  f"{resolved} != committed best {best['knobs']}",
                  file=sys.stderr)
            return 1
        errors = obs_record.RunRecord(store).validate()
        errors += check_errors(store, table)
        if errors:
            for e in errors:
                print(f"autotune smoke: {e}", file=sys.stderr)
            return 1
        forced = at_table.resolve("serve", model_key, platform,
                                  {"num_slots": 3}, path=table)
        if forced["num_slots"] != 3:
            print("autotune smoke: FAIL — explicit knob did not win "
                  "over the table", file=sys.stderr)
            return 1
    print(f"autotune smoke: OK — 2-point sweep -> fit (loo_rel_err="
          f"{report['loo_rel_err']:.3f}) -> table round-trip; "
          f"committed table + records valid")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m singa_tpu_torch.tools.autotune",
        description="record-driven autotuner: sweep knobs, fit the "
                    "predictor, commit the port's best-config table")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument("--device", default="auto",
                       help="'auto' (the card; raises without one), "
                            "'cuda' or 'cpu'")

    p_sweep = sub.add_parser(
        "sweep", help="measure a knob grid; one autotune_sweep record "
                      "per point under a shared sweep_id")
    p_sweep.add_argument("--domain", choices=("serve", "train"),
                         required=True)
    p_sweep.add_argument("--config", default=None,
                         help="the swept configuration (loadgen's "
                              "--config names)")
    p_sweep.add_argument("--layers", type=int, default=None,
                         help="cut the configuration to this many "
                              "layers")
    device_arg(p_sweep)
    p_sweep.add_argument("--grid", action="append", metavar="K=V1,V2",
                         default=None,
                         help="knob values (repeatable; default: the "
                              "device's grid for the domain)")
    p_sweep.add_argument("--store", default=None)
    p_sweep.add_argument("--requests", type=int, default=None)
    p_sweep.add_argument("--rate", type=float, default=None,
                         help="offered arrivals/s — far above capacity "
                              "by default, so the engine is what is "
                              "ranked, not the Poisson clock")
    p_sweep.add_argument("--trials", type=int, default=None,
                         help="workload runs per point; the median "
                              "tokens/s is recorded")
    p_sweep.add_argument("--seed", type=int, default=0)
    p_sweep.add_argument("--max-len", type=int, default=None)
    p_sweep.add_argument("--prompt-lens", default=None)
    p_sweep.add_argument("--new-tokens", default=None)
    p_sweep.add_argument("--deadline", type=float, default=300.0)
    p_sweep.add_argument("--steps", type=int, default=None,
                         help="train sweep: timed steps per point")
    p_sweep.add_argument("--seq", type=int, default=None,
                         help="train sweep: tokens per row")
    p_sweep.epilog = ("Defaults follow the device: on the card the card "
                      "sweep (CARD_SWEEP, CARD_GRIDS), on the CPU the "
                      "reference's tiny sizes.")
    p_sweep.set_defaults(fn=cmd_sweep)

    p_fit = sub.add_parser(
        "fit", help="fit the predictor on a sweep, append the fit "
                    "record, optionally rewrite the table")
    p_fit.add_argument("--domain", choices=("serve", "train"),
                       required=True)
    p_fit.add_argument("--model", default=None,
                       help="model KEY (e.g. llama-d2048-L2); default: "
                            "the newest sweep's")
    p_fit.add_argument("--platform", default="cuda")
    p_fit.add_argument("--sweep", default=None, metavar="SWEEP_ID",
                       help="which sweep group (default: newest)")
    p_fit.add_argument("--store", default=None)
    p_fit.add_argument("--table", default=None)
    p_fit.add_argument("--card", default=None,
                       help="the card's name and power limit, recorded "
                            "beside the objective (nvidia-smi "
                            "--query-gpu=name,power.limit)")
    p_fit.add_argument("--refit", action="store_true",
                       help="supersede an existing fit record")
    p_fit.add_argument("--update-best", action="store_true",
                       help="rewrite the best-config table (review the "
                            "diff)")
    p_fit.set_defaults(fn=cmd_fit)

    p_best = sub.add_parser(
        "best", help="print the resolved knobs a consumer would use")
    p_best.add_argument("--domain", choices=("serve", "train"),
                        required=True)
    p_best.add_argument("--model", required=True,
                        help="model KEY (e.g. llama-d2048-L2)")
    p_best.add_argument("--platform", default="cuda")
    p_best.add_argument("--table", default=None)
    p_best.set_defaults(fn=cmd_best)

    p_check = sub.add_parser(
        "check", help="validate the best-config table and the store's "
                      "autotune_sweep records")
    p_check.add_argument("--store", default=None)
    p_check.add_argument("--table", default=None)
    p_check.set_defaults(fn=cmd_check)

    p_smoke = sub.add_parser(
        "smoke", help="the table check + a real 2-point sweep -> fit -> "
                      "table round-trip in a temporary store")
    device_arg(p_smoke)
    p_smoke.set_defaults(fn=cmd_smoke)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError, LookupError) as e:
        print(f"autotune: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
