"""The training driver: one model, one optimizer, one captured step,
built from the seed, driven through its first steps in set-up, then
replayed on distinct rows for the window.

Set-up builds the program's ``models.Llama`` from the configuration,
loads the benchmark's seeded weights, arms ``set_optimizer`` /
``compile`` and makes the step's first three calls (eager, eager on a
side stream, capture) on three distinct batches: the steps the reference
follows; the third is the captured graph's first replay, on inputs
copied into its static buffers as in every window step.  It reads their
losses, each leaf's gradient norm in each of the three steps from the
optimizer's state after it (``slot_arrays()``, the checkpoint's layout)
and each leaf's change after step 3.  The window then calls
``train_step`` on the following batches, one whole step at a time,
until its time is up.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from harness import flops, judge, trace
from harness.program import llama_config, program_device
from harness.weights import Weights, token_ids
from reference import model as ref_model


def make_optimizer(mix: dict):
    from singa_tpu_torch import opt
    name = mix["optimizer"]
    if name != "adafactor_relative":
        raise ValueError(f"unknown optimizer {name!r}")
    return opt.Adafactor()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def second_moments(model) -> dict:
    """Each leaf's Σ(g² + ε₁) as Adafactor's state holds it, over all
    the leaf's entries: the state of a parameter p is [v] (v of p's
    shape) or [vc, vr] (the means over p's last two axes), and either
    sums, scaled by numel(p) / numel, to the decayed Σ(g² + ε₁).  Any
    other layout raises: the reading would be wrong."""
    out = {}
    params = model.get_params()
    for name, leaves in model.optimizer.slot_arrays().items():
        p = params[name]
        shapes = [tuple(t.shape) for t in leaves]
        if shapes not in ([tuple(p.shape)],
                          [tuple(p.shape[:-2] + p.shape[-1:]),
                           tuple(p.shape[:-1])]):
            raise RuntimeError(
                f"Adafactor's state of {name!r} is {shapes}, not [v] or "
                f"[vc, vr] of {tuple(p.shape)}: the gradient norms cannot "
                f"be read from it")
        s = leaves[-1].double()
        out[name] = float(s.sum()) * p.numel() / s.numel()
    return out


def grad_norms_by_step(sums: list, model) -> list:
    """Each step's gradient norms from the second moments after steps
    1, 2, ... (`second_moments`): with decay d_t = 1 − t^−0.8 (0 at step
    1), S_t = d_t · S_{t−1} + (1 − d_t) · Σ(g_t² + ε₁)."""
    opt = model.optimizer
    n = {k: p.numel() for k, p in model.get_params().items()}
    out, prev = [], None
    for t, s in enumerate(sums, start=1):
        d = 1.0 - t ** (-opt.decay_rate)
        out.append({k: math.sqrt(max(
            (v - d * (prev[k] if prev else 0.0)) / (1.0 - d)
            - opt.eps1 * n[k], 0.0)) for k, v in s.items()})
        prev = s
    return out


def batches(cell, seed: int, n: int, dev) -> list:
    mix = cell.mix
    shape = (mix["batch"], mix["seq_len"])
    return [token_ids(seed, s, shape, cell.config["vocab_size"], dev)
            for s in range(n)]


def build(cell, seed: int, dev):
    """The model with the seeded weights, its optimizer armed and the
    step compiled for the first batch."""
    from singa_tpu_torch.models import Llama
    m = Llama(llama_config(cell.config, cell.mix), device=program_device(dev))
    Weights(cell.config, seed, dev).load_into(m.get_params())
    m.set_optimizer(make_optimizer(cell.mix))
    return m


def first_steps(m, feed, dev) -> dict:
    """The three calls the reference follows: losses, and each step's
    gradient norms read from the optimizer's state after it."""
    losses, sums = [], []
    for s in range(3):
        with trace.span("train_step"):
            _, loss = m.train_step(feed[s])
        losses.append(float(loss))
        sums.append(second_moments(m))
    return {"losses": losses, "grad_norms": grad_norms_by_step(sums, m)}


def change_norms(m, weights: Weights) -> dict:
    with torch.no_grad():
        return {n: float(torch.linalg.vector_norm(p - weights.leaf(n)))
                for n, p in m.get_params().items()}


def window(m, feed, start: int, seconds: float, dev, traced: bool,
           trace_s: float, rec: dict) -> dict:
    """Whole steps on feed[start:] (cycled) until `seconds` have passed:
    the steps that ended inside the window and the time to the end of
    the last of them."""
    tracer = trace.Tracer() if traced else None
    sync(dev)
    t0 = time.perf_counter()
    if tracer:
        tracer.start()
        t0 = time.perf_counter()
    ends, i, cut = [], start, None
    while True:
        with trace.span("train_step"):
            m.train_step(feed[i % len(feed)])
        sync(dev)
        t = time.perf_counter() - t0
        if tracer and t >= trace_s and cut is None:
            tracer.stop()
            cut = (len(ends) + 1, time.perf_counter() - t0)
        if t > seconds:
            break
        ends.append(t)
        i += 1
    if tracer and cut is None:
        tracer.stop()
    if tracer:
        rec["trace"] = tracer.read()
        # the steps after the profiler stopped: the step's own pace
        after = [e for e in ends[cut[0]:]] if cut else []
        rec["untraced"] = (len(after), after[-1] - cut[1]) if after \
            else None
    return {"steps": len(ends), "seconds": ends[-1] if ends else math.nan}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers `correct` may be decided on (the cell's limits file
    names those it is): the widest relative gap of the three losses;
    the gradient's norms by the worst leaf in step 1 and in step 3 (the
    graph's first replay); the change's norms by the worst leaf."""
    losses = [judge.rel_gap(a, b, 1e-6)
              for a, b in zip(prog["losses"], ref["losses"])]
    moved = judge.moved_leaves(ref["grad_norms"][0])
    by_step = [judge.worst_leaf_gap(g, r, r)
               for g, r in zip(prog["grad_norms"], ref["grad_norms"])]
    c_gap, c_at = judge.worst_leaf_gap(prog["change_norms"],
                                       ref["change_norms"], moved)
    return {"numbers": {
                "loss_gap": max(losses),
                "grad_norm_gap": by_step[0][0],
                "replay_grad_norm_gap": by_step[-1][0],
                "change_norm_gap": c_gap},
            "grad_norm_gap_by_step": [g for g, _ in by_step],
            "worst_leaf": {"grad_norm_gap": [at for _, at in by_step],
                           "change_norm_gap": c_at},
            "left_out": sorted(set(ref["grad_norms"][0]) - set(moved))}


def reference(cell, seed: int, feed, dev, fp8: bool = False) -> dict:
    ref_model.set_exact()
    a = cell.config.get("assumed", {})
    return ref_model.follow_steps(
        cell.config, Weights(cell.config, seed, dev), feed[:3],
        a.get("moe_aux_weight", 0.0) if cell.config.get(
            "num_local_experts") else 0.0, fp8=fp8)


def run(cell, seed: int, seconds: float, traced: bool, dev,
        readers: dict, t_start: float) -> dict:
    mix = cell.mix
    dev = torch.device(dev)
    feed = batches(cell, seed, mix["distinct_batches"], dev)
    m = build(cell, seed, dev)
    probes = {}
    if traced:
        # the layers timed alone, before the step's graph holds the card
        pre = {"kind": "train", "cell": cell, "model": m, "device": dev}
        probes = {n: mod.probe(pre) for n, mod in readers.items()
                  if hasattr(mod, "probe")}
        del pre
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    m.compile([feed[0]], is_train=True, use_graph=True)
    prog = first_steps(m, feed, dev)
    prog["change_norms"] = change_norms(m, Weights(cell.config, seed, dev))
    for s in range(3, 3 + mix["warm_steps"]):
        m.train_step(feed[s])
    sync(dev)
    setup_s = time.perf_counter() - t_start
    rec = {"kind": "train", "cell": cell, "device": dev, "probes": probes}
    w = window(m, feed, 3 + mix["warm_steps"], seconds, dev, traced,
               mix.get("trace_seconds", seconds), rec)
    B, T = mix["batch"], mix["seq_len"]
    samples = w["steps"] * B
    rate = samples / w["seconds"] if w["steps"] else 0.0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rec.update({"steps": w["steps"], "window_s": w["seconds"],
                "flops_per_step": flops.train_flops_per_token(
                    cell.config, T) * B * T})
    per_layer = {}
    if traced:
        for name, mod in readers.items():
            v = mod.read(rec)
            if v is not None:
                per_layer[name] = v
    traced_rec = rec.get("trace")
    rec.clear()
    del m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(cell, seed, feed, dev)
    cmp = compare(prog, ref)
    return {"attempted": w["steps"], "failed": 0,
            "end_to_end": {"train_samples_per_s": rate, "setup_s": setup_s},
            "per_layer": per_layer, "memory_peak_bytes": peak,
            "numbers": cmp["numbers"],
            "detail": {"losses": prog["losses"], "ref_losses": ref["losses"],
                       "grad_norm_gap_by_step": cmp["grad_norm_gap_by_step"],
                       "worst_leaf": cmp["worst_leaf"],
                       "left_out": cmp["left_out"],
                       "steps": w["steps"], "window_s": w["seconds"]},
            "trace": traced_rec}
