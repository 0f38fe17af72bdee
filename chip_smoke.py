#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (singa_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:
  1. card    — name and power limit (nvidia-smi), torch's device name/count
  2. build   — compile every kernel of the serving and training paths from
               singa_tpu_torch/csrc (nvcc, sm_90a), and each planted fault
               from a copy of its source in a temporary directory, all in
               parallel; show ptxas's register / shared-memory report
               and any note that it serialised wgmma instructions
  3. kernels — each kernel against its plain PyTorch version on the card,
               over the cases and limits of singa_tpu_torch/kernel_check.py
               (the backward also with a nonzero lse cotangent), and two
               launches of the backward kernels bitwise equal
  4. faults  — each planted fault must fail those limits on its case
  5. slice   — Llama(LlamaConfig.base()).generate() at B=4, P=1024, N=32,
               bf16 weights, captured (a CUDA graph of the prefill and
               one of the decode step, replayed N - 1 times): the flash
               forward must run once per layer per call, as the kernel
               counts its launches on the card, and the tokens must
               equal an eager call's bitwise; prefill logits with the
               kernel vs with its plain version; prefill ms, decode
               ms/token, tokens/s, peak memory, captured beside eager;
               the card's memory as sessions of other prompt lengths
               are added; then a profile of one captured call
  6. serve   — the paged ServeEngine (singa_tpu_torch.serve) over
               Llama(LlamaConfig.base()) with bf16 weights, 8 slots,
               max_len 1024, blocks of 32: its prefill-chunk and decode
               programs captured as CUDA graphs.  16 requests (8 sharing
               a 256-token system prompt), 64 new tokens each, submitted
               at once, then a burst past max_queue (QueueFull); then the
               first wave of 8 again, plain, through a recovery forced by
               decode faults past the retries (and a retried prefill
               fault), and without prefix sharing.  Checks:
               compiled_counts() == (1, 1) after the traffic and after
               the recovery; each rerun's streams bitwise equal to the
               first wave's, as are those of an engine whose block pool
               is cut so that growth preempts; a teacher-forced oracle
               (each request's prompt and tokens through one plain
               causal forward: every engine token's logit within a limit
               of that position's largest), which a planted fault must
               fail: in bf16 one writing decode k/v into the null block,
               in f32 (4 requests, base() cut to 4 layers) one writing
               it one offset late; no
               flash launch on the card, counted from the main engine's
               warm-up to its last rerun, and over the other engines.
               TTFT, prefill chunk and decode tick times, tokens/s,
               prefix hits, memory, one profiled decode tick, and four
               of the prompts through sequential captured generate()
               calls
  7. spec    — speculative decoding on the serve engine (spec_k=3), over
               the serve phase's first wave: self-speculation
               (draft_model = the target), a disagreeing draft
               (base() cut to 2 layers, seed 1), a serve.verify fault
               past the retries (one plain-decode fallback tick) and a
               recovery mid-wave; each run's streams held bitwise to
               the plain engine's.  spec_compiled_counts() is
               (1, 0, 1, 0), (1, 1, 1, 0) after the fallback.  Accept
               rate, tokens per dispatch, verify round ms, tokens/s and
               TTFT beside the plain engine's; no flash launch
  8. mem     — the int8 arena and the bf16 one at the serve arena's
               bytes over 24 slots (the 16 prompts and 8 again, no
               prefix sharing, 16 new tokens each): peak concurrency,
               tokens/s, TTFT, tick; the referee (an int8 draft arena
               under the bf16 target) whose accept rate must reach a
               limit that a planted scatter dropping the scales must
               not; quantize_kv on the card equal to the CPU's; the
               spill tier on a 96-block pool (4 system-prompt requests,
               the 8 private prompts, 4 more system-prompt requests):
               the system prompt's blocks spilled and restored by one
               restore program, the third wave's streams equal to an
               engine without the tier's, which a planted restore into
               the next block must break; no flash launch
  9. beam    — generate_beam on two of the slice phase's prompts (P=1024,
               N=32, 4 beams, bf16 weights), without and with an eos id:
               the captured session (prefill graph, one beam tick
               replayed N times) against the eager search bitwise, 16
               flash launches per call counted on the card, num_beams=1
               against greedy generate(), the scores against a
               teacher-forced f32 forward; call and tick ms, pool bytes
 10. train   — LlamaConfig.base() (fused loss) with SGD(lr=0.01,
               momentum=0.9): set_optimizer, compile, train_step at B=8 x
               T=1024.  One step's loss and gradients with the kernels vs
               with their plain versions, and with planted faults in
               place of the kernels, eagerly; then through a captured
               step (lr 0), sound and with one backward fault, each
               captured afresh.  From the same initial weights, 4 steps
               eager and 4 captured on four batches, losses held to each
               other; eager steps timed and one profiled; then 10 timed
               replays on a fixed batch: the forward, dQ and dK/dV
               kernels must each run once per layer per step, as they
               count their launches on the card; losses
               finite and falling; step ms, tokens/s, MFU, peak memory,
               capture seconds and the graph's ops and pool bytes; then
               a profile of one replay
 11. checkpoint — LlamaConfig.base() cut to 2 layers: 6 captured steps
               with a save after step 2; a fresh model loads it and runs
               steps 3-6 (eager, warm-up, capture, replay), whose losses
               must equal the uninterrupted run's within the train limit
 12. timing  — each kernel, its plain version and the PyTorch call that
               computes the same function (scaled_dot_product_attention
               and its gradient: yardsticks the port never calls) at the
               training shape, beside the card's bound, each kernel also
               held against its plain version on the timed inputs; the
               forward also at the prefill shape.  The kernels' calls are
               timed as CUDA-graph replays (device time: one call can take
               less time on the card than its wrapper takes on the host),
               with back-to-back event timing and the wrapper's host time
               per call reported beside
Then a line with the script's seconds, one {"kernels": [...]} line and,
last, the device line.  Every launch count of the main paths is read
from the counters the kernels advance on the card
(flash_attention.device_launches), so replays of CUDA graphs are counted
as they run.

Weights and inputs are random, drawn from fixed seeds.  The script needs
the repository beside it and a CUDA card; without either it fails.  It
writes one checkpoint under build/ and removes it.
"""

import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
import time
import warnings
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

# NVIDIA H100 SXM data-sheet peaks (dense): the bound a kernel is held to
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# last-position prefill logits, kernel vs plain version, relative to the
# largest logit: sixteen bf16 layers, each rounding at 2^-8, amplify a
# one-ulp difference in attention output to a few percent at most
LOGIT_RTOL = 5e-2

B, P, N = 4, 1024, 32
# the prompt lengths of the sessions added to show the card's memory
SESSION_PROMPTS = (256, 512, 768)

# training: B=8 x T=1024 token ids, 2 warm-up steps then 10 timed ones
TB, TT = 8, 1024
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# the parameters whose gradients are held kernel vs plain
GRAD_NAMES = ("tok_emb.table", "blocks.0.attn.q_proj.W",
              "blocks.15.attn.k_proj.W", "lm_head.W")
# one step's loss and those gradients with the kernels vs with their
# plain versions, relative (gradients by Frobenius norm).  Readings
# (PERF.md): loss 3.6e-6, gradients 0.93e-2 to 1.97e-2 -- bf16 roundings
# that fall the other way in 16 layers of activations, as LOGIT_RTOL.
# With a planted fault in place of a kernel: loss 1.35e-4 (forward
# faults only; the backward does not move the loss), the largest
# gradient 0.168 at the weakest fault
TRAIN_LOSS_RTOL = 2e-5
TRAIN_GRAD_RTOL = 5e-2
# planted faults (kernel_check) run through the same step, each of which
# must fail the limits above (the window fault is left out: base() has
# no window)
TRAIN_FAULTS = ("pv_swapped_v_rows", "pv_drops_late_keys",
                "ring_reads_next_stage", "dq_drops_delta",
                "dkv_skips_last_head", "dkv_causal_strict",
                "dq_ring_reads_next_stage", "dkv_reads_next_stage_rows")
# the fault also run through a captured step (the weakest backward
# fault through the eager step: PERF.md)
CAPTURED_FAULT = "dkv_causal_strict"
# steps from the same initial weights, eager and captured, held to each
# other by TRAIN_LOSS_RTOL; eager steps timed after them
COMPARE_STEPS, EAGER_TIMED = 4, 5
# the checkpoint phase: depth cut so the file stays under 2 GB
CKPT_LAYERS, CKPT_SAVE_AFTER, CKPT_STEPS = 2, 2, 6

# the serve phase: ServeEngine(num_slots, max_len, block_size) over
# LlamaConfig.base() with bf16 weights; 16 requests, half of them behind
# one system prompt, max_new_tokens each
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_BLOCK = 8, 1024, 32
SERVE_REQUESTS, SERVE_SYSTEM, SERVE_NEW = 16, 256, 64
# the block pool of the preemption run: enough for the largest request,
# too few for the first wave of eight to grow (with these prompts, 88 to
# 94 blocks preempt one request)
SERVE_PREEMPT_BLOCKS = 92
# teacher-forced oracle: at every generated position the engine's token
# logit must be within SERVE_DELTA of the plain forward's largest logit.
# Held on an engine computing in f32 over SERVE_ORACLE requests: with
# random weights the logits lie close together, and in bf16 a sound
# engine's gaps and those of the planted scatter fault overlap
# (PERF.md, section 6).  The bf16 engine's gaps are held to
# SERVE_BF16_GAP, four bf16 steps of its logits: a sound engine reads
# 0.0156, one writing every decode token's k/v into the null block 0.242
SERVE_ORACLE = 4
SERVE_DELTA = 1e-3
# the f32 oracle's engine runs base() cut to this depth, at full width:
# it reads the engine's scatter and gather, which depth does not change,
# and the whole script stays near its time budget
SERVE_ORACLE_LAYERS = 4
SERVE_BF16_GAP = 0.0625

# the spec phase: a verify window of SPEC_K proposals; the disagreeing
# draft is LlamaConfig.base() cut to SPEC_DRAFT_LAYERS layers, seed 1
SPEC_K, SPEC_DRAFT_LAYERS = 3, 2
# the mem phase: the int8 and bf16 arenas at the serve arena's bytes
# serve the 16 prompts and 8 of them again over INT8_SLOTS slots without
# prefix sharing, so demand (~410 blocks) exceeds the bf16 arena's
# capacity (256 blocks) and not the int8 one's (511): with sharing the
# bf16 arena held all 16 requests at once, as the int8 one did
# (PERF.md, section 4).  These runs and the spill waves take MEM_NEW new
# tokens a request (they read admission and prefill: concurrency, TTFT,
# restores)
INT8_SLOTS, MEM_NEW = 24, 16
# the referee (an int8 draft arena under the bf16 target, self-
# speculation): a sound arena's accept rate must reach this, the planted
# scatter that drops the scales must not.  Readings on an H100 (PERF.md,
# section 5): sound 0.926, scales dropped 0.528
REFEREE_MIN_ACCEPT = 0.75
# the spill run: a pool too small to keep the system prompt's blocks
# while the 8 private prompts run, and the host store's capacity
SPILL_POOL, SPILL_STORE = 96, 256
# the beam phase: two of the slice phase's prompts, four beams, and the
# returned scores against a teacher-forced f32 forward, relative: the
# search runs bf16 weights and activations, each of 32 log-softmax
# terms off by bf16 roundings of the logits
BEAM_B, BEAM_K, BEAM_N = 2, 4, 32
BEAM_SCORE_RTOL = 1e-2


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_time_ms(fn, iters=50, warmup=5):
    """Mean time of fn() over `iters` back-to-back calls, by CUDA events:
    the device's time when the host enqueues faster than the card runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, reps=20, replays=10):
    """Device time of one fn() call: `reps` calls captured in one CUDA
    graph, replayed `replays` times between CUDA events, so the host's
    time per call is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def host_time_us(fn, iters=200):
    """Host time of one fn() call (enqueue only), microseconds."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": line, "torch_name": name,
          "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name


def phase_build(tmp):
    """Build the kernels and, from copies of their sources in `tmp`, each
    planted fault: one nvcc per source, all started together."""
    from singa_tpu_torch import _build, kernel_check
    kernels = ("flash_fwd", "flash_bwd")
    faults = [(n, kernel_check.flash_fault_source(n))
              for n in kernel_check.FLASH_FAULTS]
    faults += [(n, kernel_check.flash_bwd_fault_source(n))
               for n in kernel_check.FLASH_BWD_FAULTS]
    srcs = [_build.source_path(k) for k in kernels]
    for name, text in faults:
        srcs.append(tmp / f"{name}.cu")
        srcs[-1].write_text(text)
    t0 = time.perf_counter()
    built = _build.build(srcs)
    for kernel, b in zip(kernels, built):
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln or "C75" in ln
                 or "Compiling entry function" in ln]
        # C7510-C7520 notes that ptxas serialised wgmma instructions
        serialised = [ln for ln in ptxas if "serialized" in ln]
        emit({"phase": "build", "kernel": kernel,
              "source": f"singa_tpu_torch/csrc/{kernel}.cu",
              "ptxas": ptxas, "wgmma_serialised": serialised})
    emit({"phase": "build", "nvcc_seconds": {b.path.name: round(b.seconds, 2)
                                             for b in built},
          "wall_seconds": round(time.perf_counter() - t0, 2)})
    return {name: b.lib for (name, _), b in zip(faults, built[2:])}


# the case that also carries a nonzero lse cotangent (folded into delta)
DLSE_CASE = "gqa_causal_d128"


def phase_kernels():
    from singa_tpu_torch import kernel_check
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for label in kernel_check.FLASH_CASES:
            errs = kernel_check.check_flash(label, dtype)
            results.append({"kernel": "flash_fwd", "case": label,
                            "dtype": str(dtype)[6:], **errs})
    for dtype in (torch.float32, torch.bfloat16):
        for label in kernel_check.FLASH_CASES:
            errs = kernel_check.check_flash_bwd(label, dtype)
            results.append({"kernel": "flash_bwd", "case": label,
                            "dtype": str(dtype)[6:], **errs})
        errs = kernel_check.check_flash_bwd(DLSE_CASE, dtype, dlse=True)
        results.append({"kernel": "flash_bwd", "case": DLSE_CASE + "+dlse",
                        "dtype": str(dtype)[6:], **errs})
    for r in results:
        emit({"phase": "kernels", **r})
    bad = [f"{r['kernel']}:{r['case']}/{r['dtype']}" for r in results
           if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    same = kernel_check.bwd_repeats_bitwise("train")
    emit({"phase": "kernels", "kernel": "flash_bwd", "case": "train",
          "dtype": "bfloat16", "two_launches_bitwise_equal": same})
    check(all(same.values()), f"two launches of the backward kernels "
          f"differ: {same}")


def phase_faults(libs):
    """Each planted fault, built from a copy of a kernel's source, must
    fail the limits that the kernel passes."""
    from singa_tpu_torch import kernel_check
    results = []
    for name, lib in libs.items():
        if name in kernel_check.FLASH_FAULTS:
            label = kernel_check.FLASH_FAULTS[name][0]
            with kernel_check.flash_kernel(lib):
                errs = kernel_check.check_flash(label, torch.bfloat16)
        else:
            label = kernel_check.FLASH_BWD_FAULTS[name][0]
            with kernel_check.flash_bwd_kernel(lib):
                errs = kernel_check.check_flash_bwd(label, torch.bfloat16)
        results.append({"fault": name, "case": label, "dtype": "bfloat16",
                        **errs, "caught": not errs["ok"]})
    emit({"phase": "faults", "faults": results})
    missed = [r["fault"] for r in results if not r["caught"]]
    check(not missed, f"planted faults pass the kernels' limits: {missed}")


class plain_attention:
    """Route the flash wrappers, forward and backward, to their plain
    versions for a comparison run (the main paths never do this)."""

    def __enter__(self):
        from singa_tpu_torch.ops import flash_attention as fa
        self.fa = fa
        self.saved = fa._flash_fwd_cuda, fa._flash_bwd_cuda
        fa._flash_fwd_cuda = fa._flash_fwd_reference
        fa._flash_bwd_cuda = fa._flash_bwd_reference

    def __exit__(self, *exc):
        self.fa._flash_fwd_cuda, self.fa._flash_bwd_cuda = self.saved


def _timed(fn):
    """(fn's result, seconds) with the card synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _median_ms(fn, n=5):
    return sorted(_timed(fn)[1] for _ in range(n))[n // 2] * 1e3


def phase_slice():
    from singa_tpu_torch import device
    from singa_tpu_torch.models import Llama, LlamaConfig
    from singa_tpu_torch.models import _generate
    from singa_tpu_torch.ops import flash_attention as fa

    dev = device.create_device("cuda")
    cfg = LlamaConfig.base()
    m, build_s = _timed(lambda: Llama(
        cfg, device=dev, generator=torch.Generator("cuda").manual_seed(0)))
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, P))
    kw = dict(max_new_tokens=N, param_dtype=torch.bfloat16)
    S = P + N

    # eager: the same steps, each op launched from the host
    m.generate(prompts, use_graph=False, **kw)     # warm call
    out_eager, eager_s = _timed(lambda: m.generate(prompts, use_graph=False,
                                                   **kw))
    # captured: the first call is the warm-up, the second captures
    fa.reset_device_launches()
    m.generate(prompts, **kw)
    warm_launches = fa.device_launches()
    _, capture_call_s = _timed(lambda: m.generate(prompts, **kw))
    torch.cuda.reset_peak_memory_stats()
    fa.reset_device_launches()                     # the main path's run
    out, gen_s = _timed(lambda: m.generate(prompts, **kw))
    launches = fa.device_launches()
    peak = torch.cuda.max_memory_allocated()
    graphs = m._gen_sessions[(B, P, S, torch.bfloat16,
                              (0.0, None, None, None))].graphs
    prefill_ms = _median_ms(graphs["prefill"].replay)

    # the eager prefill alone, and its logits with the kernel vs the
    # plain version
    ids = torch.as_tensor(prompts, dtype=torch.int32, device="cuda")
    params = {n: p.detach().to(torch.bfloat16)
              for n, p in m.get_params().items()}
    with torch.no_grad(), _generate._bound(m, params):
        prefill = _generate.prefill_step(m, S)
        eager_prefill_ms = _median_ms(lambda: prefill(ids))
        lg_kernel, _ = prefill(ids)
        with plain_attention():
            lg_plain, _ = prefill(ids)
    del params
    with plain_attention():
        out_plain = m.generate(prompts, use_graph=False, **kw)
    lg_kernel, lg_plain = lg_kernel.float(), lg_plain.float()
    dlogit = (lg_kernel - lg_plain).abs().max().item()
    ref_max = lg_plain.abs().max().item()
    agree = float((out[:, P:] == out_plain[:, P:]).mean())

    # the card's memory as sessions of other prompt lengths are added:
    # each holds its caches and graph pools, all share one bf16 weight copy
    def memory(p):
        return {"prompt_len": p, "sessions": len(m._gen_sessions),
                "allocated_bytes": torch.cuda.memory_allocated(),
                "reserved_bytes": torch.cuda.memory_reserved(),
                "peak_bytes": torch.cuda.max_memory_allocated()}
    sessions = [memory(P)]
    for p in SESSION_PROMPTS:
        for _ in range(2):                         # warm-up, capture
            m.generate(prompts[:, :p], **kw)
        sessions.append(memory(p))
    weight_copies = len(m._gen_params)
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       m._gen_params[torch.bfloat16][1].values())
    shared = len({id(s.params) for s in m._gen_sessions.values()}) == 1

    # generate = prefill + N - 1 decode steps
    decode_ms = (gen_s * 1e3 - prefill_ms) / (N - 1)
    eager_decode_ms = (eager_s * 1e3 - eager_prefill_ms) / (N - 1)
    result = {
        "phase": "slice", "config": "LlamaConfig.base()",
        "params": m.num_params(), "B": B, "P": P, "N": N,
        "param_dtype": "bfloat16", "model_build_s": build_s,
        "captured": graphs["decode"].graph is not None,
        "warm_launches": warm_launches, "launches": launches,
        "expected_launches": {"flash_fwd": cfg.num_layers,
                              "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
        "generate_ms": gen_s * 1e3, "prefill_ms": prefill_ms,
        "decode_ms_per_token": decode_ms,
        "tokens_per_s": B * N / gen_s,
        "capture_call_ms": capture_call_s * 1e3,
        "graphs": {n: {"num_ops": g.num_ops, "flops": g.flops(),
                       "pool_bytes": g.pool_bytes,
                       "capture_s": g.capture_seconds,
                       "launches": g.launches}
                   for n, g in graphs.items()},
        "eager": {"generate_ms": eager_s * 1e3,
                  "prefill_ms": eager_prefill_ms,
                  "decode_ms_per_token": eager_decode_ms,
                  "tokens_per_s": B * N / eager_s},
        "tokens_equal_eager": bool((out == out_eager).all()),
        "peak_memory_bytes": peak,
        "memory_by_session": sessions,
        "bf16_weight_copies": weight_copies,
        "bf16_weight_bytes": weight_bytes,
        "sessions_share_weights": shared,
        "prefill_logits_max_abs_diff": dlogit,
        "prefill_logits_max_abs": ref_max,
        "logit_rtol": LOGIT_RTOL,
        "greedy_token_agreement_vs_plain": agree,
    }
    emit(result)
    check(result["captured"], "generate() did not run captured graphs")
    check(warm_launches == launches == result["expected_launches"],
          f"the kernels ran {warm_launches} (warm-up) and {launches} "
          f"(captured) times in a generate call, expected "
          f"{result['expected_launches']}")
    check(weight_copies == 1 and shared, f"the sessions hold "
          f"{weight_copies} bf16 weight copies (shared: {shared})")
    check(graphs["prefill"].launches == {"flash_fwd": cfg.num_layers},
          f"the prefill graph holds {graphs['prefill'].launches}")
    check(out.shape == (B, P + N) and out.dtype == np.int32,
          f"generate returned {out.shape} {out.dtype}")
    check((out[:, :P] == prompts).all(), "prompt not echoed")
    check(((out >= 0) & (out < cfg.vocab_size)).all(), "token out of range")
    check(result["tokens_equal_eager"],
          "captured greedy tokens differ from the eager call's")
    check(np.isfinite(lg_kernel.cpu().numpy()).all(), "non-finite logits")
    check(dlogit <= LOGIT_RTOL * ref_max,
          f"prefill logits differ by {dlogit} (max |logit| {ref_max})")
    phase_profile(lambda: m.generate(prompts, **kw),
                  f"one captured generate call, B={B} P={P} N={N}",
                  {"flash_fwd": cfg.num_layers})
    return launches["flash_fwd"], m


def serve_prompts(vocab):
    """The serve phase's 16 prompts, from a numpy seed: 8 share a
    256-token system prompt with private suffixes of 64-512 tokens, 8
    are private prompts of 128-768 tokens; interleaved."""
    rng = np.random.RandomState(5)
    system = rng.randint(0, vocab, SERVE_SYSTEM)
    half = SERVE_REQUESTS // 2
    shared = [np.concatenate([system, rng.randint(0, vocab, n)])
              for n in rng.randint(64, 513, half)]
    private = [rng.randint(0, vocab, n) for n in rng.randint(128, 769, half)]
    return [p.astype(np.int32) for pair in zip(shared, private)
            for p in pair]


def serve_engine(m, slots=SERVE_SLOTS, **kw):
    """A ServeEngine over `m` at the phase's shape, warmed up: one
    request of two chunks and three tokens runs each program's first
    (eager) dispatch and its capture, then the metrics start afresh.
    (engine, requests the warm-up admitted)."""
    from singa_tpu_torch.serve import ServeEngine
    from singa_tpu_torch.serve.metrics import ServeMetrics
    kw = {"param_dtype": torch.bfloat16, **kw}
    eng = ServeEngine(m, slots, SERVE_MAX_LEN, block_size=SERVE_BLOCK,
                      backoff_base=0.001, backoff_max=0.01, **kw)
    warm = np.random.RandomState(99).randint(0, m.cfg.vocab_size,
                                             SERVE_BLOCK + 8)
    # long enough for two verify rounds on a spec engine
    eng.submit(warm, max_new_tokens=3 + 2 * eng.spec_k)
    eng.run_until_idle()
    warm_requests = eng.metrics.admitted
    eng.metrics = ServeMetrics(flight=eng.flight)
    return eng, warm_requests


def traffic(eng, prompts, recover_after=None, new_tokens=SERVE_NEW):
    """Submit every prompt at once and run to idle (with `recover_after`,
    step that many times, force a recovery, then run to idle):
    (streams, seconds, each request's TTFT in ms)."""
    hs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]

    def run():
        if recover_after is not None:
            for _ in range(recover_after):
                eng.step()
            eng.recover("chip_smoke: mid-wave")
        eng.run_until_idle()
    _, secs = _timed(run)
    return ([list(map(int, h.tokens)) for h in hs], secs,
            [h.ttft_s * 1e3 for h in hs])


def serve_traffic(eng, prompts):
    """Submit every prompt at once and run to idle: (streams, seconds)."""
    return traffic(eng, prompts)[:2]


def recovery_plan():
    """Three decode faults in a row (past the two retries) at the 20th
    tick, forcing a recovery, and one transient prefill fault."""
    from singa_tpu_torch import faults
    return faults.FaultPlan(
        [faults.FaultSpec("serve.decode", "error", at=20 + i)
         for i in range(3)]
        + [faults.FaultSpec("serve.prefill", "error", at=5)])


def _differ(got, expect):
    """Whether the streams equal `expect`, how many differ and the first
    position at which one does."""
    differ = [next(i for i, (a, b) in enumerate(zip(g, e)) if a != b)
              for g, e in zip(got, expect) if g != e]
    return {"streams_equal": got == expect,
            "requests_differing": len(differ),
            "first_differing_token": min(differ) if differ else None}


def wave_run(eng, wave, expect, plan=None, recover_after=None,
             keep_streams=False):
    """`wave` through `eng` (under a fault plan, or with a recovery
    after `recover_after` steps, if given): whether its streams equal
    `expect`, how many differ and the first position at which one does,
    its seconds and TTFT p50, the programs made and what the engine's
    counters moved by (and, with `keep_streams`, the streams beside)."""
    from singa_tpu_torch import faults
    before = eng.metrics.snapshot()
    with faults.active(plan) if plan is not None else nullcontext(), \
            warnings.catch_warnings():
        # a spec engine's fallback tick warns; the counters tell it
        warnings.simplefilter("ignore")
        got, secs, ttft = traffic(eng, wave, recover_after)
    after = eng.metrics.snapshot()
    out = {**_differ(got, expect), "seconds": secs,
           "ttft_p50_ms": float(np.median(ttft)),
           "compiled_counts": (eng.spec_compiled_counts()
                               if eng.spec_k else eng.compiled_counts())}
    for key in ("admitted", "recoveries", "preempted", "steps",
                "spec_rounds", "spec_fallbacks"):
        out[key] = after[key] - before[key]
    for site in ("serve.prefill", "serve.decode"):
        out[site.split(".")[1] + "_retries"] = (
            after["retries"].get(site, 0) - before["retries"].get(site, 0))
    if plan is not None:
        out["fired"] = plan.fire_count()
    return (out, got) if keep_streams else out


def _gap_summary(gaps, agree, limit):
    return {"max_gap": float(gaps.max()),
            "gap_p99": float(np.quantile(gaps, 0.99)),
            "positions": int(gaps.size),
            "positions_over_limit": int((gaps > limit).sum()),
            "argmax_agreement": agree}


def teacher_forced_gaps(m, eng, prompts, streams):
    """Each request's prompt and engine tokens through one plain causal
    forward under the engine's weights: at every generated position the
    forward's largest logit minus its logit of the engine's token (0
    where they agree).  (all gaps, share of positions where the
    engine's token is the forward's argmax)."""
    from singa_tpu_torch.models import _generate
    gaps = []
    with torch.no_grad(), _generate._bound(m, eng._params), \
            plain_attention():
        for p, toks in zip(prompts, streams):
            ids = torch.as_tensor(np.concatenate([p, toks[:-1]])[None],
                                  dtype=torch.int64, device=eng._device)
            lg = m(ids)[0, p.size - 1:].float()
            tok = torch.as_tensor(toks, device=eng._device)
            gaps.append(lg.max(-1).values
                        - lg.gather(1, tok[:, None])[:, 0])
    gaps = torch.cat(gaps)
    return gaps.cpu().numpy(), float((gaps == 0).float().mean())


def faulty_gaps(m, fault, prompts, **kw):
    """A fresh engine over `m` captured with a planted fault in place,
    its streams for `prompts` and their teacher-forced gaps."""
    with fault:
        eng, _ = serve_engine(m, **kw)
        streams, _ = serve_traffic(eng, prompts)
    out = teacher_forced_gaps(m, eng, prompts, streams)
    eng.close()
    return out


def f32_model(cfg):
    """`cfg` at seed 0 on the card, computing in f32 (the card's default
    is bf16 activations)."""
    from singa_tpu_torch import device
    from singa_tpu_torch.models import Llama
    dev = device.create_device("cuda")
    dev.default_dtype = torch.float32
    return Llama(cfg, device=dev,
                 generator=torch.Generator("cuda").manual_seed(0))


def oracle_f32(cfg, prompts):
    """The teacher-forced oracle on an engine computing in f32 (f32
    weights, arena and activations) over `prompts`, sound and with the
    planted scatter fault: {"sound": (gaps, agreement), "fault": ...}."""
    m = f32_model(dataclasses.replace(cfg, num_layers=SERVE_ORACLE_LAYERS))
    eng, _ = serve_engine(m, param_dtype=None)
    streams, _ = serve_traffic(eng, prompts)
    out = {"sound": teacher_forced_gaps(m, eng, prompts, streams)}
    eng.close()
    out["fault"] = faulty_gaps(m, late_token_scatter(), prompts,
                               param_dtype=None)
    return out


class _swap:
    """Swap `module.name` for `make(saved)` while the context is open
    (for a fresh engine's capture)."""

    def __init__(self, module, name, make):
        self.module, self.name, self.make = module, name, make

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.make(self.saved))

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def late_token_scatter():
    """Planted fault: each decode token's k/v written one offset late in
    its block."""
    from singa_tpu_torch.ops import kv_cache

    def make(scatter):
        return lambda ck, cv, block, offset, k, v: scatter(
            ck, cv, block, (offset + 1) % SERVE_BLOCK, k, v)
    return _swap(kv_cache, "scatter_token_kv", make)


def null_block_scatter():
    """Planted fault: every decode token's k/v written into the null
    block, as a slot with a stale table row would write them."""
    from singa_tpu_torch.ops import kv_cache

    def make(scatter):
        return lambda ck, cv, block, offset, k, v: scatter(
            ck, cv, torch.zeros_like(block), offset, k, v)
    return _swap(kv_cache, "scatter_token_kv", make)


def phase_serve(m):
    """The paged ServeEngine over `m` (LlamaConfig.base(), f32 masters)
    serving bf16 weights: traffic, checks and readings.  Returns the
    main engine's flash launches and the requests it admitted, from the
    card's counters zeroed before its warm-up and read after its
    traffic, burst, fault runs and the runs without prefix sharing, and
    what the later serving phases reuse: the prompts, the streams, the
    first wave's rerun and the engine's tick and arena."""
    from singa_tpu_torch.models import _generate
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.serve import QueueFull

    t0 = time.perf_counter()
    cfg = m.cfg
    zero = dict.fromkeys(fa.KERNELS, 0)
    prompts = serve_prompts(cfg.vocab_size)
    fa.reset_device_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng, warm_requests = serve_engine(m)
    counts_warm = eng.compiled_counts()
    streams, secs = serve_traffic(eng, prompts)
    snap = eng.metrics.snapshot()
    peak = torch.cuda.max_memory_allocated() - base
    counts_traffic = eng.compiled_counts()
    # a burst past max_queue between two steps is refused
    burst = np.random.RandomState(98).randint(0, cfg.vocab_size, 8)
    try:
        for _ in range(eng.sched.max_queue + 1):
            eng.submit(burst, max_new_tokens=1)
        queue_full = False
    except QueueFull:
        queue_full = True
    eng.run_until_idle()
    # the first wave again: plain, through a recovery and without
    # prefix sharing; each held to the first wave's streams
    wave, expect = prompts[:SERVE_SLOTS], streams[:SERVE_SLOTS]
    plain = wave_run(eng, wave, expect)
    recovery = wave_run(eng, wave, expect, recovery_plan())
    eng.share_prefix = False
    private = wave_run(eng, wave, expect)
    eng.share_prefix = True
    launches = fa.device_launches()
    requests = warm_requests + eng.metrics.admitted

    arena_bytes = sum(t.numel() * t.element_size()
                      for kv in eng.pool.caches for t in kv)
    graphs = {"prefill_chunk": eng._prefill.graph, "decode": eng._decode.graph}
    pool_bytes = {n: g.pool_bytes for n, g in graphs.items()}
    # replays of the two captured programs on the idle engine (the same
    # kernels as under traffic: the decode tick's work does not depend
    # on how many slots are live)
    tick_ms = _median_ms(eng._decode, n=21)
    tick_device_ms = cuda_time_ms(eng._decode, iters=20, warmup=2)
    chunk_ms = _median_ms(eng._prefill, n=21)
    chunk_device_ms = cuda_time_ms(eng._prefill, iters=20, warmup=2)
    phase_profile(lambda: (eng._decode(), eng._toks.cpu()),
                  f"one decode tick of the serve engine ({SERVE_SLOTS} "
                  f"slots, replay + token fetch)", zero)
    gaps, agree = teacher_forced_gaps(m, eng, prompts, streams)
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # the other engines: none may launch a flash kernel either
    fa.reset_device_launches()
    eng, _ = serve_engine(m, num_blocks=SERVE_PREEMPT_BLOCKS)
    preempt = wave_run(eng, wave, expect)
    eng.close()
    del eng
    gross, gross_agree = faulty_gaps(m, null_block_scatter(), wave)
    gc.collect()
    torch.cuda.empty_cache()
    f32 = oracle_f32(cfg, prompts[:SERVE_ORACLE])
    gc.collect()
    torch.cuda.empty_cache()
    other_launches = fa.device_launches()

    # sequential generate() calls over as many prompts as generate()
    # keeps sessions: each session's first (eager) call and its capture
    # first, then the prompts timed through the captured sessions, as
    # bench.py's warm diagnostic times them
    seq_prompts = prompts[:_generate.MAX_SESSIONS]
    kw = dict(max_new_tokens=SERVE_NEW, param_dtype=torch.bfloat16)
    first_s = 0.0
    for p in seq_prompts:
        first_s += _timed(lambda: m.generate(p[None], **kw))[1]
        m.generate(p[None], **kw)
    seq, seq_s = _timed(lambda: [m.generate(p[None], **kw)[0, p.size:]
                                 for p in seq_prompts])
    seq_tokens = len(seq_prompts) * SERVE_NEW
    seq_agree = float(np.mean([np.mean(np.asarray(s) == np.asarray(e))
                               for s, e in zip(seq, streams)]))

    n_tok = sum(len(t) for t in streams)
    ttft = snap["ttft_ms"]
    result = {
        "phase": "serve", "config": "LlamaConfig.base()",
        "param_dtype": "bfloat16", "num_slots": SERVE_SLOTS,
        "max_len": SERVE_MAX_LEN, "block_size": SERVE_BLOCK,
        "requests": len(prompts), "max_new_tokens": SERVE_NEW,
        "prompt_lens": [int(p.size) for p in prompts],
        "compiled_counts": {"after_warm_up": counts_warm,
                            "after_traffic": counts_traffic,
                            "after_recovery": recovery["compiled_counts"],
                            "preemption_engine":
                            preempt["compiled_counts"]},
        "seconds": secs, "tokens": n_tok, "tokens_per_s": n_tok / secs,
        "ttft_ms": {"p50": ttft["p50"], "p99": ttft["p99"],
                    "max": ttft["max"]},
        "token_ms": snap["token_ms"],
        "prefill_chunk_ms": chunk_ms, "prefill_chunk_device_ms":
        chunk_device_ms, "decode_tick_ms": tick_ms,
        "decode_tick_device_ms": tick_device_ms,
        "prefix_hits": snap["prefix_hits"],
        "prefix_hit_tokens": snap["prefix_hit_tokens"],
        "preempted": snap["preempted"], "steps": snap["steps"],
        "arena_bytes": arena_bytes, "graph_pool_bytes": pool_bytes,
        "peak_memory_bytes": peak,
        "graphs": {n: {"num_ops": g.num_ops, "flops": g.flops(),
                       "capture_s": g.capture_seconds}
                   for n, g in graphs.items()},
        "queue_full_on_burst": queue_full,
        "main_engine": {"requests_admitted": requests,
                        "flash_launches": launches},
        "teacher_forced_bf16": {
            "limit": SERVE_BF16_GAP, "sound": _gap_summary(
                gaps, agree, SERVE_BF16_GAP),
            "planted_fault": _gap_summary(gross, gross_agree,
                                          SERVE_BF16_GAP),
            "fault": "null_block_scatter", "fault_requests": len(wave)},
        "teacher_forced_f32": {
            "delta": SERVE_DELTA, "requests": SERVE_ORACLE,
            "sound": _gap_summary(*f32["sound"], SERVE_DELTA),
            "planted_fault": _gap_summary(*f32["fault"], SERVE_DELTA),
            "fault": "late_token_scatter"},
        "wave": {"requests": len(wave), "plain": plain,
                 "recovery": recovery, "no_prefix_sharing": private,
                 "preemption": {"num_blocks": SERVE_PREEMPT_BLOCKS,
                                **preempt}},
        "other_engines_flash_launches": other_launches,
        "sequential_generate": {
            "prompts": len(seq_prompts),
            "captured_seconds": seq_s,
            "captured_tokens_per_s": seq_tokens / seq_s,
            "first_calls_eager_seconds": first_s,
            "token_agreement_with_engine": seq_agree},
        "tokens_per_s_over_sequential_captured":
        n_tok / secs / (seq_tokens / seq_s),
        "phase_seconds": time.perf_counter() - t0,
    }
    emit(result)
    check(counts_traffic == (1, 1) and recovery["compiled_counts"] == (1, 1)
          and preempt["compiled_counts"] == (1, 1),
          f"compiled_counts {result['compiled_counts']}, expected (1, 1)")
    check(all(len(t) == SERVE_NEW for t in streams)
          and all(0 <= x < cfg.vocab_size for t in streams for x in t),
          "the engine's streams are short or out of range")
    check(queue_full, "a burst past max_queue was not refused")
    check(snap["prefix_hits"] >= SERVE_REQUESTS // 2 - 1,
          f"only {snap['prefix_hits']} prefix hits")
    check(plain["streams_equal"], "the first wave alone gives other streams "
          "than in the full traffic")
    check(float(gaps.max()) <= SERVE_BF16_GAP, f"bf16 engine tokens fail "
          f"the teacher-forced check: max gap {gaps.max()}")
    check(float(gross.max()) > SERVE_BF16_GAP, f"the planted null-block "
          f"fault passes the bf16 teacher-forced check: max gap "
          f"{gross.max()}")
    check(float(f32["sound"][0].max()) <= SERVE_DELTA, f"f32 engine tokens "
          f"fail the teacher-forced oracle: max gap "
          f"{f32['sound'][0].max()} > {SERVE_DELTA}")
    check(float(f32["fault"][0].max()) > SERVE_DELTA, f"the planted scatter "
          f"fault passes the oracle: max gap {f32['fault'][0].max()}")
    check(private["streams_equal"] and private["admitted"] == len(wave),
          f"run without prefix sharing: {private}")
    check(recovery["streams_equal"] and recovery["recoveries"] == 1
          and recovery["prefill_retries"] >= 1,
          f"recovery run: {recovery}")
    check(preempt["streams_equal"] and preempt["preempted"] >= 1,
          f"preemption run: {preempt}")
    check(launches == zero, f"the flash kernels ran {launches} times on "
          f"the serve path")
    check(other_launches == zero, f"the flash kernels ran {other_launches} "
          f"times in the other engines")
    return launches, requests, {
        "prompts": prompts, "streams": streams, "wave": expect,
        "plain_wave": plain, "decode_tick_ms": tick_ms,
        "decode_tick_device_ms": tick_device_ms,
        "arena_bytes": arena_bytes, "peak_memory_bytes": peak}


def vs_plain(streams, expect):
    """A speculative run's streams against the plain engine's
    (`expect`): bitwise, and the share of tokens that agree."""
    return {**_differ(streams, expect),
            "token_agreement_with_plain": float(np.mean(
                [np.mean(np.asarray(g) == np.asarray(e))
                 for g, e in zip(streams, expect)]))}


def _graph_bytes(*programs):
    return {p.name: p.graph.pool_bytes for p in programs
            if p.graph is not None}


def draft_model(cfg):
    """LlamaConfig.base() cut to SPEC_DRAFT_LAYERS layers, random weights
    from seed 1: a draft that disagrees with the target."""
    from singa_tpu_torch import device
    from singa_tpu_torch.models import Llama
    return Llama(dataclasses.replace(cfg, num_layers=SPEC_DRAFT_LAYERS),
                 device=device.create_device("cuda"),
                 generator=torch.Generator("cuda").manual_seed(1))


def phase_spec(m, ctx):
    """Speculative decoding (spec_k=SPEC_K) over the serve phase's first
    wave: self-speculation (a cold run, then a rerun over the warm
    prefix cache, timed as the serve phase's plain rerun is), a
    disagreeing draft, a verify fault past the retries (plain-decode
    fallback) and a recovery mid-wave, each held bitwise to the plain
    engine's streams: the bf16 verify window picks what the decode step
    picks (PERF.md, section 6), so no f32 engine stands in.  Returns the
    flash launches of the main spec engine (none expected) and the
    requests it admitted."""
    from singa_tpu_torch import faults
    from singa_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg = m.cfg
    wave, expect = ctx["prompts"][:SERVE_SLOTS], ctx["wave"]
    fa.reset_device_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng, warm_requests = serve_engine(m, draft_model=m, spec_k=SPEC_K)
    counts_warm = eng.spec_compiled_counts()
    streams, secs, ttft = traffic(eng, wave)
    snap = eng.metrics.snapshot()
    peak = torch.cuda.max_memory_allocated() - base
    counts = eng.spec_compiled_counts()
    self_spec = vs_plain(streams, expect)
    rerun = wave_run(eng, wave, expect)
    plan = faults.FaultPlan([faults.FaultSpec("serve.verify", "error",
                                              at=6 + i) for i in range(3)])
    fault = wave_run(eng, wave, expect, plan)
    recovery = wave_run(eng, wave, expect, recover_after=6)
    launches = fa.device_launches()
    requests = warm_requests + eng.metrics.admitted
    round_ms = _median_ms(eng._verify, n=21)
    round_device_ms = cuda_time_ms(eng._verify, iters=20, warmup=2)
    graph_bytes = _graph_bytes(eng._prefill, eng._decode, eng._verify)
    phase_profile(lambda: (eng._verify(), eng._spec_out.cpu()),
                  f"one verify round of the spec engine (k={SPEC_K}, "
                  f"{SERVE_SLOTS} slots, replay + fetch)",
                  dict.fromkeys(fa.KERNELS, 0))
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # a disagreeing draft: every round still yields one target token
    dm = draft_model(cfg)
    eng, _ = serve_engine(m, draft_model=dm, spec_k=SPEC_K)
    d_streams, d_secs, _ = traffic(eng, wave)
    d_snap = eng.metrics.snapshot()
    disagree = vs_plain(d_streams, expect)
    d_counts = eng.spec_compiled_counts()
    eng.close()
    del eng, dm
    gc.collect()
    torch.cuda.empty_cache()

    n_tok = sum(len(t) for t in streams)
    plain = ctx["plain_wave"]
    result = {
        "phase": "spec", "config": "LlamaConfig.base()",
        "param_dtype": "bfloat16", "spec_k": SPEC_K,
        "num_slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
        "requests": len(wave), "max_new_tokens": SERVE_NEW,
        "compiled_counts": {"after_warm_up": counts_warm,
                            "after_traffic": counts,
                            "after_fallback": fault["compiled_counts"],
                            "after_recovery": recovery["compiled_counts"]},
        "self_speculation": {
            "accept_rate": snap["accept_rate"],
            "tokens_per_dispatch": snap["tokens_per_dispatch"],
            "spec_rounds": snap["spec_rounds"],
            "cold": {"seconds": secs, "tokens_per_s": n_tok / secs,
                     "ttft_p50_ms": float(np.median(ttft))},
            "rerun": {**rerun, "tokens_per_s": n_tok / rerun["seconds"]},
            "token_ms": snap["token_ms"], **self_spec},
        "plain_engine_rerun": {"seconds": plain["seconds"],
                         "tokens_per_s": n_tok / plain["seconds"],
                         "ttft_p50_ms": plain["ttft_p50_ms"],
                         "decode_tick_ms": ctx["decode_tick_ms"],
                         "decode_tick_device_ms":
                         ctx["decode_tick_device_ms"]},
        "verify_round_ms": round_ms,
        "verify_round_device_ms": round_device_ms,
        "graph_pool_bytes": graph_bytes, "peak_memory_bytes": peak,
        "disagreeing_draft": {
            "draft": f"LlamaConfig.base() cut to {SPEC_DRAFT_LAYERS} "
                     f"layers, seed 1",
            "accept_rate": d_snap["accept_rate"],
            "tokens_per_dispatch": d_snap["tokens_per_dispatch"],
            "spec_rounds": d_snap["spec_rounds"],
            "slot_dispatches": d_snap["slot_dispatches"],
            "seconds": d_secs, "tokens_per_s": n_tok / d_secs,
            "compiled_counts": d_counts, **disagree},
        "verify_fault": fault, "recovery": recovery,
        "main_engine": {"requests_admitted": requests,
                        "flash_launches": launches},
        "phase_seconds": time.perf_counter() - t0,
    }
    emit(result)
    check(counts == (1, 0, 1, 0), f"spec_compiled_counts {counts} after "
          f"the traffic, expected (1, 0, 1, 0)")
    check(fault["compiled_counts"] == (1, 1, 1, 0)
          and recovery["compiled_counts"] == (1, 1, 1, 0)
          and d_counts == (1, 0, 1, 0),
          f"spec_compiled_counts {result['compiled_counts']}, "
          f"disagreeing draft {d_counts}")
    check(fault["spec_fallbacks"] >= 1 and fault["fired"] == 3,
          f"the verify fault did not fall back: {fault}")
    check(recovery["recoveries"] == 1, f"recovery run: {recovery}")
    for name, h in (("self-speculation", self_spec), ("its rerun", rerun),
                    ("the disagreeing draft", disagree),
                    ("the verify fault", fault), ("the recovery", recovery)):
        check(h["streams_equal"], f"{name}'s streams differ from the plain "
              f"engine's: {h}")
    check(snap["accept_rate"] is not None and snap["accept_rate"] > 0.5,
          f"self-speculation accept rate {snap['accept_rate']}")
    check(d_snap["accept_rate"] < 0.05
          and d_snap["spec_rounds"] == d_snap["slot_dispatches"]
          and d_snap["tokens_per_dispatch"] >= 1.0,
          f"disagreeing draft: {result['disagreeing_draft']}")
    check(launches == dict.fromkeys(fa.KERNELS, 0),
          f"the flash kernels ran {launches} times on the spec path")
    return launches, requests


def equal_bytes_run(m, prompts, kv_dtype, num_blocks):
    """All of `prompts` at once over INT8_SLOTS slots and `num_blocks`
    blocks, without prefix sharing: (engine summary, streams).  Peak
    concurrency is read between steps."""
    eng, _ = serve_engine(m, slots=INT8_SLOTS, num_blocks=num_blocks,
                          kv_dtype=kv_dtype, share_prefix=False)
    hs = [eng.submit(p, max_new_tokens=MEM_NEW) for p in prompts]
    peak = 0

    def run():
        nonlocal peak
        while eng.pending:
            eng.step()
            peak = max(peak, eng.pool.active_count)
    _, secs = _timed(run)
    snap = eng.metrics.snapshot()
    n_tok = sum(len(h.tokens) for h in hs)
    out = {"kv_dtype": kv_dtype or "bfloat16", "num_blocks": num_blocks,
           "block_bytes": eng.pool.block_bytes,
           "arena_bytes": num_blocks * eng.pool.block_bytes,
           "peak_concurrency": peak, "seconds": secs,
           "tokens_per_s": n_tok / secs,
           "ttft_ms": {k: snap["ttft_ms"][k] for k in ("p50", "p99")},
           "decode_tick_ms": _median_ms(eng._decode, n=21),
           "compiled_counts": eng.compiled_counts(),
           "graph_pool_bytes": _graph_bytes(eng._prefill, eng._decode)}
    streams = [list(map(int, h.tokens)) for h in hs]
    eng.close()
    return out, streams


def scales_dropped():
    """Planted fault: the verify window's int8 scatter stores the codes
    without their scales (the positions keep the scales they held), as
    a scatter that forgot half of QuantKV would."""
    from singa_tpu_torch.ops import kv_cache

    def make(scatter):
        def faulty(ck, cv, blocks, offsets, k, v):
            if not isinstance(ck, kv_cache.QuantKV):
                return scatter(ck, cv, blocks, offsets, k, v)
            for c, x in ((ck, k), (cv, v)):
                c.q[blocks.long(), offsets.long()] = kv_cache.quantize_kv(x)[0]
            return ck, cv
        return faulty
    return _swap(kv_cache, "scatter_tokens_kv", make)


def misplaced_restore(num_blocks):
    """Planted fault: every restored block written one block further on
    (wrapping), so the prefix cache keys a block that holds other
    content."""
    from singa_tpu_torch.serve import mem

    def make(write):
        return lambda restore, blocks, payloads: write(
            restore, [(b + 1) % num_blocks for b in blocks], payloads)
    return _swap(mem, "write_blocks", make)


def spill_waves(m, prompts, spill, fault=None):
    """The spill run on a SPILL_POOL-block pool: 4 requests behind the
    system prompt, then the 8 private prompts (which evict its blocks),
    then the other 4 system-prompt requests.  (summary, third wave's
    streams)."""
    from singa_tpu_torch.serve import mem
    shared, private = prompts[0::2], prompts[1::2]
    with fault if fault is not None else nullcontext():
        eng, _ = serve_engine(m, num_blocks=SPILL_POOL,
                              spill_blocks=SPILL_STORE if spill else None)
        if spill:
            # warm the restore program up (eager, then captured) on the
            # null block's own bytes, as the warm-up request does the
            # engine's programs: the third wave times warm re-hits
            pool = eng.pool
            pool.restore = mem.Restore(pool.caches, pool.draft_caches)
            null = mem.read_block(pool.caches, pool.draft_caches, 0)
            for _ in range(2):
                mem.write_block(pool.restore, 0, null)
        traffic(eng, shared[:4], new_tokens=MEM_NEW)
        traffic(eng, private, new_tokens=MEM_NEW)
        spilled = eng.metrics.spilled_blocks
        third, secs, ttft = traffic(eng, shared[4:], new_tokens=MEM_NEW)
    snap = eng.metrics.snapshot()
    out = {"spill_blocks": SPILL_STORE if spill else None,
           "spilled_blocks": spilled, "prefetch_hits": snap["prefetch_hits"],
           "prefetch_wait_ms": snap["prefetch_wait_ms"],
           "third_wave_seconds": secs,
           "third_wave_ttft_ms": {"p50": float(np.median(ttft)),
                                  "first": ttft[0]},
           "restore_compiled_count": (
               mem.restore_compiled_count(eng.pool.restore)
               if eng.pool.restore is not None else 0),
           "restore_graph_pool_bytes": (
               eng.pool.restore.program.graph.pool_bytes
               if eng.pool.restore is not None
               and eng.pool.restore.program.graph is not None else None),
           "compiled_counts": eng.compiled_counts()}
    eng.close()
    return out, third


def phase_mem(m, ctx):
    """The memory hierarchy: the int8 arena at the serve phase's arena
    bytes over INT8_SLOTS slots beside the bf16 arena at the same bytes;
    the referee (an int8 draft arena under a bf16 target, self-
    speculation) over the first wave, sound and with the scales dropped;
    quantize_kv on the card against the CPU; and the spill tier.
    Returns the flash launches of its engines (none expected)."""
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.ops import kv_cache
    from singa_tpu_torch.serve import mem

    t0 = time.perf_counter()
    prompts, wave, expect = ctx["prompts"], ctx["prompts"][:SERVE_SLOTS], \
        ctx["wave"]
    zero = dict.fromkeys(fa.KERNELS, 0)
    fa.reset_device_launches()
    bf16_blocks = ctx["arena_bytes"] // (2 * m.cfg.num_layers * SERVE_BLOCK
                                         * m.cfg.num_kv_heads
                                         * m.cfg.head_dim * 2)
    int8_block = 2 * m.cfg.num_layers * SERVE_BLOCK * (
        m.cfg.num_kv_heads * m.cfg.head_dim + 4)
    int8_blocks = ctx["arena_bytes"] // int8_block
    twice = (prompts + prompts)[:INT8_SLOTS]
    int8, int8_streams = equal_bytes_run(m, twice, "int8", int8_blocks)
    bf16, bf16_streams = equal_bytes_run(m, twice, None, bf16_blocks)
    int8["token_agreement_with_bf16"] = float(np.mean(
        [np.mean(np.asarray(a) == np.asarray(b))
         for a, b in zip(int8_streams, bf16_streams)]))
    gc.collect()
    torch.cuda.empty_cache()

    def referee(fault=None):
        with fault if fault is not None else nullcontext():
            eng, _ = serve_engine(m, draft_model=m, spec_k=SPEC_K,
                                  draft_kv_dtype="int8")
            streams, secs = serve_traffic(eng, wave)
        out = {"accept_rate": eng.metrics.snapshot()["accept_rate"],
               "tokens_per_dispatch":
               eng.metrics.snapshot()["tokens_per_dispatch"],
               "seconds": secs, "compiled_counts":
               eng.spec_compiled_counts(), **vs_plain(streams, expect)}
        eng.close()
        return out
    sound = referee()
    planted = referee(scales_dropped())
    gc.collect()
    torch.cuda.empty_cache()

    # quantize_kv on the card against the CPU, bitwise
    rng = np.random.RandomState(3)
    quant = {}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(rng.randn(8, 32, 8, 128).astype(np.float32)
                             * rng.uniform(0.01, 50, (8, 32, 1, 1))
                             .astype(np.float32)).to(dt)
        cq, cs = kv_cache.quantize_kv(x)
        gq, gs = kv_cache.quantize_kv(x.cuda())
        quant[str(dt).split(".")[1]] = bool(
            torch.equal(gq.cpu(), cq) and torch.equal(gs.cpu(), cs))

    with_spill, third = spill_waves(m, prompts, True)
    without, third_plain = spill_waves(m, prompts, False)
    faulty, third_faulty = spill_waves(m, prompts, True,
                                       misplaced_restore(SPILL_POOL))
    launches = fa.device_launches()
    result = {
        "phase": "mem", "config": "LlamaConfig.base()",
        "param_dtype": "bfloat16",
        "equal_bytes": {"arena_bytes": ctx["arena_bytes"],
                        "num_slots": INT8_SLOTS, "requests": len(twice),
                        "share_prefix": False,
                        "int8": int8, "bf16": bf16},
        "referee": {"spec_k": SPEC_K, "draft_kv_dtype": "int8",
                    "min_accept_rate": REFEREE_MIN_ACCEPT,
                    "sound": sound, "scales_dropped": planted},
        "quantize_kv_card_equals_cpu": quant,
        "spill": {"num_blocks": SPILL_POOL, "with_spill": with_spill,
                  "without_spill": without,
                  "third_wave_equal_without_spill": third == third_plain,
                  "misplaced_restore": {
                      **faulty, "third_wave_equal_without_spill":
                      third_faulty == third_plain}},
        "flash_launches": launches,
        "restore_compiled_count_max": mem.restore_compiled_count(),
        "phase_seconds": time.perf_counter() - t0,
    }
    emit(result)
    check(int8["arena_bytes"] <= ctx["arena_bytes"]
          and bf16["arena_bytes"] <= ctx["arena_bytes"]
          and int8["compiled_counts"] == (1, 1)
          and bf16["compiled_counts"] == (1, 1),
          f"equal-byte arenas: {result['equal_bytes']}")
    check(all(len(t) == MEM_NEW for t in int8_streams),
          "the int8 engine's streams are short")
    check(int8["peak_concurrency"] > bf16["peak_concurrency"],
          f"the int8 arena holds no more requests than the bf16 one at "
          f"equal bytes: {int8['peak_concurrency']} vs "
          f"{bf16['peak_concurrency']}")
    check(sound["streams_equal"], f"the referee's target streams differ "
          f"from the plain engine's: {sound}")
    check(sound["accept_rate"] >= REFEREE_MIN_ACCEPT,
          f"the int8 draft arena's accept rate {sound['accept_rate']} is "
          f"under {REFEREE_MIN_ACCEPT}")
    check(planted["accept_rate"] < REFEREE_MIN_ACCEPT,
          f"the planted scale fault passes the referee: accept rate "
          f"{planted['accept_rate']}")
    check(all(quant.values()), f"quantize_kv on the card differs from the "
          f"CPU: {quant}")
    check(with_spill["spilled_blocks"] >= SERVE_SYSTEM // SERVE_BLOCK
          and with_spill["prefetch_hits"] >= SERVE_SYSTEM // SERVE_BLOCK,
          f"the spill tier did not spill and restore the system prompt: "
          f"{with_spill}")
    check(with_spill["restore_compiled_count"] <= 1
          and result["restore_compiled_count_max"] <= 1,
          f"the restore program was made more than once: {with_spill}")
    check(third == third_plain, "the third wave's streams differ with the "
          "spill tier")
    check(third_faulty != third_plain, "the misplaced restore leaves the "
          "third wave's streams unchanged")
    check(launches == zero, f"the flash kernels ran {launches} times on "
          f"the mem path")
    return launches


@contextmanager
def _f32_activations(m):
    """`m` computing in f32 (its masters are f32; the card's default
    activation dtype is bf16) while the context is open."""
    dev = m.device
    saved = dev.default_dtype
    dev.default_dtype = torch.float32
    try:
        yield
    finally:
        dev.default_dtype = saved


def beam_tick_ms(sess, n=5):
    """Median over `n` searches of one replayed beam tick's ms: each
    search replays the prefill, then BEAM_N ticks timed together (a
    tick past the last would write past the session's tokens)."""
    times = []
    for _ in range(n):
        sess.graphs["prefill"].replay()
        times.append(_timed(lambda: [sess.graphs["tick"].replay()
                                     for _ in range(BEAM_N)])[1])
    return sorted(times)[n // 2] * 1e3 / BEAM_N


def phase_beam(m):
    """generate_beam on two of the slice phase's prompts (P=1024, N=32,
    num_beams=4, bf16 weights), without and with an eos id: captured
    against eager bitwise, num_beams=1 against greedy generate()
    bitwise, the returned scores against one teacher-forced f32
    forward, and the flash forward's launches per captured call.
    Returns those launches."""
    from singa_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg = m.cfg
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                               (B, P))[:BEAM_B]
    kw = dict(max_new_tokens=BEAM_N, num_beams=BEAM_K,
              param_dtype=torch.bfloat16, return_scores=True)
    runs = {}
    launches = None
    eos = None
    for name in ("no_eos", "eos"):
        e = eos if name == "eos" else None
        eager, eager_scores = m.generate_beam(prompts, use_graph=False,
                                              eos_id=e, **kw)
        m.generate_beam(prompts, eos_id=e, **kw)          # warm-up
        _, capture_s = _timed(lambda: m.generate_beam(prompts, eos_id=e,
                                                      **kw))
        fa.reset_device_launches()
        (out, scores), call_s = _timed(
            lambda: m.generate_beam(prompts, eos_id=e, **kw))
        got = fa.device_launches()
        launches = got if launches is None else launches
        sess = m._gen_sessions[("beam", BEAM_B, BEAM_K, P, P + BEAM_N,
                                torch.bfloat16, e)]
        tick_ms = beam_tick_ms(sess)
        runs[name] = {"eos_id": e, "call_ms": call_s * 1e3,
                      "capture_call_ms": capture_s * 1e3,
                      "tick_ms": tick_ms,
                      "graph_pool_bytes": {n: g.pool_bytes for n, g in
                                           sess.graphs.items()},
                      "launches": got,
                      "captured_equals_eager": bool((out == eager).all()),
                      "scores_equal_eager": bool(
                          (scores == eager_scores).all()),
                      "out": out, "scores": scores}
        if eos is None:
            eos = int(out[0, P + 2])
    # num_beams=1 against greedy generate()
    one = m.generate_beam(prompts, max_new_tokens=BEAM_N, num_beams=1,
                          param_dtype=torch.bfloat16)
    greedy = m.generate(prompts, max_new_tokens=BEAM_N,
                        param_dtype=torch.bfloat16)
    # the returned scores against one teacher-forced f32 forward
    out, scores = runs["no_eos"]["out"], runs["no_eos"]["scores"]
    dev = m.device.torch_device
    with torch.no_grad(), _f32_activations(m), plain_attention():
        ids = torch.as_tensor(out[:, :-1], dtype=torch.int64, device=dev)
        lp = torch.log_softmax(m(ids).float(), dim=-1)
        tgt = torch.as_tensor(out[:, 1:], dtype=torch.int64, device=dev)
        forced = lp.gather(2, tgt[:, :, None])[:, P - 1:, 0].sum(1).cpu()
    forced = forced.numpy()
    rel = np.abs(forced - scores) / np.abs(forced)
    for r in runs.values():
        r.pop("out")
        r["scores"] = [float(x) for x in r.pop("scores")]
    result = {"phase": "beam", "config": "LlamaConfig.base()",
              "param_dtype": "bfloat16", "B": BEAM_B, "num_beams": BEAM_K,
              "P": P, "N": BEAM_N, "runs": runs,
              "one_beam_equals_greedy": bool((one == greedy).all()),
              "scores_vs_teacher_forced_f32": {
                  "forced": [float(x) for x in forced],
                  "max_rel_diff": float(rel.max()),
                  "rtol": BEAM_SCORE_RTOL},
              "phase_seconds": time.perf_counter() - t0}
    emit(result)
    for name, r in runs.items():
        check(r["captured_equals_eager"] and r["scores_equal_eager"],
              f"captured beam search differs from eager ({name})")
        check(r["launches"] == {"flash_fwd": cfg.num_layers,
                                "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
              f"a captured beam call launched {r['launches']} ({name})")
    check(result["one_beam_equals_greedy"],
          "num_beams=1 differs from greedy generate()")
    check(float(rel.max()) <= BEAM_SCORE_RTOL, f"beam scores differ from "
          f"the teacher-forced f32 forward's: {rel.max()}")
    return launches["flash_fwd"]


def _loss_and_grads(m, ids):
    """One step's loss and the gradients of GRAD_NAMES, without an
    update (the path of train_one_batch up to the optimizer)."""
    from singa_tpu_torch import autograd
    from singa_tpu_torch.models.transformer import next_token_loss_fused
    x = torch.as_tensor(ids, device="cuda")
    params = m.get_params()
    names = {id(p): n for n, p in params.items()}
    with autograd.train_mode():
        loss = next_token_loss_fused(m.features(x), m.lm_head, x,
                                     chunk_rows=m.cfg.fused_loss_chunk)
        grads = {names[id(p)]: g for p, g in autograd.backward(loss)
                 if names[id(p)] in GRAD_NAMES}
    for p in params.values():
        p.grad = None
    return loss.item(), grads


def _step_errors(loss, grads, loss_p, g_p):
    """A step's loss and gradients against the plain versions', relative
    (gradients by Frobenius norm), and whether they pass the limits."""
    loss_rel = abs(loss - loss_p) / abs(loss_p)
    grad_rel = {n: ((grads[n] - g_p[n]).norm() / g_p[n].norm()).item()
                for n in GRAD_NAMES}
    return {"loss": loss, "loss_rel_diff": loss_rel,
            "grad_rel_diff": grad_rel,
            "ok": loss_rel <= TRAIN_LOSS_RTOL
            and all(r <= TRAIN_GRAD_RTOL for r in grad_rel.values())}


def _captured_step_errors(m, ids, loss_p, g_p):
    """A fresh captured step (lr 0: eager, warm-up, capture + replay,
    all at the same weights) against the plain versions' loss and
    gradients; the gradients are those the replay left in p.grad."""
    from singa_tpu_torch import graph
    graph.reset_graph()
    x = torch.as_tensor(ids, device="cuda")
    for _ in range(3):
        _, loss = m.train_step(x)
    check(m.graph is not None and m.graph.graph is not None,
          "the third train_step did not capture")
    params = m.get_params()
    return _step_errors(loss.item(), {n: params[n].grad for n in GRAD_NAMES},
                        loss_p, g_p)


def phase_train(fault_libs):
    """LlamaConfig.base() training through the user's entry points:
    set_optimizer, compile, train_step, at B=8 x T=1024, bf16
    activations over f32 masters, the step captured as a CUDA graph."""
    from singa_tpu_torch import device, graph, kernel_check, opt
    from singa_tpu_torch.models import Llama, LlamaConfig
    from singa_tpu_torch.ops import flash_attention as fa

    dev = device.create_device("cuda")
    cfg = dataclasses.replace(LlamaConfig.base(), fused_loss=True)
    m = Llama(cfg, device=dev,
              generator=torch.Generator("cuda").manual_seed(0))
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TB, TT)).astype(np.int32)
    batches = [torch.as_tensor(np.random.RandomState(1 + i).randint(
        0, cfg.vocab_size, (TB, TT)).astype(np.int32), device="cuda")
        for i in range(COMPARE_STEPS)]
    x = torch.as_tensor(ids, device="cuda")
    start = {n: p.detach().cpu() for n, p in m.get_params().items()}

    # the same step on the same weights with the plain versions, with the
    # kernels and with each planted fault in place of a kernel, eagerly
    with plain_attention():
        loss_p, g_p = _loss_and_grads(m, ids)
    sound = _step_errors(*_loss_and_grads(m, ids), loss_p, g_p)
    faulty = {}
    for name in TRAIN_FAULTS:
        swap = (kernel_check.flash_kernel if name in kernel_check.FLASH_FAULTS
                else kernel_check.flash_bwd_kernel)
        with swap(fault_libs[name]):
            faulty[name] = _step_errors(*_loss_and_grads(m, ids), loss_p, g_p)
    # and through a captured step, made afresh for each kernel library
    m.set_optimizer(opt.SGD(lr=0.0))
    m.compile([ids], is_train=True, use_graph=True)
    captured_sound = _captured_step_errors(m, ids, loss_p, g_p)
    with kernel_check.flash_bwd_kernel(fault_libs[CAPTURED_FAULT]):
        captured_fault = _captured_step_errors(m, ids, loss_p, g_p)
    graph.reset_graph()                   # the graph kept the fault's kernels
    del g_p

    # from the same initial weights: eager steps, then captured ones
    runs = {}
    for use_graph in (False, True):
        m.set_params(start)
        m.set_optimizer(opt.SGD(lr=0.01, momentum=0.9))
        m.compile([ids], is_train=True, use_graph=use_graph)
        runs[use_graph] = [m.train_step(b)[1].item() for b in batches]
        if not use_graph:
            torch.cuda.reset_peak_memory_stats()
            eager_times = [_timed(lambda: m.train_step(x))[1]
                           for _ in range(EAGER_TIMED)]
            eager_peak = torch.cuda.max_memory_allocated()
            phase_profile(lambda: m.train_step(x),
                          f"one eager train step, B={TB} T={TT}",
                          {k: cfg.num_layers for k in
                           ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
            for p in m.get_params().values():
                p.grad = None
            gc.collect()
            torch.cuda.empty_cache()
    del start
    compare = [abs(c - e) / abs(e) for c, e in zip(runs[True], runs[False])]
    g = m.get_graph("train")

    # the main path: replays of the captured step on a fixed batch
    torch.cuda.reset_peak_memory_stats()
    fa.reset_device_launches()
    times, per_step, losses = [], [], []
    for _ in range(TRAIN_STEPS):
        before = fa.device_launches()
        (_, loss), t = _timed(lambda: m.train_step(x))
        losses.append(loss.item())
        times.append(t)
        after = fa.device_launches()
        per_step.append([after[k] - before[k] for k in fa.KERNELS])
    launches = fa.device_launches()
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(times)[len(times) // 2]
    eager_s = sorted(eager_times)[len(eager_times) // 2]
    flops = m.flops_per_token(TT) * TB * TT
    peak_flops = PEAK_FLOPS[torch.bfloat16]
    result = {
        "phase": "train", "config": "LlamaConfig.base(), fused_loss=True",
        "optimizer": "SGD(lr=0.01, momentum=0.9)", "params": m.num_params(),
        "B": TB, "T": TT, "captured": g.graph is not None,
        "capture_s": g.capture_seconds, "graph_num_ops": g.num_ops,
        "graph_flops": g.flops(), "graph_pool_bytes": g.pool_bytes,
        "graph_launches": g.launches,
        "timed_steps": TRAIN_STEPS, "step_ms": [t * 1e3 for t in times],
        "median_step_ms": step_s * 1e3, "tokens_per_s": TB * TT / step_s,
        "flops_per_step": flops, "mfu": flops / step_s / peak_flops,
        "peak_memory_bytes": peak,
        "reserved_bytes": torch.cuda.memory_reserved(),
        "losses": losses, "launches": launches,
        "launches_per_step": per_step, "expected_per_step": cfg.num_layers,
        "eager": {"step_ms": [t * 1e3 for t in eager_times],
                  "median_step_ms": eager_s * 1e3,
                  "tokens_per_s": TB * TT / eager_s,
                  "mfu": flops / eager_s / peak_flops,
                  "peak_memory_bytes": eager_peak},
        "eager_vs_captured": {"eager_losses": runs[False],
                              "captured_losses": runs[True],
                              "rel_diff": compare,
                              "bitwise": runs[False] == runs[True],
                              "loss_rtol": TRAIN_LOSS_RTOL},
        "kernel_vs_plain": {**sound, "loss_plain": loss_p,
                            "loss_rtol": TRAIN_LOSS_RTOL,
                            "grad_rtol": TRAIN_GRAD_RTOL},
        "faults_vs_plain": faulty,
        "captured_vs_plain": captured_sound,
        "captured_fault_vs_plain": {CAPTURED_FAULT: captured_fault},
    }
    emit(result)
    check(result["captured"], "train_step did not run a captured graph")
    check(g.launches == {k: cfg.num_layers for k in launches},
          f"the train graph holds {g.launches}")
    check(all(s == [cfg.num_layers] * 3 for s in per_step),
          f"flash kernels launched {per_step} times per step, expected "
          f"{cfg.num_layers} each")
    check(max(compare) <= TRAIN_LOSS_RTOL,
          f"captured losses {runs[True]} differ from eager {runs[False]}")
    check(np.isfinite(losses).all(), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(p.dtype == torch.float32 for p in m.get_params().values()),
          "masters are not f32")
    check(sound["ok"], f"loss or gradients with the kernels differ from "
          f"plain ({loss_p}): {sound}")
    check(captured_sound["ok"], f"the captured step differs from plain: "
          f"{captured_sound}")
    missed = [n for n in TRAIN_FAULTS if faulty[n]["ok"]]
    check(not missed, f"planted faults pass the step's limits: {missed}")
    check(not captured_fault["ok"], f"{CAPTURED_FAULT} passes the step's "
          f"limits through a captured step: {captured_fault}")
    phase_profile(lambda: m.train_step(x),
                  f"one replayed train step, B={TB} T={TT}",
                  {k: cfg.num_layers for k in launches})
    return launches


def phase_checkpoint():
    """Save after step CKPT_SAVE_AFTER of a captured run, load into a
    fresh model, run the remaining steps: the losses must equal the
    uninterrupted run's.  LlamaConfig.base() at its widths, cut to
    CKPT_LAYERS layers."""
    from singa_tpu_torch import device, opt
    from singa_tpu_torch.models import Llama, LlamaConfig

    dev = device.create_device("cuda")
    cfg = dataclasses.replace(LlamaConfig.base(), fused_loss=True,
                              num_layers=CKPT_LAYERS)
    rng = np.random.RandomState(11)
    batches = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (TB, TT))
                               .astype(np.int32), device="cuda")
               for _ in range(CKPT_STEPS)]
    path = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt.npz"

    def model(seed):
        m = Llama(cfg, device=dev,
                  generator=torch.Generator("cuda").manual_seed(seed))
        m.set_optimizer(opt.SGD(lr=0.01, momentum=0.9))
        m.compile([batches[0]], is_train=True, use_graph=True)
        return m

    m = model(0)
    whole = []
    for i, b in enumerate(batches):
        whole.append(m.train_step(b)[1].item())
        if i + 1 == CKPT_SAVE_AFTER:
            _, save_s = _timed(lambda: m.save_states(str(path)))
    del m
    gc.collect()
    torch.cuda.empty_cache()
    m = model(1)
    try:
        _, load_s = _timed(lambda: m.load_states(str(path)))
        file_bytes = path.stat().st_size
    finally:
        path.unlink()
    resumed = [m.train_step(b)[1].item() for b in batches[CKPT_SAVE_AFTER:]]
    rel = [abs(r - w) / abs(w) for r, w in zip(resumed,
                                                whole[CKPT_SAVE_AFTER:])]
    emit({"phase": "checkpoint",
          "config": f"LlamaConfig.base(), fused_loss=True, num_layers="
                    f"{CKPT_LAYERS}", "params": m.num_params(),
          "saved_after_step": CKPT_SAVE_AFTER, "file_bytes": file_bytes,
          "save_s": save_s, "load_s": load_s,
          "uninterrupted_losses": whole, "resumed_losses": resumed,
          "rel_diff": rel, "bitwise": resumed == whole[CKPT_SAVE_AFTER:],
          "loss_rtol": TRAIN_LOSS_RTOL,
          "resumed_captured": m.graph.graph is not None})
    check(max(rel) <= TRAIN_LOSS_RTOL,
          f"resumed losses {resumed} differ from {whole}")
    check(m.graph.graph is not None, "the resumed run did not capture")


def _kernel_kind(name):
    low = name.lower()
    for kind in ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd"):
        if kind + "_" in low:
            return kind
    if any(s in low for s in ("gemm", "cutlass", "nvjet", "xmma", "gemv")):
        return "matmul"
    return "other"


def phase_profile(fn, what, expect):
    """Where one call's time goes on the card: device time of every
    kernel under torch.profiler, by kind, against the wall time of the
    same (profiled) call, the host's idle share of the card, and each
    hand-written kernel's launches, which must be `expect`: as the
    kernels counted them on the card, and by name in the profile.  A
    profiler that records no device time reports "not measured" for the
    times and the names instead of failing the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from singa_tpu_torch.ops import flash_attention as fa

    fa.reset_device_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = fa.device_launches()
    counted = {k: counted[k] for k in expect}
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    by_kind, count = {}, {}
    for name, (ms, n) in by_name.items():
        kind = _kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        count[kind] = count.get(kind, 0) + n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    seen = {k: count.get(k, 0) for k in expect}
    emit({"phase": "profile", "what": what,
          "wall_ms_profiled": wall_ms,
          "device_busy_ms": busy_ms if busy_ms else "not measured",
          "device_busy_share": busy_ms / wall_ms if busy_ms
          else "not measured",
          "host_idle_ms": wall_ms - busy_ms if busy_ms else "not measured",
          "device_ms_by_kind": by_kind, "kernels_by_name": seen,
          "kernels_counted_on_card": counted, "expected_kernels": expect,
          "top_kernels": [{"name": k[:90], "ms": v[0], "count": v[1]}
                          for k, v in top]})
    check(counted == expect, f"the kernels counted {counted} launches in "
          f"{what}, expected {expect}")
    if busy_ms:
        check(seen == expect, f"the profile of {what} saw {seen} launches "
              f"of the hand-written kernels, expected {expect}")


def _bound(flops, nbytes):
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_timing():
    """Each kernel, its plain version and the PyTorch call computing the
    same function (a yardstick the port never calls), beside the card's
    bound, at the training shape; the forward also at the prefill
    shape.  Each kernel is also held against its plain version on the
    inputs it is timed on."""
    import torch.nn.functional as F
    from singa_tpu_torch import kernel_check
    from singa_tpu_torch.ops import flash_attention as fa

    h, k, d = 16, 8, 128
    dtype = torch.bfloat16
    scale = 1.0 / d ** 0.5

    def library(timed):
        try:
            return timed()
        except (TypeError, RuntimeError) as e:    # no enable_gqa in torch
            print(f"library yardstick unavailable: {e}", file=sys.stderr)
            return None

    rows = []
    for b, shape in ((B, "prefill"), (TB, "train")):
        q, kk, v = kernel_check.make_qkv(b, P, P, h, k, d, dtype, seed=1)
        pairs = P * (P + 1) // 2                  # causal (q, k) pairs
        t_bytes = q.numel() * q.element_size()    # one (B, T, H, D) tensor
        kv_bytes = kk.numel() * kk.element_size()
        row_bytes = b * h * P * 4                 # one (B, H, T) f32
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        o, lse = fa._flash_fwd_cuda(q, kk, v, True, scale)
        errs = kernel_check.flash_errors(
            o, lse, *fa._flash_fwd_reference(q, kk, v, True, scale), dtype)

        def kernel():
            return fa._flash_fwd_cuda(q, kk, v, True, scale)
        rows.append({
            "name": "flash_fwd", "shape": shape, "timed_by": "cuda_graph",
            "ms": graph_time_ms(kernel),
            "events_ms": cuda_time_ms(kernel),
            "host_us_per_call": host_time_us(kernel),
            "plain_ms": graph_time_ms(
                lambda: fa._flash_fwd_reference(q, kk, v, True, scale),
                reps=2, replays=5),
            "library_ms": library(lambda: graph_time_ms(sdpa)),
            "library_covers": ["flash_fwd"],
            "max_abs_err": errs["max_abs_do"], "ok": errs["ok"],
            **_bound(4 * b * h * d * pairs,
                     2 * t_bytes + 2 * kv_bytes + row_bytes)})
        if shape != "train":
            continue
        g = torch.Generator("cuda").manual_seed(2)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
        args = (q, kk, v, do, lse, delta.contiguous(), True, scale)
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
        og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                            enable_gqa=True)
        dot = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(og, (qg, kg, vg), dot,
                                       retain_graph=True)
        lib_bwd = library(lambda: cuda_time_ms(sdpa_bwd))
        # one SDPA backward computes dq, dk and dv: its time is both rows'
        both = ["flash_bwd_dq", "flash_bwd_dkv"]
        errs = kernel_check.flash_bwd_errors(
            (fa._launch_dq(*args), *fa._launch_dkv(*args)),
            fa._flash_bwd_reference(*args), dtype)

        def dq_kernel():
            return fa._launch_dq(*args)

        def dkv_kernel():
            return fa._launch_dkv(*args)
        rows.append({
            "name": "flash_bwd_dq", "shape": shape, "timed_by": "cuda_graph",
            "ms": graph_time_ms(dq_kernel),
            "events_ms": cuda_time_ms(dq_kernel),
            "host_us_per_call": host_time_us(dq_kernel),
            "plain_ms": cuda_time_ms(lambda: fa._bwd_dq_reference(*args),
                                     iters=10),
            "library_ms": lib_bwd, "library_covers": both,
            "max_abs_err": errs["max_abs_dq"], "ok": errs["ok"],
            **_bound(6 * b * h * d * pairs,
                     3 * t_bytes + 2 * kv_bytes + 2 * row_bytes)})
        rows.append({
            "name": "flash_bwd_dkv", "shape": shape, "timed_by": "cuda_graph",
            "ms": graph_time_ms(dkv_kernel),
            "events_ms": cuda_time_ms(dkv_kernel),
            "host_us_per_call": host_time_us(dkv_kernel),
            "plain_ms": cuda_time_ms(lambda: fa._bwd_dkv_reference(*args),
                                     iters=10),
            "library_ms": lib_bwd, "library_covers": both,
            "max_abs_err": max(errs["max_abs_dk"], errs["max_abs_dv"]),
            "ok": errs["ok"],
            **_bound(8 * b * h * d * pairs,
                     2 * t_bytes + 4 * kv_bytes + 2 * row_bytes)})
    for r in rows:
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        emit({"phase": "timing", "dims": [B if r["shape"] == "prefill"
                                          else TB, P, h, k, d],
              "dtype": "bfloat16", "causal": True, **r})
    bad = [f"{r['name']}:{r['shape']}" for r in rows if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions on the "
          f"timed inputs: {bad}")
    return rows


# each kernel: its source and the TPU kernel it replaces
KERNELS = {
    "flash_fwd": ("singa_tpu_torch/csrc/flash_fwd.cu",
                  "singa_tpu/ops/flash_attention.py:59"),
    "flash_bwd_dq": ("singa_tpu_torch/csrc/flash_bwd.cu",
                     "singa_tpu/ops/flash_attention.py:116"),
    "flash_bwd_dkv": ("singa_tpu_torch/csrc/flash_bwd.cu",
                      "singa_tpu/ops/flash_attention.py:159"),
}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; the port's serving "
              "and training paths need a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import singa_tpu_torch  # noqa: F401  (fails without the repository)
    t0 = time.perf_counter()
    wall = {}

    def timed_phase(name, fn, *args):
        """fn(*args) with its wall seconds noted, then the card's cache
        emptied for the next phase."""
        t = time.perf_counter()
        out = fn(*args)
        wall[name] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        return out

    name = phase_card()
    with tempfile.TemporaryDirectory() as tmp:
        faults = timed_phase("build", phase_build, Path(tmp))
        timed_phase("kernels", phase_kernels)
        timed_phase("faults", phase_faults, faults)
    gen_launches, m = timed_phase("slice", phase_slice)
    serve_launches, serve_requests, serve_ctx = timed_phase(
        "serve", phase_serve, m)
    spec_launches, spec_requests = timed_phase("spec", phase_spec, m,
                                               serve_ctx)
    mem_launches = timed_phase("mem", phase_mem, m, serve_ctx)
    beam_launches = timed_phase("beam", phase_beam, m)
    del m, serve_ctx
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = timed_phase("train", phase_train, faults)
    timed_phase("checkpoint", phase_checkpoint)
    rows = timed_phase("timing", phase_timing)
    kernels = []
    for r in rows:
        if r["shape"] != "train":
            continue
        source, replaces = KERNELS[r["name"]]
        by_path = {"train": {"launches": train_launches[r["name"]],
                             "steps": TRAIN_STEPS,
                             "per_step": train_launches[r["name"]]
                             / TRAIN_STEPS}}
        if r["name"] == "flash_fwd":
            by_path["generate"] = {"launches": gen_launches, "calls": 1,
                                   "per_call": gen_launches}
        by_path["serve"] = {"launches": serve_launches[r["name"]],
                            "requests": serve_requests}
        by_path["spec"] = {"launches": spec_launches[r["name"]],
                           "requests": spec_requests}
        by_path["mem"] = {"launches": mem_launches[r["name"]]}
        if r["name"] == "flash_fwd":
            by_path["beam"] = {"launches": beam_launches, "calls": 1,
                               "per_call": beam_launches}
        kernels.append({
            "name": r["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[r["name"]],
            "launches_by_path": by_path, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_covers": r["library_covers"],
            "timed_by": r["timed_by"]})
    emit({"phase": "end", "script_seconds": time.perf_counter() - t0,
          "phase_wall_s": wall})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
