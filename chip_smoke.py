#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (singa_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. card    — name and power limit (nvidia-smi), torch's device name/count
  2. build   — compile every kernel of the serving path from
               singa_tpu_torch/csrc (nvcc, sm_90a), and each planted fault
               from a copy of its source in a temporary directory, all in
               parallel; show ptxas's register / shared-memory report
  3. kernels — each kernel against its plain PyTorch version on the card,
               over the cases and limits of singa_tpu_torch/kernel_check.py
  4. faults  — each planted fault must fail those limits on its case
  5. slice   — Llama(LlamaConfig.base()).generate() at B=4, P=1024, N=32,
               bf16 weights: the flash kernel must launch once per layer per
               call; prefill logits with the kernel vs with its plain
               version; prefill ms, decode ms/token, tokens/s, peak memory
  6. timing  — the kernel, its plain version and PyTorch's
               scaled_dot_product_attention (a yardstick the port never
               calls) at the slice's shape, beside the card's bound
Then one {"kernels": [...]} line and, last, the device line.

Weights and inputs are random, drawn from fixed seeds.  The script needs
the repository beside it and a CUDA card; without either it fails.
"""

import json
import subprocess
import sys
import tempfile
import time
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


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_time_ms(fn, iters=50, warmup=5):
    """Mean device time of fn() over `iters` back-to-back calls."""
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
    """Build the kernel and, from copies of its source in `tmp`, each of
    its planted faults: one nvcc per source, all started together."""
    from singa_tpu_torch import _build, kernel_check
    srcs = [_build.source_path("flash_fwd")]
    for name in kernel_check.FLASH_FAULTS:
        srcs.append(tmp / f"{name}.cu")
        srcs[-1].write_text(kernel_check.flash_fault_source(name))
    t0 = time.perf_counter()
    built = _build.build(srcs)
    ptxas = [ln.strip() for ln in built[0].log.splitlines()
             if "registers" in ln or "spill" in ln
             or "Compiling entry function" in ln]
    emit({"phase": "build", "kernel": "flash_fwd",
          "source": "singa_tpu_torch/csrc/flash_fwd.cu",
          "nvcc_seconds": {b.path.name: round(b.seconds, 2) for b in built},
          "wall_seconds": round(time.perf_counter() - t0, 2),
          "ptxas": ptxas})
    return dict(zip(kernel_check.FLASH_FAULTS, (b.lib for b in built[1:])))


def phase_kernels():
    from singa_tpu_torch import kernel_check
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for label in kernel_check.FLASH_CASES:
            errs = kernel_check.check_flash(label, dtype)
            results.append({"case": label, "dtype": str(dtype)[6:], **errs})
    emit({"phase": "kernels", "cases": results})
    bad = [r["case"] + "/" + r["dtype"] for r in results if not r["ok"]]
    check(not bad, f"flash kernel disagrees with its plain version: {bad}")
    return {r["dtype"]: r for r in results if r["case"] == "slice"}


def phase_faults(libs):
    """Each planted fault, built from a copy of the kernel's source, must
    fail the limits that the kernel passes."""
    from singa_tpu_torch import kernel_check
    results = []
    for name, lib in libs.items():
        label = kernel_check.FLASH_FAULTS[name][0]
        with kernel_check.flash_kernel(lib):
            errs = kernel_check.check_flash(label, torch.bfloat16)
        results.append({"fault": name, "case": label, "dtype": "bfloat16",
                        **errs, "caught": not errs["ok"]})
    emit({"phase": "faults", "faults": results})
    missed = [r["fault"] for r in results if not r["caught"]]
    check(not missed, f"planted faults pass the kernel's limits: {missed}")


class plain_attention:
    """Route the flash wrapper to its plain version for a comparison run
    (the serving path itself never does this)."""

    def __enter__(self):
        from singa_tpu_torch.ops import flash_attention as fa
        self.fa, self.saved = fa, fa._flash_fwd_cuda
        fa._flash_fwd_cuda = fa._flash_fwd_reference

    def __exit__(self, *exc):
        self.fa._flash_fwd_cuda = self.saved


def phase_slice():
    from singa_tpu_torch import device
    from singa_tpu_torch.models import Llama, LlamaConfig
    from singa_tpu_torch.models import _generate
    from singa_tpu_torch.ops import flash_attention as fa

    dev = device.create_device("cuda")
    cfg = LlamaConfig.base()
    t0 = time.perf_counter()
    m = Llama(cfg, device=dev,
              generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, P))
    kw = dict(max_new_tokens=N, param_dtype=torch.bfloat16)

    fa.launches = 0
    m.generate(prompts, **kw)                      # warm call
    warm_launches = fa.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.launches = 0                                # the main path's run
    t0 = time.perf_counter()
    out = m.generate(prompts, **kw)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()

    # prefill alone, and its logits with the kernel vs the plain version
    ids = torch.as_tensor(prompts, dtype=torch.int32, device="cuda")
    _, _, _, S, params = m._gen_setup(prompts, N, torch.bfloat16)
    with torch.no_grad(), _generate._bound(m, params):
        prefill = _generate.prefill_step(m, S)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg_kernel, _ = prefill(ids)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        prefill_ms = sorted(times)[len(times) // 2] * 1e3
        with plain_attention():
            lg_plain, _ = prefill(ids)
    with plain_attention():
        out_plain = m.generate(prompts, **kw)
    lg_kernel, lg_plain = lg_kernel.float(), lg_plain.float()
    dlogit = (lg_kernel - lg_plain).abs().max().item()
    ref_max = lg_plain.abs().max().item()
    agree = float((out[:, P:] == out_plain[:, P:]).mean())

    # generate = prefill + N - 1 decode steps (the last pick needs none)
    decode_ms = (gen_s * 1e3 - prefill_ms) / (N - 1)
    result = {
        "phase": "slice", "config": "LlamaConfig.base()",
        "params": m.num_params(), "B": B, "P": P, "N": N,
        "param_dtype": "bfloat16", "model_build_s": build_s,
        "warm_launches": warm_launches, "launches": launches,
        "expected_launches": cfg.num_layers,
        "generate_ms": gen_s * 1e3, "prefill_ms": prefill_ms,
        "decode_ms_per_token": decode_ms,
        "tokens_per_s": B * N / gen_s,
        "peak_memory_bytes": peak,
        "prefill_logits_max_abs_diff": dlogit,
        "prefill_logits_max_abs": ref_max,
        "logit_rtol": LOGIT_RTOL,
        "greedy_token_agreement_vs_plain": agree,
    }
    emit(result)
    check(warm_launches == cfg.num_layers and launches == cfg.num_layers,
          f"flash kernel launched {warm_launches}/{launches} times per "
          f"generate, expected {cfg.num_layers}")
    check(out.shape == (B, P + N) and out.dtype == np.int32,
          f"generate returned {out.shape} {out.dtype}")
    check((out[:, :P] == prompts).all(), "prompt not echoed")
    check(((out >= 0) & (out < cfg.vocab_size)).all(), "token out of range")
    check(np.isfinite(lg_kernel.cpu().numpy()).all(), "non-finite logits")
    check(dlogit <= LOGIT_RTOL * ref_max,
          f"prefill logits differ by {dlogit} (max |logit| {ref_max})")
    phase_profile(lambda: m.generate(prompts, **kw))
    return launches


def _kernel_kind(name):
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_fwd"
    if any(s in low for s in ("gemm", "cutlass", "nvjet", "xmma", "gemv")):
        return "matmul"
    return "other"


def phase_profile(fn):
    """Where one generate call's time goes on the card: device time of
    every kernel under torch.profiler, by kind, against the wall time
    of the same (profiled) call.  Informational: a profiler that records
    no device time reports "not measured" instead of failing the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    by_kind = {}
    for name, (ms, _) in by_name.items():
        kind = _kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "profile", "what": "one generate call, B=4 P=1024 N=32",
          "wall_ms_profiled": wall_ms,
          "device_busy_ms": busy_ms if busy_ms else "not measured",
          "device_busy_share": busy_ms / wall_ms if busy_ms
          else "not measured",
          "device_ms_by_kind": by_kind,
          "top_kernels": [{"name": k[:90], "ms": v[0], "count": v[1]}
                          for k, v in top]})


def phase_timing(slice_err):
    import torch.nn.functional as F
    from singa_tpu_torch import kernel_check
    from singa_tpu_torch.ops import flash_attention as fa

    h, k, d = 16, 8, 128
    dtype = torch.bfloat16
    q, kk, v = kernel_check.make_qkv(B, P, P, h, k, d, dtype, seed=1)
    scale = 1.0 / d ** 0.5
    ms = cuda_time_ms(lambda: fa._flash_fwd_cuda(q, kk, v, True, scale))
    plain_ms = cuda_time_ms(
        lambda: fa._flash_fwd_reference(q, kk, v, True, scale), iters=10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    try:
        library_ms = cuda_time_ms(library)
    except (TypeError, RuntimeError) as e:        # no enable_gqa in torch
        print(f"library yardstick unavailable: {e}", file=sys.stderr)
        library_ms = None

    pairs = P * (P + 1) // 2                      # causal (q, k) pairs
    flops = 4 * B * h * d * pairs                 # QK^T and P V
    nbytes = (q.numel() + kk.numel() + v.numel() + q.numel()) \
        * q.element_size() + B * h * P * 4        # + lse
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    res = {"phase": "timing", "shape": [B, P, h, k, d], "dtype": "bfloat16",
           "causal": True, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "flops": flops, "bytes": nbytes,
           "bound_ms": bound_ms,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "share_of_bound": bound_ms / ms,
           "max_abs_err": slice_err}
    emit(res)
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; the port's serving "
              "path needs a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import singa_tpu_torch  # noqa: F401  (fails without the repository)
    name = phase_card()
    with tempfile.TemporaryDirectory() as tmp:
        faults = phase_build(Path(tmp))
        slice_case = phase_kernels()["bfloat16"]
        phase_faults(faults)
    launches = phase_slice()
    t = phase_timing(slice_case["max_abs_do"])
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "singa_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "singa_tpu/ops/flash_attention.py:59",
        "launches": launches, "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
