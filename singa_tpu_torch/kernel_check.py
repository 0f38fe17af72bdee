"""The port's kernels against their plain versions, on the card.

One table of cases and one set of limits, shared by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``.  Beside them, planted faults: one-line
changes to a kernel's source, each of the kind a wrong kernel could
carry unseen.  Built from a copy of the source, each must fail the
limits on its case; that shows the limits are tight enough to catch it.
"""

from __future__ import annotations

import contextlib

import torch

from . import _build
from .ops import flash_attention as fa

__all__ = ["FLASH_CASES", "FLASH_FAULTS", "O_ROW_RTOL", "LSE_ATOL",
           "make_qkv", "flash_errors", "check_flash", "flash_fault_source",
           "flash_kernel", "FLASH_BWD_FAULTS", "GRAD_ROW_RTOL", "ROW_FLOOR",
           "flash_bwd_errors", "bwd_inputs", "check_flash_bwd",
           "flash_bwd_fault_source", "flash_bwd_kernel",
           "bwd_repeats_bitwise"]

# label: (B, Tq, Tk, H, K, D, causal, window) -- the cases of
# tests/test_flash.py, head dims 40 (padded) and 256, edges that fall
# inside a 128-key tile (a window's lower edge at D=128, and the causal
# diagonal with Tq < Tk at Llama's G=2), and the shapes of
# LlamaConfig.base() at prefill (B=4) and in training (B=8)
FLASH_CASES = {
    "mha_noncausal_d64": (2, 512, 512, 4, 4, 64, False, None),
    "mha_causal_d64": (2, 512, 512, 4, 4, 64, True, None),
    "gqa_causal_d128": (2, 512, 512, 8, 2, 128, True, None),
    "gqa_noncausal_d128": (1, 256, 256, 8, 4, 128, False, None),
    "tq128_tk512_causal": (2, 128, 512, 4, 2, 64, True, None),
    "tq128_tk512_noncausal": (2, 128, 512, 4, 2, 128, False, None),
    "window256": (1, 1024, 1024, 4, 2, 64, True, 256),
    "d40_padded": (1, 256, 256, 2, 1, 40, True, None),
    "d256": (1, 256, 256, 2, 2, 256, True, None),
    "window200_d128": (1, 1024, 1024, 8, 2, 128, True, 200),
    "tq512_tk1024_causal_d128": (1, 512, 1024, 16, 8, 128, True, None),
    "slice": (4, 1024, 1024, 16, 8, 128, True, None),
    "train": (8, 1024, 1024, 16, 8, 128, True, None),
}

# Limits (readings in PERF.md).  o: the largest relative error of one
# output row, max over (b, t, h) of |o - o_plain| / |o_plain| (2-norms
# over the head dim) -- scale-free, so a fault confined to a few rows
# shows at full size.  f32 differs from the plain version only in
# summation order; bf16 also in where p is rounded (after the running
# max, not the row max) and in o's final rounding to bf16.  lse is f32
# from f32 scores in both.
O_ROW_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LSE_ATOL = 1e-4

# name: (case, text of csrc/flash_fwd.cu, its faulty replacement); each
# plants the fault in the bf16 kernel, which the faults phase runs
FLASH_FAULTS = {
    # P V reads the V rows of keys 16-31 for keys 0-15 (and so on) in
    # each tile
    "pv_swapped_v_rows": (
        "slice",
        "const uint32_t vk = vt + kk * 16 * 128;",
        "const uint32_t vk = vt + (kk ^ 1) * 16 * 128;"),
    # rows of the later half drop 16 keys of the first tile from P V
    "pv_drops_late_keys": (
        "slice",
        "for (int ks = 0; ks < T::kKeys / 16; ++ks) {",
        "for (int ks = 0; ks < T::kKeys / 16; ++ks) { "
        "if (ks == 0 && k0 == 0 && q0 >= p.Tq / 2) { "
        "pa[0][0] = pa[0][1] = pa[0][2] = pa[0][3] = 0u; continue; }"),
    # the window lets one key too many through
    "window_one_key_wide": (
        "window256",
        "lo[r] = p.window > 0 ? rel - p.window : INT_MIN;",
        "lo[r] = p.window > 0 ? rel - p.window - 1 : INT_MIN;"),
    # the consumers read the ring stage after the one whose "full"
    # barrier they waited on
    "ring_reads_next_stage": (
        "train",
        "const uint32_t kt = ring + stage * T::kStageBytes;",
        "const uint32_t kt = ring + (stage + 1) % kS * T::kStageBytes;"),
}


def make_qkv(b, tq, tk, h, k, d, dtype, seed):
    """(B, T, H, D) q, k, v on the card, N(0, 0.3^2) as tests/test_flash.py
    makes them."""
    g = torch.Generator("cuda").manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.3).to(dtype)
    return rnd(b, tq, h, d), rnd(b, tk, k, d), rnd(b, tk, k, d)


def flash_errors(o, lse, ro, rl, dtype):
    """Errors of (o, lse) against the plain version's (ro, rl), and
    whether they are within the limits for `dtype`."""
    do = o.float() - ro.float()
    row_rel = (do.norm(dim=-1) / ro.float().norm(dim=-1)).max().item()
    dl = (lse - rl).abs().max().item()
    return {"max_row_rel_do": row_rel, "max_abs_do": do.abs().max().item(),
            "max_abs_dlse": dl, "rtol_o": O_ROW_RTOL[dtype],
            "atol_lse": LSE_ATOL,
            "ok": row_rel <= O_ROW_RTOL[dtype] and dl <= LSE_ATOL}


def check_flash(label, dtype):
    """Launch the kernel once on case `label` and hold it against its
    plain version on the same inputs."""
    b, tq, tk, h, k, d, causal, window = FLASH_CASES[label]
    q, kk, v = make_qkv(b, tq, tk, h, k, d, dtype, seed=len(label))
    scale = d ** -0.5
    o, lse = fa._flash_fwd_cuda(q, kk, v, causal, scale, window)
    ro, rl = fa._flash_fwd_reference(q, kk, v, causal, scale, window)
    return flash_errors(o, lse, ro, rl, dtype)


def _fault_source(kernel, faults, name) -> str:
    _, old, new = faults[name]
    src = _build.source_path(kernel).read_text()
    if src.count(old) != 1:
        raise ValueError(f"planted fault {name}: the text it replaces is "
                         f"not once in {kernel}.cu; update the fault table")
    return src.replace(old, new)


def flash_fault_source(name) -> str:
    """csrc/flash_fwd.cu with planted fault `name`."""
    return _fault_source("flash_fwd", FLASH_FAULTS, name)


@contextlib.contextmanager
def flash_kernel(lib):
    """Launch the flash kernel of `lib` (a loaded library) in place of
    the built one."""
    saved = fa._fn
    fa._fn = fa.bind(lib)
    try:
        yield
    finally:
        fa._fn = saved


# -- the backward kernels (csrc/flash_bwd.cu) ---------------------------------

# Limits (readings in PERF.md).  Each of dq, dk, dv is held by the largest
# relative error of one row (2-norm over the head dim), where a row's
# norm is floored at ROW_FLOOR times the root-mean-square row norm of
# the plain result: rows whose plain gradient is near zero are held by
# absolute error instead.  f32 differs from the plain version in
# summation order only; bf16 also in bf16 roundings of P and dS that
# fall the other way when a score differs in its last bit, and in the
# final rounding of the outputs.
GRAD_ROW_RTOL = {torch.float32: 5e-5, torch.bfloat16: 1e-2}
ROW_FLOOR = 0.1

# name: (case, text of csrc/flash_bwd.cu, its faulty replacement); each
# plants the fault in the bf16 wgmma kernels, which the faults phase runs
FLASH_BWD_FAULTS = {
    # dQ forgets delta: ds = p * dp * scale
    "dq_drops_delta": (
        "gqa_causal_d128",
        "dp[j] = s[j] * (dp[j] - dl[(j >> 1) & 1]) * p.scale;",
        "dp[j] = s[j] * dp[j] * p.scale;"),
    # dK/dV sums only G - 1 of each group's query heads (the producer and
    # the consumers agree on the shorter walk, so nothing hangs)
    "dkv_skips_last_head": (
        "gqa_causal_d128",
        "t.n = p.H / p.K * t.nq;",
        "t.n = (p.H / p.K - 1) * t.nq;"),
    # dK/dV's causal test drops the diagonal: each query is read one
    # position early
    "dkv_causal_strict": (
        "slice",
        "lo[r] = p.causal ? rel : INT_MIN;",
        "lo[r] = p.causal ? rel + 1 : INT_MIN;"),
    # the dQ consumers read K and V from the ring stage after the one
    # whose "full" barrier they waited on
    "dq_ring_reads_next_stage": (
        "train",
        "const uint32_t kst = ring + stage * T::kStageBytes;",
        "const uint32_t kst = ring + (stage + 1) % kS * T::kStageBytes;"),
    # the dK/dV consumers read lse and delta from the next ring stage
    "dkv_reads_next_stage_rows": (
        "train",
        "const uint32_t lt = qst + 2 * T::kTileBytes;",
        "const uint32_t lt = ring + (stage + 1) % kS * T::kStageBytes"
        " + 2 * T::kTileBytes;"),
}


def _row_error(x, ref) -> float:
    d = (x.float() - ref.float()).norm(dim=-1)
    n = ref.float().norm(dim=-1)
    floor = ROW_FLOOR * n.square().mean().sqrt()
    return (d / torch.maximum(n, floor)).max().item()


def flash_bwd_errors(grads, ref_grads, dtype):
    """Errors of (dq, dk, dv) against the plain version's, and whether
    they are within the limits for `dtype`."""
    errs = {}
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        errs[f"max_row_rel_{name}"] = _row_error(g, r)
        errs[f"max_abs_{name}"] = (g.float() - r.float()).abs().max().item()
    worst = max(errs[f"max_row_rel_{n}"] for n in ("dq", "dk", "dv"))
    return {**errs, "rtol_grad": GRAD_ROW_RTOL[dtype],
            "row_floor": ROW_FLOOR, "ok": worst <= GRAD_ROW_RTOL[dtype]}


def bwd_inputs(label, dtype, dlse=False):
    """q, k, v, do, lse, delta on the card for case `label`: o and lse
    from the forward's plain version, delta = rowsum(do o) - dlse."""
    b, tq, tk, h, k, d, causal, window = FLASH_CASES[label]
    q, kk, v = make_qkv(b, tq, tk, h, k, d, dtype, seed=len(label))
    g = torch.Generator("cuda").manual_seed(len(label) + 100)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    scale = d ** -0.5
    o, lse = fa._flash_fwd_reference(q, kk, v, causal, scale, window)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    if dlse:
        delta = delta - torch.randn(lse.shape, generator=g, device="cuda")
    return q, kk, v, do, lse, delta.contiguous(), causal, scale, window


def check_flash_bwd(label, dtype, dlse=False):
    """Launch the two backward kernels once on case `label` (with a
    nonzero lse cotangent folded into delta when `dlse`) and hold them
    against their plain version on the same inputs."""
    args = bwd_inputs(label, dtype, dlse)
    grads = fa._flash_bwd_cuda(*args)
    ref = fa._flash_bwd_reference(*args)
    return flash_bwd_errors(grads, ref, dtype)


def bwd_repeats_bitwise(label="train"):
    """Launch the two backward kernels twice on case `label` in bf16:
    whether each of dq, dk and dv is bitwise equal between the launches
    (no atomics, so a race in a ring or at a barrier is what would make
    them differ)."""
    args = bwd_inputs(label, torch.bfloat16)
    first = fa._flash_bwd_cuda(*args)
    second = fa._flash_bwd_cuda(*args)
    return {name: torch.equal(a, b)
            for name, a, b in zip(("dq", "dk", "dv"), first, second)}


def flash_bwd_fault_source(name) -> str:
    """csrc/flash_bwd.cu with planted fault `name`."""
    return _fault_source("flash_bwd", FLASH_BWD_FAULTS, name)


@contextlib.contextmanager
def flash_bwd_kernel(lib):
    """Launch the backward kernels of `lib` (a loaded library) in place
    of the built ones."""
    saved = fa._dq_fn, fa._dkv_fn
    fa._dq_fn, fa._dkv_fn = fa.bind_bwd(lib)
    try:
        yield
    finally:
        fa._dq_fn, fa._dkv_fn = saved
