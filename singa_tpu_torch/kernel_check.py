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
           "flash_kernel"]

# label: (B, Tq, Tk, H, K, D, causal, window) -- the cases of
# tests/test_flash.py, head dims 40 (padded) and 256, and the slice's
# prefill shape
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
    "slice": (4, 1024, 1024, 16, 8, 128, True, None),
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

# name: (case, text of csrc/flash_fwd.cu, its faulty replacement)
FLASH_FAULTS = {
    # P V reads V rows of keys 2, 3 for keys 0, 1 (and so on) in each tile
    "pv_swapped_v_rows": (
        "slice",
        "const bf16* vrow = Vs + (ks * 16 + tig * 2) * LDS + g;",
        "const bf16* vrow = Vs + (ks * 16 + (tig ^ 1) * 2) * LDS + g;"),
    # rows of the later half drop 16 keys of the first tile from P V
    "pv_drops_late_keys": (
        "slice",
        "for (int ks = 0; ks < kBN / 16; ++ks) {",
        "for (int ks = 0; ks < kBN / 16 - (q0 >= p.Tq / 2 && k0 == 0); "
        "++ks) {"),
    # the window lets one key too many through
    "window_one_key_wide": (
        "window256",
        "if (p.window > 0) ok = ok && (kj > qpos - p.window);",
        "if (p.window > 0) ok = ok && (kj >= qpos - p.window);"),
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


def flash_fault_source(name) -> str:
    """csrc/flash_fwd.cu with planted fault `name`."""
    _, old, new = FLASH_FAULTS[name]
    src = _build.source_path("flash_fwd").read_text()
    if src.count(old) != 1:
        raise ValueError(f"planted fault {name}: the text it replaces is "
                         f"not once in flash_fwd.cu; update FLASH_FAULTS")
    return src.replace(old, new)


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
