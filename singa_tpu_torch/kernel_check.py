"""The port's kernels against their plain versions, on the card.

One table of cases and one set of limits, shared by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``.  Beside them, planted faults: one-line
changes to a kernel's source, each of the kind a wrong kernel could
carry unseen.  Built from a copy of the source, each must fail the
limits on its case; that shows the limits are tight enough to catch it.
Then what the paths of layer.Remat and the char-rnn are held to on
the card.  Then ring attention's per-rank body over the shards of one
card (``RING_CASES``), with its planted faults (``RING_FAULTS``), and the
multi-axis training step against the plain one (``spmd_vs_plain``).
Last, the pipeline schedule's per-rank body over S stages of one card
with an in-process hop (``PIPE_CASES``, ``LocalPipe``, ``PIPE_FAULTS``)
and the expert-parallel MoE body over ep ranks of one card
(``EP_CASES``).  Then the native core's cases on the card's host: the
threaded loader feeding a captured step (``native_feed``, batch
integrity under ``NATIVE_WORKERS`` threads), the host kernels' MLP
steps against torch's (``native_mlp_losses``) and the scheduler's order
over a traced card step (``schedule_is_topological``).
"""

from __future__ import annotations

import contextlib
import importlib
import time

import torch

from . import _build
from .ops import flash_attention as fa

__all__ = ["FLASH_CASES", "FLASH_FAULTS", "FAULT_ALSO_CASES", "O_ROW_RTOL",
           "LSE_ATOL", "make_qkv", "flash_errors", "check_flash", "flash_fault_source",
           "flash_kernel", "FLASH_BWD_FAULTS", "GRAD_ROW_RTOL", "ROW_FLOOR",
           "flash_bwd_errors", "bwd_inputs", "check_flash_bwd",
           "flash_bwd_fault_source", "flash_bwd_kernel",
           "bwd_repeats_bitwise", "REMAT_LAUNCHES_PER_BLOCK",
           "remat_launches", "CHAR_RNN", "CHAR_RNN_BATCH", "CHAR_RNN_LR",
           "CHAR_RNN_STEPS", "CHAR_RNN_WINDOW", "RING_SHAPE", "RING_CASES",
           "RING_DTYPES", "RING_FAULTS", "ring_launches", "LocalRing",
           "ring_run", "ring_inputs", "ring_errors", "check_ring",
           "ring_fault", "SPMD_AXES", "megatron_forms", "spmd_vs_plain",
           "PIPE_SHAPE", "PIPE_CASES", "PIPE_DTYPES", "PIPE_RTOL",
           "pipe_launches", "LocalPipe", "pipe_run", "seq_run",
           "pipe_errors", "pipe_blocks", "PIPE_FAULTS", "pipe_fault",
           "check_pipe", "EP_TOKENS", "EP_CASES", "EP_DTYPES",
           "EP_ROW_RTOL", "EP_GRAD_RTOL", "ep_inputs", "ep_run",
           "ep_errors", "NATIVE_WORKERS", "NATIVE_PREFETCH",
           "NATIVE_EPOCHS", "NATIVE_MLP_STEPS", "NATIVE_MLP_RTOL",
           "NATIVE_MLP_ATOL", "native_set", "native_feed",
           "native_mlp_losses", "schedule_is_topological"]

# label: (B, Tq, Tk, H, K, D, causal, window) -- the cases of
# tests/test_flash.py, head dims 40 (padded) and 256, edges that fall
# inside a 128-key tile (a window's lower edge at D=128, and the causal
# diagonal with Tq < Tk at Llama's G=2), the shapes of
# LlamaConfig.base() at prefill (B=4) and in training (B=8), Mixtral-
# 8x7B's training shape (32 heads over 8 K/V heads: dK/dV sums groups of
# 4 at T = 1024 causal), GPT-2 124M's training shape (12 heads, no
# grouping, head dim 64, B=8 at T = 1024 causal) and its generate()
# prefill (B=4 at P = 512 causal), and a window where it
# pays (Mistral-7B's W = 4096 at T = 8192; 8 of its 32 heads, a group of
# 4 as Mistral's, so the plain version fits), also with 128 queries
# against the 8192 keys, where the band's lower edge falls inside a
# 128-key tile
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
    "mixtral_train": (4, 1024, 1024, 32, 8, 128, True, None),
    "gpt2_train": (8, 1024, 1024, 12, 12, 64, True, None),
    "gpt2_prefill": (4, 512, 512, 12, 12, 64, True, None),
    "window4096_t8192": (1, 8192, 8192, 8, 2, 128, True, 4096),
    "window_decode_edge": (1, 128, 8192, 8, 2, 128, True, 4096),
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


# planted faults that must also fail the limits on further cases
FAULT_ALSO_CASES = {
    "window_one_key_wide": ("window4096_t8192", "window_decode_edge"),
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


# -- the paths of the model API's last slice -------------------------------------
# layer.Remat: a checkpointed block launches the forward kernel twice a
# step (its forward and its recompute in the backward) and each backward
# kernel once; its step equals the plain step bitwise (the recompute
# applies the forward's dropout masks), so the limit there is equality.
REMAT_LAUNCHES_PER_BLOCK = {"flash_fwd": 2, "flash_bwd_dq": 1,
                            "flash_bwd_dkv": 1}


def remat_launches(num_layers: int):
    """Each kernel's launches in one training step of a model whose
    `num_layers` blocks all run under layer.Remat."""
    return {k: n * num_layers for k, n in REMAT_LAUNCHES_PER_BLOCK.items()}


# the char-rnn (singa_tpu_torch.tools.train_rnn) at the reference
# example's defaults; CHAR_RNN_STEPS steps as a captured graph (the
# captured steps equal eager ones bitwise), its loss falling from the
# first CHAR_RNN_WINDOW steps' mean to the last ones'
CHAR_RNN = dict(hidden=128, embed=64, num_layers=2)
CHAR_RNN_BATCH = (64, 64)                 # (batch, seqlen)
CHAR_RNN_LR = 3e-3
CHAR_RNN_STEPS = 40
CHAR_RNN_WINDOW = 5


# -- ring attention (ops/ring_attention.py) -----------------------------------
# The ring's per-rank body, run over the S shards of one card with an
# in-process hop (`LocalRing`): every rank's blocks through the flash
# kernels, merged on their lse, then the backward ring through autograd
# with each block's two backward kernels.  The shape is LlamaConfig.base()'s
# attention in training (B=8, T=1024, 16 heads over 8 kv heads, head dim
# 128); label: (S, causal), run in bf16 and f32.  Held against the port's
# plain whole-sequence attention (`_flash_fwd_reference`,
# `_flash_bwd_reference`) by the flash limits above: the merge adds one
# f32 rescale a block, and in bf16 the blocks' outputs and the rank's
# summed dq are rounded once more than the whole-sequence kernel's.
RING_SHAPE = (8, 1024, 16, 8, 128)        # B, T, H, K, D
RING_CASES = {f"s{S}_{'causal' if c else 'full'}": (S, c)
              for S in (2, 4) for c in (True, False)}
RING_DTYPES = (torch.bfloat16, torch.float32)


def ring_launches(S: int, causal: bool) -> int:
    """Each kernel's launches over the S ranks of one ring, forward and
    backward (a block's backward launches dQ and dK/dV once): S² blocks,
    of which the causal mask leaves S(S+1)/2 (the masked ones are
    skipped)."""
    return S * (S + 1) // 2 if causal else S * S


class LocalRing:
    """The hop of rank `index` of a ring whose S blocks all lie in this
    process: a rank's (k, v) blocks, found by identity, give those of
    rank index − RING_STEP (autograd takes each block's gradient back
    to its own rank's slice)."""

    def __init__(self, index, k_blocks, v_blocks):
        self.index, self.size = index, len(k_blocks)
        self.k, self.v = k_blocks, v_blocks
        self._of = {id(t): j for j, t in enumerate(k_blocks)}

    def __call__(self, k, v):
        j = (self._of[id(k)] - _ring_module().RING_STEP) % self.size
        return self.k[j], self.v[j]


def _ring_module():
    # ops/__init__ binds the name ring_attention to the function
    return importlib.import_module(__package__ + ".ops.ring_attention")


def ring_run(q, k, v, S, causal, do, use_flash=True):
    """The ring over S in-process ranks on (B, T, H|K, D) q, k, v:
    (o (B, T, H, D), lse (B, H, T, 1), (dq, dk, dv)) with the output's
    gradient `do`."""
    from .ops.ring_attention import ring_attention_local
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    qs, ks, vs = ([c.contiguous() for c in t.chunk(S, 1)] for t in (q, k, v))
    scale = q.shape[-1] ** -0.5
    outs, lses = [], []
    for i in range(S):
        o, lse = ring_attention_local(
            qs[i], ks[i], vs[i], causal=causal, scale=scale,
            use_flash=use_flash, hop=LocalRing(i, ks, vs), return_lse=True)
        outs.append(o)
        lses.append(lse)
    o = torch.cat(outs, 1)
    grads = torch.autograd.grad(o, (q, k, v), do)
    return o.detach(), torch.cat(lses, 2).detach(), grads


def ring_inputs(label, dtype, device="cuda"):
    """q, k, v and do for case `label` at RING_SHAPE."""
    b, t, h, kh, d = RING_SHAPE
    g = torch.Generator(device).manual_seed(len(label))

    def rnd(*shape, std=0.3):
        return (torch.randn(shape, generator=g, device=device) * std
                ).to(dtype)
    return (rnd(b, t, h, d), rnd(b, t, kh, d), rnd(b, t, kh, d),
            rnd(b, t, h, d, std=1.0))


def ring_errors(q, k, v, do, S, causal, dtype):
    """The ring against the plain whole-sequence attention on the same
    inputs: o, lse and dq/dk/dv by the flash limits."""
    scale = q.shape[-1] ** -0.5
    o, lse, grads = ring_run(q, k, v, S, causal, do)
    ro, rl = fa._flash_fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2)[..., None]
    ref = fa._flash_bwd_reference(q, k, v, do, rl, delta.contiguous(),
                                  causal, scale)
    fwd = flash_errors(o, lse, ro, rl, dtype)
    bwd = flash_bwd_errors(grads, ref, dtype)
    return {**{k_: v_ for k_, v_ in fwd.items() if k_ != "ok"},
            **{k_: v_ for k_, v_ in bwd.items() if k_ != "ok"},
            "ok": fwd["ok"] and bwd["ok"]}


def check_ring(label, dtype):
    """Case `label` in `dtype` on the card: its errors, and each
    kernel's launches on the card against `ring_launches`."""
    S, causal = RING_CASES[label]
    inputs = ring_inputs(label, dtype)
    before = fa.device_launches()
    out = ring_errors(*inputs, S, causal, dtype)
    after = fa.device_launches()
    launches = {n: after[n] - before[n] for n in fa.KERNELS}
    want = ring_launches(S, causal)
    out.update(launches=launches, expected_launches=want,
               launches_ok=all(n == want for n in launches.values()))
    return out


# planted faults of the ring's body, each of which must fail the limits
# on its case: name -> (case, dtype, what it patches)
RING_FAULTS = {
    # the merge takes every held block as visible: the causal mask
    # between blocks is lost (future blocks are merged in)
    "merge_ignores_causal_mask": ("s4_causal", torch.bfloat16,
                                  "_block_visible"),
    # the hop sends each block to rank − 1 instead of rank + 1
    "hop_turns_wrong_way": ("s4_causal", torch.bfloat16, "RING_STEP"),
}


@contextlib.contextmanager
def ring_fault(name):
    """Plant ring fault `name` in ``ops.ring_attention`` for the body of
    the with-block."""
    ra = _ring_module()
    attr = RING_FAULTS[name][2]
    saved = getattr(ra, attr)
    setattr(ra, attr, (lambda s, index, causal: True)
            if attr == "_block_visible" else -saved)
    try:
        yield
    finally:
        setattr(ra, attr, saved)


# -- the multi-axis training step ---------------------------------------------
# A world of 1 under all three axes: every Linear and embedding runs its
# Megatron form and every collective runs over a group of one, the lm
# head's loss is the vocab-parallel one; its losses and parameters must
# equal the plain step's bit for bit.
SPMD_AXES = {"data": 1, "model": 1, "seq": 1}


def megatron_forms(m):
    """Counts of `m`'s Linear and Embedding layers by the form their
    recorded spec gives them (column, row, embedding, whole)."""
    from . import layer
    from .parallel import tensor_parallel as tp
    forms = {"column": 0, "row": 0, "embedding": 0, "whole": 0}
    for mod in m.modules():
        if isinstance(mod, layer.Linear):
            cut = tp.sharded_dim(mod.W)
            forms[{1: "column", 0: "row"}.get(cut, "whole")] += 1
        elif isinstance(mod, layer.Embedding):
            forms["embedding" if tp.sharded_dim(mod.table) == 1
                  else "whole"] += 1
    return forms


def spmd_vs_plain(m, batches, make_opt, axes=SPMD_AXES):
    """From `m`'s weights, its training steps over `batches` in graph
    mode (eager at the first two calls, captured from the third) with
    make_opt() and no mesh, then with DistOpt(make_opt()) under
    make_mesh(`axes`): each run's losses and parameters, held to each
    other bitwise; the collectives staged in the multi-axis run's first
    step; the layers' forms; whether its step was captured.  Needs a
    process group of the mesh's size (make_mesh binds to it).  The
    model is left cut by the rules (at a world of 1: whole blocks)."""
    from . import faults, opt, parallel
    def host(ps):            # copies, also where the model is on the CPU
        return {n: p.detach().to("cpu", copy=True) for n, p in ps.items()}
    start = host(m.get_params())
    runs, staged = {}, 0
    for multi in (False, True):
        m.set_params(start)
        parallel.set_mesh(parallel.make_mesh(axes) if multi else None)
        try:
            base = make_opt()
            m.set_optimizer(opt.DistOpt(base) if multi else base)
            m.compile([batches[0]], is_train=True, use_graph=True)
            losses = []
            for i, b in enumerate(batches):
                plan = faults.FaultPlan()
                with faults.active(plan):
                    losses.append(m.train_step(b)[1].item())
                if i == 0 and multi:
                    staged = plan.calls.get("comm.collective", 0)
        finally:
            parallel.set_mesh(None)
        runs[multi] = (losses, host(m.get_params()))
    ex = next(e for e in m._executors.values() if e.is_train)
    differ = [n for n, p in runs[False][1].items()
              if not torch.equal(p, runs[True][1][n])]
    return {"steps": len(batches), "plain_losses": runs[False][0],
            "spmd_losses": runs[True][0],
            "losses_bitwise": runs[False][0] == runs[True][0],
            "params_differing": differ[:8],
            "bitwise": runs[False][0] == runs[True][0] and not differ,
            "gspmd": ex.gspmd, "captured": ex.captured is not None
            and ex.captured.graph is not None,
            "collectives_staged_first_step": staged,
            "forms": megatron_forms(m)}


# -- the pipeline schedule (parallel/pipeline.py) ------------------------------
# The per-rank GPipe body of S stages, run in one process on one card with
# an in-process hop (`LocalPipe`): the forward rank by rank (a stage only
# receives from the one before it), the backward in descending rank order
# (a stage's gradients come from the one after it).  The blocks are
# LlamaConfig.base()'s at full width and depth (16 blocks, dim 2048, GQA
# 16/8) on a (B=8, T=1024) activation; label: (S, M), run in bf16 and f32,
# against the same blocks applied in order to the whole batch.  Limits
# (readings in PERF.md): the largest relative error of the output and of
# each gradient (Frobenius norms, x's and every parameter's): a
# microbatch's products differ from the whole batch's only in summation
# order (and in bf16 in where they are rounded).
PIPE_SHAPE = (8, 1024)                    # B, T
PIPE_CASES = {f"s{S}_m{M}": (S, M) for S in (2, 4) for M in (S, 2 * S)}
PIPE_DTYPES = (torch.bfloat16, torch.float32)
PIPE_RTOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def pipe_launches(num_layers: int, M: int) -> int:
    """Each flash kernel's launches in one pipelined forward and
    backward: every block once per microbatch (bubbles are skipped)."""
    return num_layers * M


class LocalPipe:
    """The hops of S pipeline stages that all run in this process:
    `endpoint(r)` is stage r's transport.  A send is queued for its
    receiver; a receive takes the oldest message from its sender, or
    zeros where none waits (as a ppermute with no source gives).  The
    last stage's outputs are not replicated to the others: read them
    from the last stage."""

    def __init__(self, size: int):
        import collections
        self.size = size
        self._boxes = collections.defaultdict(collections.deque)

    def endpoint(self, index: int) -> "_LocalStage":
        return _LocalStage(self, index)


class _LocalStage:
    def __init__(self, pipe: LocalPipe, index: int):
        self.pipe, self.index, self.size = pipe, index, pipe.size

    def exchange(self, send, recv_like, step):
        S, i = self.size, self.index
        if send is not None:
            self.pipe._boxes[(i, (i + step) % S, step)].append(send)
        if recv_like is None:
            return None
        box = self.pipe._boxes[((i - step) % S, i, step)]
        return box.popleft() if box else torch.zeros_like(recv_like)

    def replicate(self, x):
        return x


def pipe_run(blocks, x, do, S, M):
    """The blocks cut into S stages of one in-process pipeline over M
    microbatches of x (B, ...): (output, gradient of x, the blocks'
    parameter gradients in order), `do` the output's gradient."""
    from .parallel import pipeline
    L = len(blocks)
    k = L // S
    x = x.detach().requires_grad_()
    xm = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
    pipe = LocalPipe(S)
    stages = [blocks[r * k:(r + 1) * k] for r in range(S)]
    params = [[p for b in st for p in b.parameters()] for st in stages]
    outs = []
    for r in range(S):
        def fn(ps, h, own=stages[r]):
            for b in own:
                h = b(h)
            return h
        outs.append(pipeline.run_schedule(fn, params[r], xm, (), M,
                                          pipe.endpoint(r)))
    grads = [None] * S
    dx = None
    for r in reversed(range(S)):
        g_out = do.reshape(xm.shape) if r == S - 1 else \
            torch.zeros_like(outs[r])
        ins = ([x] if r == 0 else []) + params[r]
        g = torch.autograd.grad(outs[r], ins, g_out)
        if r == 0:
            dx, g = g[0], g[1:]
        grads[r] = list(g)
    return (outs[-1].detach().reshape(x.shape), dx,
            [g for gs in grads for g in gs])


def seq_run(blocks, x, do):
    """The blocks in order on the whole batch: (output, dx, the
    parameter gradients)."""
    x = x.detach().requires_grad_()
    h = x
    for b in blocks:
        h = b(h)
    params = [p for b in blocks for p in b.parameters()]
    g = torch.autograd.grad(h, [x] + params, do)
    return h.detach(), g[0], list(g[1:])


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp_min(1e-30)).item()


def pipe_errors(got, want, dtype):
    """Relative errors of a pipelined run against the sequential one:
    output, x's gradient, and the largest over the parameters'."""
    out = {"out": _rel(got[0], want[0]), "dx": _rel(got[1], want[1]),
           "dparams": max(_rel(a, b) for a, b in zip(got[2], want[2]))}
    out["ok"] = all(v <= PIPE_RTOL[dtype] for v in out.values())
    out["limit"] = PIPE_RTOL[dtype]
    return out


def pipe_blocks(dtype, device="cuda", num_layers=None):
    """LlamaConfig.base()'s blocks (all of them by default) with the
    inputs of the pipe cases: (blocks, x, do) in `dtype`."""
    import dataclasses
    from .models import llama
    cfg = llama.LlamaConfig.base()
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    dev = _device(device, dtype)
    gen = torch.Generator(device).manual_seed(0)
    blocks = [llama._LlamaBlock(cfg, device=dev, generator=gen)
              for _ in range(cfg.num_layers)]
    B, T = PIPE_SHAPE
    x = torch.randn((B, T, cfg.dim), generator=gen, device=device).to(dtype)
    do = torch.randn((B, T, cfg.dim), generator=gen, device=device
                     ).to(dtype) * 1e-2
    return blocks, x, do


def _device(kind, dtype):
    from . import device as device_mod
    dev = device_mod.create_device(kind)
    dev.default_dtype = dtype
    return dev


# planted faults of the schedule, each of which must fail the limits on
# its case: name -> (case, dtype, what it patches in parallel.pipeline)
PIPE_FAULTS = {
    # the hop sends each activation to stage r − 1 instead of r + 1
    "hop_turns_wrong_way": ("s4_m4", torch.bfloat16, "_PIPE_STEP"),
    # the last stage works one tick early: the output of a bubble tick
    # (on an empty buffer) is recorded in place of microbatch 0, and each
    # later one in place of the next
    "bubble_recorded": ("s4_m4", torch.bfloat16, "_micro"),
}


def _early_last(t, r, S, M):
    j = t - r + (r == S - 1)
    return j if 0 <= j < M else None


@contextlib.contextmanager
def pipe_fault(name):
    """Plant pipe fault `name` in ``parallel.pipeline`` for the body of
    the with-block."""
    from .parallel import pipeline
    attr = PIPE_FAULTS[name][2]
    saved = getattr(pipeline, attr)
    setattr(pipeline, attr, _early_last if attr == "_micro" else -saved)
    try:
        yield
    finally:
        setattr(pipeline, attr, saved)


def check_pipe(label, dtype, blocks, x, do, want):
    """Case `label` in `dtype` on the card: its errors against the
    sequential run `want` (``seq_run``), and each kernel's launches
    against `pipe_launches`."""
    S, M = PIPE_CASES[label]
    before = fa.device_launches()
    got = pipe_run(blocks, x, do, S, M)
    torch.cuda.synchronize()
    after = fa.device_launches()
    out = pipe_errors(got, want, dtype)
    launches = {n: after[n] - before[n] for n in fa.KERNELS}
    expect = pipe_launches(len(blocks), M)
    out.update(launches=launches, expected_launches=expect,
               launches_ok=all(n == expect for n in launches.values()))
    return out


# -- expert parallelism (ops/moe.py) ------------------------------------------
# One MoE layer at Mixtral-8x7B's published widths (D 4096, H 14336, 8
# SwiGLU experts, top-2, capacity factor E/k = 4: dropless) over phase
# moe's training tokens (B=4 × T=1024), its experts cut over ep ranks of
# one process (each rank's share through ops.moe.moe_partial with the
# einsum dispatch, as 'auto' resolves under an expert axis), the shares
# summed in-process, against the one-device scatter path.  Routing is the
# same f32 product on both sides, so every token is routed alike; rows
# are held to a relative error (2-norms over D), bf16 at PR 9's
# routed-alike limit; the gradients (x, router, each expert weight) by
# their relative Frobenius error.
EP_TOKENS = (4, 1024)
EP_CASES = {"ep2": 2, "ep4": 4}
EP_DTYPES = (torch.bfloat16, torch.float32)
EP_ROW_RTOL = {torch.float32: 1e-5, torch.bfloat16: 0.0625}
EP_GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def ep_inputs(dtype, device="cuda"):
    """(x (N, D), router (D, E) f32, w_in, w_out, w_gate (E, ...) f32,
    do (N, D)) at EP_TOKENS and mixtral-8x7b's widths."""
    from .models.llama import PUBLISHED
    c = PUBLISHED["mixtral-8x7b"]
    g = torch.Generator(device).manual_seed(7)
    N = EP_TOKENS[0] * EP_TOKENS[1]
    D, H, E = c.dim, c.ffn_dim, c.num_experts

    def rnd(*shape, std):
        return torch.randn(shape, generator=g, device=device) * std
    std = (2.0 / (D + H)) ** 0.5
    return (rnd(N, D, std=1.0).to(dtype), rnd(D, E, std=D ** -0.5),
            rnd(E, D, H, std=std), rnd(E, H, D, std=std),
            rnd(E, D, H, std=std), rnd(N, D, std=1e-2).to(dtype))


def ep_run(x, router, w_in, w_out, w_gate, do, ep):
    """(output, aux loss, grads of x, router, w_in, w_out, w_gate): the
    one-device scatter path with ep == 0, else ep in-process expert
    ranks (einsum dispatch), their outputs summed and the aux loss taken
    once."""
    from .models.llama import PUBLISHED
    from .ops import moe
    c = PUBLISHED["mixtral-8x7b"]
    ins = [t.detach().requires_grad_() for t in (x, router, w_in, w_out,
                                                 w_gate)]
    xr, rr, wi, wo, wg = ins
    cf, k = c.moe_capacity_factor, c.moe_top_k
    if not ep:
        out, aux = moe.moe_forward(xr, rr, wi, wo, cf, True, k, wg,
                                   "scatter")
    else:
        El = wi.shape[0] // ep
        out, aux = None, None
        for r in range(ep):
            sl = slice(r * El, (r + 1) * El)
            o, a = moe.moe_partial(xr, rr, wi[sl], wo[sl], cf, k, wg[sl],
                                   "einsum", r * El)
            out = o if out is None else out + o
            aux = a if aux is None else aux
    grads = torch.autograd.grad((out, aux), ins, (do, torch.ones_like(aux)))
    return out.detach(), aux.detach(), grads


def ep_errors(got, want, dtype):
    """The expert-parallel run against the one-device one: the largest
    row relative error of the output, the aux loss's relative error, and
    each gradient's relative Frobenius error."""
    o, w = got[0].float(), want[0].float()
    rows = ((o - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30))
    out = {"out_row": rows.max().item(),
           "aux": abs(got[1].item() - want[1].item())
           / abs(want[1].item())}
    for name, a, b in zip(("dx", "drouter", "dw_in", "dw_out", "dw_gate"),
                          got[2], want[2]):
        out[name] = _rel(a, b)
    out["ok"] = out["out_row"] <= EP_ROW_RTOL[dtype] and all(
        v <= EP_GRAD_RTOL[dtype] for k_, v in out.items()
        if k_ not in ("out_row", "ok"))
    out["limits"] = {"out_row": EP_ROW_RTOL[dtype],
                     "rest": EP_GRAD_RTOL[dtype]}
    return out


# ---------------------------------------------------------------------------
# the native core (singa_tpu_torch._core) on the card's host
# ---------------------------------------------------------------------------

# the threaded loader as the path runs it: 4 workers, a ring of 4, two
# epochs; the MLP steps through the host kernels against torch's within
# the reference's limits (tests/test_native.py's native-vs-XLA steps)
NATIVE_WORKERS, NATIVE_PREFETCH, NATIVE_EPOCHS = 4, 4, 2
NATIVE_MLP_STEPS = 3
NATIVE_MLP_RTOL, NATIVE_MLP_ATOL = 1e-4, 1e-5


def native_set(n: int, shape, seed: int = 0):
    """n random f32 samples of `shape` (numpy, drawn on the host) and the
    labels ``arange(n)``: a label names its row."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, *shape), generator=g).numpy()
    return x, torch.arange(n, dtype=torch.int32).numpy()


def native_feed(step, loader, x_dev, epochs: int = NATIVE_EPOCHS):
    """`epochs` epochs of `loader` through ``prefetch_to_device`` into
    step(x, y) -> loss, the loss read every step (as
    ``tools/train_cnn.py`` reads it).  Each batch's rows are held
    against ``x_dev[labels]`` on the card after its step, outside the
    timed window, and each epoch must deliver every label exactly once.
    Returns each step's wall seconds (batch wait, copy, step, loss
    read), the host seconds of each batch wait alone (the ``next()``
    that assembles, stages and enqueues the copies of every batch it
    pulls), the losses, and whether the batches were whole."""
    from .utils.data import prefetch_to_device
    n = len(x_dev)
    walls, waits, losses, rows_ok, epochs_ok = [], [], [], True, True
    for _ in range(epochs):
        seen = torch.zeros(n, dtype=torch.int64, device="cuda")
        it = iter(prefetch_to_device(loader, device="cuda"))
        while True:
            t0 = _now()
            try:
                xb, yb = next(it)
            except StopIteration:
                break
            waits.append(time.perf_counter() - t0)
            losses.append(float(step(xb, yb)))
            walls.append(_now() - t0)
            lab = yb.long()
            rows_ok &= bool(torch.equal(xb, x_dev.index_select(0, lab)))
            seen.index_add_(0, lab, torch.ones_like(lab))
        epochs_ok &= bool((seen == 1).all())
    return {"step_s": walls, "wait_s": waits, "losses": losses,
            "rows_match_labels": rows_ok,
            "each_label_once_per_epoch": epochs_ok, "epochs": epochs}


def _now() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def native_mlp_losses(use_native: bool, steps: int = NATIVE_MLP_STEPS):
    """`steps` eager SGD steps (momentum 0.9) of a 16-wide MLP on the CPU
    device ``create_cpu_device(use_native)`` (the default device while
    they run), the reference's native-vs-XLA case; returns the losses and
    how many host-kernel calls they made (``_core.stats``)."""
    import numpy as np
    from . import _core, device, models, opt
    prev = device._default_device
    dev = device.create_cpu_device(use_native=use_native)
    device.set_default_device(dev)
    try:
        _core.reset_stats()
        m = models.MLP(perceptron_size=16, num_classes=4, input_shape=(10,),
                       device=dev, generator=torch.Generator().manual_seed(0))
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
        x = torch.from_numpy(np.random.RandomState(1).randn(8, 10)
                             .astype(np.float32))
        y = torch.from_numpy(np.random.RandomState(2).randint(0, 4, 8)
                             .astype(np.int32))
        m.compile([x], is_train=True, use_graph=False)
        losses = [m.train_step(x, y)[1].item() for _ in range(steps)]
        return losses, _core.stats["calls"]
    finally:
        device.set_default_device(prev)


def schedule_is_topological(s) -> bool:
    """Whether a ``graph.Schedule``'s order names every node once and
    puts each node after the nodes that write what it reads (read from
    the traced graph, not from the scheduler), the sink last of all."""
    from .graph import _value_key
    n = s.num_nodes
    if sorted(s.order) != list(range(n)):
        return False
    where = {i: k for k, i in enumerate(s.order)}
    pos = {node: where[i] for i, node in enumerate(s._steps)}
    out = next(x for x in s.gm.graph.nodes if x.op == "output")
    for node in list(s._steps) + [out]:
        at = pos.get(node, n)
        if node is out and len(s._steps) < n:
            at = where[n - 1]            # the outputs are read at the sink
        for src in node.all_input_nodes:
            src = _value_key(src)[0]
            if src in pos and pos[src] >= at:
                return False
    return True
