"""The port's kernels against their plain versions, on the card.

One table of cases and one set of limits, shared by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``.  Beside them, planted faults: one-line
changes to a kernel's source, each of the kind a wrong kernel could
carry unseen.  Built from a copy of the source, each must fail the
limits on its case; that shows the limits are tight enough to catch it.
Then what the paths of layer.Remat and the char-rnn are held to on
the card.  Last, ring attention's per-rank body over the shards of one
card (``RING_CASES``), with its planted faults (``RING_FAULTS``), and the
multi-axis training step against the plain one (``spmd_vs_plain``).
"""

from __future__ import annotations

import contextlib
import importlib

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
           "ring_fault", "SPMD_AXES", "megatron_forms", "spmd_vs_plain"]

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
