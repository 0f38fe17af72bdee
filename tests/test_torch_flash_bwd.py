"""The port's flash-attention backward (singa_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernels in interpret mode, on the CPU.

On a CPU tensor `_FlashCore`'s backward computes the kernels' plain
version (`_flash_bwd_reference`), so these tests hold the plumbing
around the kernels (delta, the dlse fold, the GQA sum, the layouts)
and the plain version against `jax.grad` through `_bwd`'s two
`pallas_call`s.  The CUDA kernels are held against the plain version by
the `cuda`-marked tests of tests/test_torch_cuda.py and by chip_smoke.py.

Tolerance rtol 5e-4, atol 5e-5 in f32, as tests/test_flash.py holds the
Pallas backward against the XLA reference: the two differ only in
summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import flash_attention as jfa
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.ops import flash_attention as tfa

RTOL, ATOL = 5e-4, 5e-5


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)


def _mk(B, Tq, Tk, H, K, D, seed):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(B, T, n, D) * 0.3).astype(np.float32)
                 for T, n in ((Tq, H), (Tk, K), (Tk, K)))


# (B, Tq, Tk, H, K, D, causal, window) -- the backward cases of
# tests/test_flash.py, plus a window and a head dim the kernels pad
CASES = {
    "mha_noncausal": (1, 128, 128, 2, 2, 32, False, None),
    "mha_causal": (1, 128, 128, 2, 2, 32, True, None),
    "gqa_causal": (1, 128, 128, 4, 2, 32, True, None),
    "tq_ne_tk_causal": (1, 128, 256, 4, 2, 32, True, None),
    "window": (1, 256, 256, 4, 2, 32, True, 64),
    "d40_padded": (1, 128, 128, 2, 1, 40, True, None),
}


def _grads_torch(q, k, v, causal, window, w):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tfa.flash_attention(*ts, causal=causal, window=window)
    (o * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in ts]


def _grads_jax(q, k, v, causal, window, w):
    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, interpret=True,
                                window=window)
        return jnp.sum(o * w)
    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("case", list(CASES))
def test_flash_gradients_match_pallas_interpret(case):
    B, Tq, Tk, H, K, D, causal, window = CASES[case]
    q, k, v = _mk(B, Tq, Tk, H, K, D, seed=len(case))
    w = np.random.RandomState(1).randn(B, Tq, H, D).astype(np.float32)
    got = _grads_torch(q, k, v, causal, window, w)
    ref = _grads_jax(q, k, v, causal, window, w)
    for a, b, name in zip(got, ref, "qkv"):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name} ({case})")


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_dlse_cotangent_matches_pallas(causal):
    """Gradients through both o and lse: the lse cotangent enters only
    through delta, and must reach q and k."""
    rng = np.random.RandomState(3)
    q, k, v = ((rng.randn(1, n, 128, 32) * 0.5).astype(np.float32)
               for n in (4, 2, 2))                        # (B, H, T, D)
    wo = rng.randn(1, 4, 128, 32).astype(np.float32)
    wl = rng.randn(1, 4, 128, 1).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal,
                                              interpret=True)
        return jnp.sum(o * wo) + jnp.sum(lse * wl)
    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = tfa.flash_attention_with_lse(*ts, causal=causal)
    ((o * torch.from_numpy(wo)).sum()
     + (lse * torch.from_numpy(wl)).sum()).backward()
    for t, b, name in zip(ts, ref, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")
    # and the lse term matters: without it dq moves
    ts2 = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o2, _ = tfa.flash_attention_with_lse(*ts2, causal=causal)
    (o2 * torch.from_numpy(wo)).sum().backward()
    assert not np.allclose(ts2[0].grad.numpy(), ts[0].grad.numpy(),
                           atol=1e-3)


@pytest.mark.parametrize("window", [None, 64])
def test_plain_version_matches_pallas_bwd_with_dlse(window):
    """`_flash_bwd_reference` against `_bwd(..., interpret=True)` on the
    same o, lse and cotangents, with a nonzero dlse and GQA."""
    q, k, v = _mk(1, 256, 256, 4, 2, 32, seed=21)
    rng = np.random.RandomState(22)
    do = (rng.randn(*q.shape) * 0.5).astype(np.float32)
    dlse = rng.randn(1, 4, 256, 1).astype(np.float32)
    scale = 1.0 / np.sqrt(32)
    sw = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)
    jo, jl = jfa._fwd(sw(q), sw(k), sw(v), True, scale, True, window=window)
    jdq, jdk, jdv = jfa._bwd(sw(q), sw(k), sw(v), jo, jl, sw(do), True,
                             scale, True, dlse=jnp.asarray(dlse),
                             window=window)

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa._flash_fwd_reference(tq, tk, tv, True, scale, window)
    delta = (tdo * o).sum(-1).transpose(1, 2)[..., None] \
        - torch.from_numpy(dlse)
    dq, dk, dv = tfa._flash_bwd_reference(tq, tk, tv, tdo, lse,
                                          delta.contiguous(), True, scale,
                                          window)
    for a, b, name in ((dq, jdq, "q"), (dk, jdk, "k"), (dv, jdv, "v")):
        np.testing.assert_allclose(a.numpy(),
                                   np.asarray(jnp.swapaxes(b, 1, 2)),
                                   rtol=RTOL, atol=ATOL, err_msg=f"d{name}")


def test_bf16_plain_version_rounds_p_and_ds_and_sums_groups_once():
    """In bf16 the plain version rounds P and dS before the products (as
    the kernels' mma operands) and rounds dk/dv once after the GQA sum;
    it tracks the f32 version to bf16 precision."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _mk(1, 128, 128, 4, 2, 64, seed=4))
    do = torch.from_numpy(_mk(1, 128, 128, 4, 2, 64, seed=5)[0]).bfloat16()
    o, lse = tfa._flash_fwd_reference(q, k, v, True, 0.125)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    out = tfa._flash_bwd_reference(q, k, v, do, lse, delta.contiguous(),
                                   True, 0.125)
    ref = tfa._flash_bwd_reference(q.float(), k.float(), v.float(),
                                   do.float(), lse, delta.contiguous(),
                                   True, 0.125)
    for a, b in zip(out, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        rel = (a.float() - b).norm() / b.norm()
        assert rel < 1e-2, rel


def test_cpu_backward_never_launches_a_kernel():
    tfa.launches = tfa.dq_launches = tfa.dkv_launches = 0
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _mk(1, 512, 512, 2, 2, 64, seed=2))
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == (0, 0, 0)
    assert q.grad is not None and k.grad is not None


def test_backward_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 128, 2, 64)
    lse = torch.zeros(1, 2, 128, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._flash_bwd_cuda(q, q, q, q, lse, lse, True, 0.125)


def test_planted_backward_faults_apply_once():
    from singa_tpu_torch import _build, kernel_check
    src = _build.source_path("flash_bwd").read_text()
    for name, (case, old, new) in kernel_check.FLASH_BWD_FAULTS.items():
        assert case in kernel_check.FLASH_CASES
        faulty = kernel_check.flash_bwd_fault_source(name)
        assert faulty == src.replace(old, new) and faulty != src


def test_backward_limits_pass_rounding_and_hold_small_rows_absolutely():
    """A bf16 rounding of plain gradients passes the limits; losing one
    query head's share of a group (the weakest planted fault) does not;
    a row whose plain norm is near zero is held against the floor, not
    against its own norm."""
    from singa_tpu_torch import kernel_check
    g = torch.Generator().manual_seed(0)
    ref = [torch.randn(1, 256, 2, 64, generator=g) for _ in range(3)]
    rounded = [r.bfloat16() for r in ref]
    assert kernel_check.flash_bwd_errors(rounded, ref, torch.bfloat16)["ok"]
    half = [rounded[0], (ref[1] * 0.5).bfloat16(), rounded[2]]
    assert not kernel_check.flash_bwd_errors(half, ref,
                                             torch.bfloat16)["ok"]
    tiny = [r.clone() for r in ref]
    tiny[1][0, 0, 0] = 1e-9                       # a near-zero plain row
    noisy = [r.clone() for r in tiny]
    noisy[1][0, 0, 0] += 1e-4                     # small in absolute terms
    errs = kernel_check.flash_bwd_errors(noisy, tiny, torch.bfloat16)
    # |d row| = 8e-4 against the floor 0.1 * 8 (rms row norm): 1e-3,
    # where the row's own norm would give 1e5
    assert errs["ok"] and errs["max_row_rel_dk"] == pytest.approx(1e-3,
                                                                  rel=0.01)
