"""The port's flash-attention forward (singa_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernel in interpret mode, on the CPU.

On a CPU tensor the port computes the kernel's plain version
(`_flash_fwd_reference`); the CUDA kernel itself is held against that
plain version by the `cuda`-marked tests of tests/test_torch_cuda.py and
by chip_smoke.py.

Tolerance rtol 2e-4, atol 2e-5 in f32, as tests/test_flash.py holds the
Pallas kernel against the XLA reference: the two differ only in
summation order and the tile-wise online softmax."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import flash_attention as jfa
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.ops import flash_attention as tfa

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)


def _mk(B, Tq, H, D, K=None, Tk=None, seed=0):
    rng = np.random.RandomState(seed)
    K = K or H
    Tk = Tk or Tq
    q = (rng.randn(B, Tq, H, D) * 0.3).astype(np.float32)
    k = (rng.randn(B, Tk, K, D) * 0.3).astype(np.float32)
    v = (rng.randn(B, Tk, K, D) * 0.3).astype(np.float32)
    return q, k, v


# (B, Tq, Tk, H, K, D, causal, window)
CASES = {
    "mha_noncausal": (1, 256, 256, 2, 2, 64, False, None),
    "mha_causal": (1, 256, 256, 2, 2, 64, True, None),
    "gqa_causal": (2, 128, 128, 4, 2, 32, True, None),
    "tq_ne_tk_causal": (1, 128, 256, 4, 2, 64, True, None),
    "tq_ne_tk_noncausal": (1, 128, 256, 2, 2, 64, False, None),
    "window": (1, 256, 256, 4, 2, 32, True, 64),
    "d40_padded": (1, 128, 128, 2, 1, 40, True, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_matches_pallas_interpret(case):
    B, Tq, Tk, H, K, D, causal, window = CASES[case]
    q, k, v = _mk(B, Tq, H, D, K=K, Tk=Tk, seed=len(case))
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, interpret=True, window=window)
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    assert out.shape == (B, Tq, H, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_with_lse_matches_pallas_interpret(causal):
    rng = np.random.RandomState(7)
    q = (rng.randn(1, 4, 256, 64) * 0.3).astype(np.float32)    # (B, H, T, D)
    k = (rng.randn(1, 2, 256, 64) * 0.3).astype(np.float32)
    v = (rng.randn(1, 2, 256, 64) * 0.3).astype(np.float32)
    jo, jl = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True)
    to, tl = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert tl.shape == (1, 4, 256, 1) and tl.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)


def test_plain_version_lse_matches_pallas_window():
    """`_flash_fwd_reference` returns the kernel's lse as well; the
    Pallas launcher `_fwd` gives it for a window in (B, H, T, D) layout."""
    q, k, v = _mk(1, 256, 4, 32, K=2, seed=11)
    scale = 1.0 / np.sqrt(32)
    swap = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)
    jo, jl = jfa._fwd(swap(q), swap(k), swap(v), True, scale, True,
                      window=64)
    to, tl = tfa._flash_fwd_reference(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), True, scale, 64)
    np.testing.assert_allclose(to.numpy(), np.asarray(jnp.swapaxes(jo, 1, 2)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)


def test_with_lse_rejects_untileable():
    q = torch.zeros(1, 2, 100, 64)
    with pytest.raises(ValueError, match="tiling shapes"):
        tfa.flash_attention_with_lse(q, q, q)


@pytest.mark.parametrize("window", [None, 16])
def test_untileable_routes_to_reference_like_jax(window):
    q, k, v = _mk(1, 100, 2, 16, seed=3)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window)
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_window_argument_checks():
    q = torch.zeros(1, 128, 2, 32)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match=">= 1"):
        tfa.flash_attention(q, q, q, causal=True, window=0)


def test_bf16_plain_version_keeps_dtype_and_tracks_f32():
    q, k, v = _mk(1, 128, 2, 64, seed=5)
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    o, lse = tfa._flash_fwd_reference(qb, kb, vb, True, 0.125)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    o32, _ = tfa._flash_fwd_reference(qb.float(), kb.float(), vb.float(),
                                      True, 0.125)
    # only p's rounding to bf16 and o's final rounding differ
    assert (o.float() - o32).abs().max().item() < 2e-2


def test_cpu_path_never_launches_the_kernel():
    tfa.launches = 0
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 512, 2, 64, seed=2))
    from singa_tpu_torch.ops.attention import attention
    attention(q, k, v, causal=True)
    tfa.flash_attention(q, k, v, causal=True)
    assert tfa.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._flash_fwd_cuda(q, q, q, True, 0.125)
