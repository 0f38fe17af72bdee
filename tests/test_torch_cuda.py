"""Tests of the port that need an NVIDIA card: the CUDA flash kernels
against their plain versions, and the serving and training paths
through the kernels.

This file imports neither jax nor singa_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Whether a card is present is decided in the `cuda_device` fixture; the
tests skip there without one.  The cases and limits are those of
singa_tpu_torch/kernel_check.py, which chip_smoke.py uses too."""

import dataclasses

import numpy as np
import pytest
import torch

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import kernel_check
from singa_tpu_torch import opt as topt
from singa_tpu_torch.models import Llama, LlamaConfig
from singa_tpu_torch.ops import flash_attention as tfa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return tdevice.create_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(kernel_check.FLASH_CASES))
def test_kernel_matches_plain_version(cuda_device, case, dtype):
    before = tfa.launches
    errs = kernel_check.check_flash(case, dtype)
    assert tfa.launches == before + 1
    assert errs["ok"], errs


@pytest.mark.cuda
def test_kernel_reads_strided_layout(cuda_device):
    """(B, H, T, D) views reach the kernel through strides, no copies."""
    q, k, v = kernel_check.make_qkv(1, 256, 256, 4, 2, 64, torch.bfloat16, 1)
    o, lse = tfa.flash_attention_with_lse(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), causal=True)
    ro, rl = tfa._flash_fwd_reference(q, k, v, True, 64 ** -0.5)
    errs = kernel_check.flash_errors(o.transpose(1, 2), lse, ro, rl,
                                     torch.bfloat16)
    assert errs["ok"], errs


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = kernel_check.make_qkv(1, 128, 128, 2, 2, 64, torch.float16, 1)
    with pytest.raises(TypeError):
        tfa._flash_fwd_cuda(q, k, v, True, 0.125)
    q, k, v = kernel_check.make_qkv(1, 128, 128, 2, 2, 512, torch.bfloat16, 1)
    with pytest.raises(ValueError):
        tfa._flash_fwd_cuda(q, k, v, True, 0.125)
    # a gradient through the kernels matches the plain version's
    q, k, v = (t[..., :64].contiguous().requires_grad_() for t in (q, k, v))
    before = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    tfa.flash_attention(q, k, v, causal=True).float().square().sum().backward()
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == \
        tuple(n + 1 for n in before)
    with torch.no_grad():                # what the Function saved
        o, lse = tfa._flash_fwd_cuda(q, k, v, True, 0.125)
    do = 2 * o
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    ref = tfa._flash_bwd_reference(q.detach(), k.detach(), v.detach(), do,
                                   lse, delta.contiguous(), True, 0.125)
    errs = kernel_check.flash_bwd_errors((q.grad, k.grad, v.grad), ref,
                                         torch.bfloat16)
    assert errs["ok"], errs
    # the backward's wrapper refuses 192-row tiles, an lse that is not
    # 16-byte aligned and f16; its bf16 entry points refuse sequence
    # lengths that are not whole 128-row (128-key) tiles
    args = list(kernel_check.bwd_inputs("mha_causal_d64", torch.bfloat16))
    q, k, v, do, lse, delta = args[:6]
    short = [t[:, :192] for t in (q, k, v, do)]
    with pytest.raises(ValueError):
        tfa._flash_bwd_cuda(*short, lse[:, :, :192].contiguous(),
                            delta[:, :, :192].contiguous(), True, 0.125)
    shifted = torch.empty(lse.numel() + 1, device=lse.device)[1:]
    with pytest.raises(ValueError):
        tfa._flash_bwd_cuda(q, k, v, do, shifted.view(lse.shape), delta,
                            True, 0.125)
    with pytest.raises(TypeError):
        tfa._flash_bwd_cuda(q.half(), k.half(), v.half(), do.half(), lse,
                            delta, True, 0.125)
    dq_fn, dkv_fn = tfa._bwd_kernels()
    dk = torch.empty_like(k)
    B, T, H, D = q.shape
    for fn, outs, out in ((dq_fn, [q], q), (dkv_fn, [dk, dk], dk)):
        for tq, tk in ((192, 192), (256, 192), (192, 256)):
            rc = fn(*(t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)),
                    1, B, H, k.shape[2], tq, tk, D,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    *do.stride()[:3], *out.stride()[:3], 0.125, 1, 0,
                    torch.cuda.current_stream().cuda_stream)
            assert rc == 1, (tq, tk, rc)          # cudaErrorInvalidValue
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_backward_kernels_repeat_bitwise(cuda_device):
    """Two launches on the training shape give the same bits: no atomics,
    and no race in the rings or at the named barriers."""
    assert all(kernel_check.bwd_repeats_bitwise("train").values())


@pytest.mark.cuda
def test_generate_launches_the_kernel_once_per_layer(cuda_device):
    # head_dim 32: the smallest the kernel tiles
    cfg = dataclasses.replace(LlamaConfig.tiny(), dim=128, max_position=1024)
    m = Llama(cfg, device=cuda_device,
              generator=torch.Generator("cuda").manual_seed(0))
    prompt = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 512))
    tfa.launches = 0
    out = m.generate(prompt, max_new_tokens=4, param_dtype=torch.bfloat16)
    assert tfa.launches == cfg.num_layers
    assert out.shape == (2, 516) and out.dtype == np.int32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(kernel_check.FLASH_CASES))
def test_backward_kernels_match_plain_version(cuda_device, case, dtype):
    before = (tfa.dq_launches, tfa.dkv_launches)
    errs = kernel_check.check_flash_bwd(case, dtype)
    assert (tfa.dq_launches, tfa.dkv_launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert errs["ok"], errs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_take_the_lse_cotangent(cuda_device, dtype):
    errs = kernel_check.check_flash_bwd("gqa_causal_d128", dtype, dlse=True)
    assert errs["ok"], errs


@pytest.mark.cuda
def test_backward_copies_a_do_it_cannot_read(cuda_device):
    args = list(kernel_check.bwd_inputs("mha_causal_d64", torch.bfloat16))
    do = args[3]
    wide = torch.zeros(do.shape[:-1] + (do.shape[-1] + 4,), dtype=do.dtype,
                       device=do.device)
    wide[..., 2:-2] = do
    args[3] = wide[..., 2:-2]            # rows not 16-byte aligned
    grads = tfa._flash_bwd_cuda(*args)
    args[3] = do
    errs = kernel_check.flash_bwd_errors(
        grads, tfa._flash_bwd_reference(*args), torch.bfloat16)
    assert errs["ok"], errs


@pytest.mark.cuda
def test_train_step_launches_each_kernel_once_per_layer(cuda_device):
    # head_dim 32: the smallest the kernels tile
    cfg = dataclasses.replace(LlamaConfig.tiny(), dim=128, max_position=1024,
                              fused_loss=True)
    m = Llama(cfg, device=cuda_device,
              generator=torch.Generator("cuda").manual_seed(0))
    m.set_optimizer(topt.SGD(lr=0.01, momentum=0.9))
    ids = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 512))
    m.compile([ids], is_train=True, use_graph=True)
    losses = []
    for _ in range(3):
        tfa.launches = tfa.dq_launches = tfa.dkv_launches = 0
        _, loss = m.train_step(ids)
        losses.append(loss.item())
        assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == \
            (cfg.num_layers,) * 3
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in m.get_params().values())
