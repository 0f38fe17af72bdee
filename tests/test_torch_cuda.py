"""Tests of the port that need an NVIDIA card: the CUDA flash kernel
against its plain version, and the serving path through the kernel.

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
    q = q.requires_grad_()
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa.flash_attention(q[..., :64], k[..., :64], v[..., :64], causal=True)


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
