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
    ran = tfa.device_launches()["flash_fwd"]
    errs = kernel_check.check_flash(case, dtype)
    assert tfa.launches == before + 1
    assert tfa.device_launches()["flash_fwd"] == ran + 1
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
                    None, torch.cuda.current_stream().cuda_stream)
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
    # eager, warm-up, capture + replay, replay: counted on the card
    for _ in range(4):
        tfa.reset_device_launches()
        _, loss = m.train_step(ids)
        losses.append(loss.item())
        assert tfa.device_launches() == dict.fromkeys(tfa.KERNELS,
                                                      cfg.num_layers)
    assert m.graph.graph is not None
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in m.get_params().values())


# -- captured steps (CUDA graphs) -----------------------------------------------

# the captured train step against the eager one, relative (losses; the
# parameters by Frobenius norm): the same kernels on the same inputs,
# launched from a graph instead of from the host
CAPTURE_RTOL = 2e-5


def _small_llama(cuda_device, seed=0):
    """Tiny Llama at head_dim 32 (the smallest the kernels tile), long
    enough (T >= 512) for the flash route."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), dim=128, max_position=1024,
                              fused_loss=True)
    return Llama(cfg, device=cuda_device,
                 generator=torch.Generator("cuda").manual_seed(seed))


def _batches(n, b=2, t=512, vocab=256):
    rng = np.random.RandomState(7)
    return [torch.as_tensor(rng.randint(0, vocab, (b, t)), device="cuda")
            for _ in range(n)]


@pytest.mark.cuda
def test_captured_train_step_matches_eager(cuda_device):
    batches = _batches(6)
    runs = {}
    for use_graph in (False, True):
        m = _small_llama(cuda_device)
        m.set_optimizer(topt.AdamW(lr=topt.WarmupCosine(3e-3, 2, 6)))
        m.compile([batches[0]], is_train=True, use_graph=use_graph)
        held, losses, per_step = [], [], []
        for x in batches:
            tfa.reset_device_launches()
            _, loss = m.train_step(x)
            held.append(loss)
            losses.append(loss.item())
            per_step.append(tfa.device_launches())
        # a loss returned at step k keeps its value after later steps
        assert [t.item() for t in held] == losses
        assert per_step == [dict.fromkeys(tfa.KERNELS, m.cfg.num_layers)] \
            * len(batches)
        runs[use_graph] = (losses, m.get_params(), m)
    (le, pe, _), (lc, pc, mc) = runs[False], runs[True]
    np.testing.assert_allclose(lc, le, rtol=CAPTURE_RTOL)
    assert len(set(le)) == len(le)
    for n, p in pe.items():
        rel = ((pc[n] - p).norm() / p.norm()).item()
        assert rel <= CAPTURE_RTOL, (n, rel)
    g = mc.get_graph("train")
    assert g.graph is not None and g.pool_bytes > 0 and g.capture_seconds
    assert g.launches == {"flash_fwd": 2, "flash_bwd_dq": 2,
                          "flash_bwd_dkv": 2}
    # the FLOPs the counter sees: every matrix product but attention's,
    # which runs in the flash kernels
    c, T = mc.cfg, 512
    expect = (mc.flops_per_token(T) - 12 * c.num_layers * c.dim * T) * 2 * T
    assert abs(g.flops() - expect) <= 0.01 * expect


@pytest.mark.cuda
def test_captured_bodies_do_not_sync_the_host(cuda_device):
    m = _small_llama(cuda_device)
    m.set_optimizer(topt.GradAccum(topt.AdamW(lr=topt.CosineDecay(1e-3, 9)),
                                   2))
    x = _batches(1)[0]
    m.compile([x], is_train=True, use_graph=True)
    m.train_step(x)                       # builds and binds the kernels
    sessions = [m._gen_session(2, 512, 516, torch.bfloat16,
                               (temp, 8 if temp else None, None, 3))
                for temp in (0.0, 1.0)]
    torch.cuda.synchronize()
    # the bodies that get captured, run eagerly: the train step's
    # warm-up, and the sessions' prefill and decode steps
    torch.cuda.set_sync_debug_mode("error")
    try:
        m.train_step(x)
        for sess in sessions:
            sess._prefill()
            sess._decode()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    m.train_step(x)                       # capture + replay
    assert m.graph.graph is not None


def _fault_lib(name, tmp_path):
    from singa_tpu_torch import _build
    src = tmp_path / f"{name}.cu"
    src.write_text(kernel_check.flash_bwd_fault_source(name))
    return _build.build([src])[0].lib


@pytest.mark.cuda
def test_planted_fault_through_a_fresh_capture_fails(cuda_device, tmp_path):
    from singa_tpu_torch import graph as tgraph
    m = _small_llama(cuda_device)
    m.set_optimizer(topt.SGD(lr=0.0))      # every step's gradient at x0
    x = _batches(1)[0]
    m.compile([x], is_train=True, use_graph=True)
    params = m.get_params()

    def grads_after(calls):
        for _ in range(calls):
            m.train_step(x)
        return {n: p.grad.clone() for n, p in params.items()}

    def worst(g, ref):
        return max(((g[n] - ref[n]).norm() / ref[n].norm()).item()
                   for n in ref)
    eager = grads_after(1)
    tgraph.reset_graph()
    with kernel_check.flash_bwd_kernel(
            _fault_lib("dkv_causal_strict", tmp_path)):
        faulty = grads_after(3)            # eager, warm-up, capture
        assert m.graph.graph is not None
    tgraph.reset_graph()                   # the graph kept the fault
    sound = grads_after(3)
    assert worst(sound, eager) <= 1e-2
    assert worst(faulty, eager) > 5e-2


@pytest.mark.cuda
def test_captured_generate_equals_eager_bitwise(cuda_device):
    m = _small_llama(cuda_device)
    prompt = np.random.RandomState(3).randint(0, 256, (2, 512))
    kw = dict(max_new_tokens=8, param_dtype=torch.bfloat16)
    eager = m.generate(prompt, use_graph=False, **kw)
    outs = []
    for _ in range(3):                    # warm-up, capture + replay, replay
        tfa.reset_device_launches()
        outs.append(m.generate(prompt, **kw))
        assert tfa.device_launches() == {"flash_fwd": m.cfg.num_layers,
                                         "flash_bwd_dq": 0,
                                         "flash_bwd_dkv": 0}
    for out in outs:
        np.testing.assert_array_equal(out, eager)
    for eos in (int(eager[0, 512]), int(eager[1, 514])):
        e = m.generate(prompt, eos_id=eos, use_graph=False, **kw)
        for _ in range(3):
            np.testing.assert_array_equal(
                m.generate(prompt, eos_id=eos, **kw), e)
    # a train step between two calls: the next call reads the new weights
    m.set_optimizer(topt.SGD(lr=0.5))
    m.compile([prompt], is_train=True, use_graph=True)
    m.train_step(prompt)
    after = m.generate(prompt, use_graph=False, **kw)
    assert not np.array_equal(after, eager)
    np.testing.assert_array_equal(m.generate(prompt, **kw), after)


@pytest.mark.cuda
def test_captured_sampling_draws_afresh_on_every_replay(cuda_device):
    m = _small_llama(cuda_device)
    prompt = np.random.RandomState(4).randint(0, 256, (2, 512))
    kw = dict(max_new_tokens=8, temperature=1.0, top_k=50, top_p=0.95)
    runs = [m.generate(prompt, seed=s, **kw) for s in (1, 1, 1, 2, 3)]
    for r in runs[1:3]:
        np.testing.assert_array_equal(r, runs[0])
    assert len({r.tobytes() for r in runs}) == 3
    assert ((runs[0] >= 0) & (runs[0] < 256)).all()
    # the replayed steps differ from each other: the draw is not frozen
    assert len({tuple(c) for c in runs[4][:, 512:].T}) > 1


@pytest.mark.cuda
def test_captured_eval_step_matches_eager(cuda_device):
    m = _small_llama(cuda_device)
    xs = _batches(4)
    with torch.no_grad():
        eager = [m(x) for x in xs]          # not compiled: eager forward
    m.compile([xs[0]], is_train=False, use_graph=True)
    outs = [m(x) for x in xs]               # eager, warm-up, capture, replay
    assert m.get_graph("eval").graph is not None
    for got, want in zip(outs, eager):      # each kept its own value
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_resume_from_a_checkpoint_recaptures(cuda_device, tmp_path):
    xs = _batches(6)

    def model(seed):
        m = _small_llama(cuda_device, seed)
        m.set_optimizer(topt.AdamW(lr=topt.WarmupCosine(3e-3, 2, 6)))
        m.compile([xs[0]], is_train=True, use_graph=True)
        return m
    m = model(0)
    whole = []
    for i, x in enumerate(xs):
        whole.append(m.train_step(x)[1].item())
        if i == 3:                          # after a replayed step
            m.save_states(str(tmp_path / "c.npz"))
    r = model(1)
    r.load_states(str(tmp_path / "c.npz"))
    resumed = [r.train_step(x)[1].item() for x in xs[4:]]
    np.testing.assert_allclose(resumed, whole[4:], rtol=CAPTURE_RTOL)
    for n, p in m.get_params().items():
        rel = ((r.get_params()[n] - p).norm() / p.norm()).item()
        assert rel <= CAPTURE_RTOL, (n, rel)
