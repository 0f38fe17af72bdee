"""Tests of the port that need an NVIDIA card: the CUDA flash kernels
against their plain versions, and the serving and training paths
through the kernels.

This file imports neither jax nor singa_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Whether a card is present is decided in the `cuda_device` fixture; the
tests skip there without one.  The cases and limits are those of
singa_tpu_torch/kernel_check.py, which chip_smoke.py uses too.

Being free of jax, this module also holds `tier_model`, the model
builder the worker processes of the port's process tier import by name
(`tests.test_torch_cuda:tier_model`), on the CPU in
tests/test_torch_net.py as on a card here."""

import dataclasses

import numpy as np
import pytest
import torch

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import kernel_check
from singa_tpu_torch import opt as topt
from singa_tpu_torch.models import Llama, LlamaConfig
from singa_tpu_torch.ops import flash_attention as tfa


def tier_model(device, seed=0, weights=None):
    """`LlamaConfig.tiny()` on `device` with weights from `seed` — the
    same in every process that calls it — or, with `weights`, read from
    that .npz of the JAX package's parameter names
    (`load_reference_params`)."""
    from singa_tpu_torch.models import load_reference_params
    gen = torch.Generator(device.torch_device.type).manual_seed(seed)
    m = Llama(LlamaConfig.tiny(), device=device, generator=gen)
    if weights is not None:
        with np.load(weights) as npz:
            load_reference_params(m, dict(npz))
    return m


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


# -- the paged serve engine ---------------------------------------------------

def _serve_prompts(n, vocab, lo=5, hi=70, seed=11):
    rng = np.random.RandomState(seed)
    system = rng.randint(0, vocab, 40)
    return [np.concatenate([system, rng.randint(0, vocab, rng.randint(lo, hi))])
            if i % 2 else rng.randint(0, vocab, rng.randint(lo, hi))
            for i in range(n)]


def _serve(eng, prompts, n=12):
    hs = [eng.submit(p, max_new_tokens=n) for p in prompts]
    eng.run_until_idle()
    return [list(map(int, h.tokens)) for h in hs]


def _eager(eng):
    """Make `eng` launch both programs' bodies from the host at every
    dispatch (never captured): the oracle for its captured twin."""
    eng._prefill, eng._decode = eng._prefill_body, eng._decode_body
    return eng


def _serve_models(cuda_device):
    """Tiny, and LlamaConfig.base() cut to two layers."""
    base = dataclasses.replace(LlamaConfig.base(), num_layers=2)
    return [Llama(cfg, device=cuda_device,
                  generator=torch.Generator("cuda").manual_seed(0))
            for cfg in (dataclasses.replace(LlamaConfig.tiny(),
                                            max_position=256), base)]


@pytest.mark.cuda
def test_serve_engine_captures_two_graphs_and_keeps_them(cuda_device):
    """compiled_counts() is (1, 1) after warm-up, across traffic, a
    recovery and preemption; captured streams equal an all-eager twin's
    bitwise, and repeated traffic gives the same streams."""
    from singa_tpu_torch.serve import ServeEngine
    for m in _serve_models(cuda_device):
        prompts = _serve_prompts(8, m.cfg.vocab_size)
        kw = dict(block_size=16, param_dtype=torch.bfloat16)
        eager = _serve(_eager(ServeEngine(m, 4, 128, **kw)), prompts)
        eng = ServeEngine(m, 4, 128, **kw)
        first = _serve(eng, prompts)
        assert eng.compiled_counts() == (1, 1)
        assert eng._decode.graph.graph is not None
        assert eng._prefill.graph.graph is not None
        assert first == eager
        assert _serve(eng, prompts) == eager
        hs = [eng.submit(p, max_new_tokens=12) for p in prompts[:4]]
        eng.step()
        eng.step()
        eng.recover("test")
        eng.run_until_idle()
        assert [list(map(int, h.tokens)) for h in hs] == eager[:4]
        assert eng.compiled_counts() == (1, 1)
        small = ServeEngine(m, 4, 128, num_blocks=12, **kw)
        assert _serve(small, prompts) == eager
        assert small.metrics.preempted >= 1


@pytest.mark.cuda
def test_serve_replay_sees_host_writes_between_ticks(cuda_device):
    """After capture, a block-table row, a position and an active flag
    written on the host are what the next decode replay reads."""
    from singa_tpu_torch.serve import ServeEngine
    m = _serve_models(cuda_device)[0]
    eng = ServeEngine(m, 4, 128, block_size=16)
    _serve(eng, _serve_prompts(4, m.cfg.vocab_size))   # warm-up + capture
    pool = eng.pool
    slot, (b0, b1) = pool.alloc_slot(), pool.alloc_blocks(2)
    pool.map_slot(slot, [b0, b1])
    pool.activate(slot, 20)               # next write: block b1, offset 4
    for ck, cv in pool.caches:
        ck[b1].zero_()
    eng._decode()
    torch.cuda.synchronize()
    want = [0] * 4
    want[slot] = 21
    assert pool.positions().tolist() == want
    ck = pool.caches[0][0]
    assert bool(ck[b1, 4].abs().sum() > 0)
    assert bool(ck[b1, 5:].abs().sum() == 0)
    assert bool(ck[b1, :4].abs().sum() == 0)
    pool.release(slot)
    eng._decode()
    torch.cuda.synchronize()
    assert pool.positions().tolist() == [0] * 4


@pytest.mark.cuda
def test_serve_bodies_do_not_sync_the_host(cuda_device):
    from singa_tpu_torch.serve import ServeEngine
    m = _serve_models(cuda_device)[0]
    eng = ServeEngine(m, 4, 128, block_size=16)
    _serve(eng, _serve_prompts(4, m.cfg.vocab_size))
    eng._chunk[:16].fill_(3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._prefill_body()
        eng._decode_body()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eng.compiled_counts() == (1, 1)


# -- speculation, the memory hierarchy and beam search ------------------------

def _spill_traffic(eng, vocab, n=12):
    """A request behind a 2-block system prompt, private prompts that
    evict (and so spill) its blocks, then the same system prompt again:
    the third request's stream."""
    rng = np.random.RandomState(5)
    system = rng.randint(0, vocab, 32)
    eng.submit(np.concatenate([system, rng.randint(0, vocab, 9)]),
               max_new_tokens=n)
    eng.run_until_idle()
    _serve(eng, [rng.randint(0, vocab, 60) for _ in range(4)], n)
    return _serve(eng, [np.concatenate([system, rng.randint(0, vocab, 7)])],
                  n)[0]


@pytest.mark.cuda
def test_spec_and_restore_programs_are_made_once(cuda_device):
    """spec_compiled_counts() is (1, 0, 1, 0) across traffic, (1, 1, 1, 0)
    after a verify fault falls back to plain decode, and stays there
    through a recovery; the streams equal an all-eager spec twin's.  A
    spill engine's restore program is made once, and its re-hit stream
    equals an engine's without the tier."""
    from singa_tpu_torch import faults
    from singa_tpu_torch.serve import ServeEngine, mem
    for m in _serve_models(cuda_device):
        prompts = _serve_prompts(6, m.cfg.vocab_size)
        kw = dict(block_size=16, param_dtype=torch.bfloat16, draft_model=m,
                  spec_k=3, backoff_base=0.001, backoff_max=0.01)
        eager = ServeEngine(m, 4, 128, **kw)
        eager._prefill, eager._verify = eager._prefill_body, \
            eager._verify_body
        want = _serve(eager, prompts)
        eng = ServeEngine(m, 4, 128, **kw)
        assert _serve(eng, prompts) == want
        assert eng.spec_compiled_counts() == (1, 0, 1, 0)
        assert eng._verify.graph.graph is not None
        plan = faults.FaultPlan([faults.FaultSpec("serve.verify", "error",
                                                  every=1, times=3)])
        with faults.active(plan), pytest.warns(UserWarning, match="verify"):
            assert _serve(eng, prompts[:3]) == want[:3]
        assert eng.metrics.spec_fallbacks >= 1
        assert eng.spec_compiled_counts() == (1, 1, 1, 0)
        hs = [eng.submit(p, max_new_tokens=12) for p in prompts[:3]]
        eng.step()
        eng.recover("test")
        eng.run_until_idle()
        assert [list(map(int, h.tokens)) for h in hs] == want[:3]
        assert eng.spec_compiled_counts() == (1, 1, 1, 0)
        kw = dict(block_size=16, num_blocks=12, param_dtype=torch.bfloat16)
        spill = ServeEngine(m, 2, 128, spill_blocks=32, **kw)
        again = _spill_traffic(spill, m.cfg.vocab_size)
        assert spill.metrics.prefetch_hits >= 2
        assert again == _spill_traffic(ServeEngine(m, 2, 128, **kw),
                                       m.cfg.vocab_size)
        assert mem.restore_compiled_count(spill.pool.restore) <= 1
        assert _spill_traffic(spill, m.cfg.vocab_size) is not None
        assert mem.restore_compiled_count(spill.pool.restore) == 1
        assert mem.restore_compiled_count() == 1


@pytest.mark.cuda
def test_verify_and_restore_bodies_do_not_sync_the_host(cuda_device):
    from singa_tpu_torch.serve import ServeEngine
    m = _serve_models(cuda_device)[0]
    eng = ServeEngine(m, 4, 128, block_size=16, draft_model=m, spec_k=2,
                      kv_dtype="int8", num_blocks=12, spill_blocks=32)
    _spill_traffic(eng, m.cfg.vocab_size)
    assert eng.pool.restore is not None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._verify_body()
        eng.pool.restore._body()
        eng._prefill_body()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_verify_and_restore_replays_see_host_writes(cuda_device):
    """After capture, a table row, a position and an active flag written
    on the host are what the next verify replay reads; a staging write
    and an index written on the host are what the next restore replay
    writes."""
    from singa_tpu_torch.serve import ServeEngine, mem
    m = _serve_models(cuda_device)[0]
    eng = ServeEngine(m, 4, 128, block_size=16, draft_model=m, spec_k=2,
                      num_blocks=12, spill_blocks=32)
    _spill_traffic(eng, m.cfg.vocab_size)
    _spill_traffic(eng, m.cfg.vocab_size)         # restore captured
    assert eng._verify.graph.graph is not None
    pool = eng.pool
    slot, (b0, b1) = pool.alloc_slot(), pool.alloc_blocks(2)
    pool.map_slot(slot, [b0, b1])
    pool.activate(slot, 14)          # the window 14..16 spans b0 and b1
    for ck, cv in pool.caches + pool.draft_caches:
        ck[b0, 14:].zero_()
        ck[b1].zero_()
    eng._verify()
    torch.cuda.synchronize()
    acc = int(eng._spec_out[slot, 0])
    assert int(pool.pos[slot]) == 14 + acc + 1
    for ck, _ in (pool.caches[0], pool.draft_caches[0]):
        assert bool(ck[b0, 14:].abs().sum(dim=(-2, -1)).gt(0).all())
        assert bool(ck[b1, 0].abs().sum() > 0)
        assert bool(ck[b1, 1:].abs().sum() == 0)
    pool.release(slot)
    restore = pool.restore
    assert restore.program.count == 1
    payload = mem.read_block(pool.caches, pool.draft_caches, b1)
    payload["event"].synchronize()
    for t in mem._leaves(payload["kv"]) + mem._leaves(payload["draft"]):
        t.fill_(1)
    mem.write_block(restore, b1, payload)
    torch.cuda.synchronize()
    assert bool((pool.caches[0][0][b1] == 1).all())
    assert bool((pool.draft_caches[1][1][b1] == 1).all())


@pytest.mark.cuda
def test_read_block_payload_is_not_a_view_of_the_arena(cuda_device):
    from singa_tpu_torch.serve import ServeEngine, mem
    m = _serve_models(cuda_device)[0]
    eng = ServeEngine(m, 2, 128, block_size=16, kv_dtype="int8")
    _serve(eng, _serve_prompts(2, m.cfg.vocab_size))
    pool = eng.pool
    before = [t[1].clone() for t in mem._leaves(pool.caches)]
    payload = mem.read_block(pool.caches, None, 1)
    for t in mem._leaves(pool.caches):
        t[1].fill_(7)                 # enqueued after the copies
    payload["event"].synchronize()
    for a, b in zip(before, mem._leaves(payload["kv"]), strict=True):
        assert b.is_pinned() and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_captured_beam_equals_eager_bitwise(cuda_device):
    for m in _serve_models(cuda_device):
        prompts = np.random.RandomState(3).randint(0, m.cfg.vocab_size,
                                                   (2, 24))
        for eos in (None, 7):
            kw = dict(max_new_tokens=10, num_beams=3, eos_id=eos,
                      param_dtype=torch.bfloat16, return_scores=True)
            want, wscore = m.generate_beam(prompts, use_graph=False, **kw)
            for _ in range(3):            # warm-up, capture, replay
                got, score = m.generate_beam(prompts, **kw)
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(score, wscore)
        sess = next(s for k, s in m._gen_sessions.items() if k[0] == "beam")
        assert sess.graphs["tick"].graph is not None


# -- the disaggregated tier ---------------------------------------------------

def _tier_engines(m, n_decode=1):
    """A bf16 prefill engine and `n_decode` decode engines sharing its
    weight copy, each warmed (its programs captured) by one request."""
    from singa_tpu_torch.serve import ServeEngine
    kw = dict(block_size=16, param_dtype=torch.bfloat16)
    src = ServeEngine(m, 4, 128, **kw)
    dsts = [ServeEngine(m, 4, 128, programs=src.programs(), **kw)
            for _ in range(n_decode)]
    warm = _serve_prompts(1, m.cfg.vocab_size, seed=3)
    for eng in [src] + dsts:
        _serve(eng, warm)
        _serve(eng, warm)
    return src, dsts


def _parked(src, prompts, n=12):
    """Submit `prompts` to `src` and tick it without decode: each is
    prefilled and parked with its first token.  Their handles."""
    hs = [src.submit(p, max_new_tokens=n) for p in prompts]
    src.step(decode=False)
    assert len(src.running_items()) == len(prompts)
    return hs


@pytest.mark.cuda
def test_two_extracted_packages_do_not_alias(cuda_device):
    """Two packages extracted back to back (the handoff program's
    static buffer written twice) own their KV: both injected afterwards
    give the single engine's streams bitwise."""
    m = _serve_models(cuda_device)[0]
    prompts = _serve_prompts(2, m.cfg.vocab_size, seed=13)
    src, (dst,) = _tier_engines(m)
    want = _serve(src, prompts)
    hs = _parked(src, prompts)
    pkgs = [src.extract_handoff(s) for s, _ in src.running_items()]
    assert src.handoff_compiled_count() == 1
    assert src._handoff.graph.graph is not None       # captured at the 2nd
    ptrs = {t.data_ptr() for p in pkgs for kv in p.kv for t in kv}
    assert len(ptrs) == 2 * 2 * len(pkgs[0].kv)
    assert not ptrs & {t.data_ptr() for kv in src._hout for t in kv}
    assert all(dst.inject_handoff(p) for p in pkgs)
    dst.run_until_idle()
    assert [list(map(int, h.tokens)) for h in hs] == want


@pytest.mark.cuda
def test_inject_writes_the_arena_in_place(cuda_device):
    """An inject leaves the addresses of the arena and the token vector
    unchanged — the captured decode graph reads them — and the next
    decode replay reads the injected blocks: the stream equals the
    single engine's."""
    m = _serve_models(cuda_device)[0]
    prompts = _serve_prompts(1, m.cfg.vocab_size, seed=17)
    src, (dst,) = _tier_engines(m)
    want = _serve(src, prompts)
    assert dst._decode.graph.graph is not None
    ptrs = [t.data_ptr() for kv in dst.pool.caches for t in kv]
    ptrs.append(dst._toks.data_ptr())
    (h,) = _parked(src, prompts)
    (slot, _), = src.running_items()
    assert dst.inject_handoff(src.extract_handoff(slot))
    assert [t.data_ptr() for kv in dst.pool.caches for t in kv] + \
        [dst._toks.data_ptr()] == ptrs
    dst.run_until_idle()
    assert [list(map(int, h.tokens))] == want
    assert dst.compiled_counts() == (1, 1)


@pytest.mark.cuda
def test_bf16_package_round_trips_through_the_codec(cuda_device):
    """A bf16 package from the card encodes and decodes to the same
    bits, and the decoded (host) package injected on the card gives the
    single engine's stream."""
    from singa_tpu_torch.serve.net import codec
    m = _serve_models(cuda_device)[1]
    prompts = _serve_prompts(1, m.cfg.vocab_size, seed=19)
    src, (dst,) = _tier_engines(m)
    want = _serve(src, prompts)
    (h,) = _parked(src, prompts)
    (slot, _), = src.running_items()
    pkg = src.extract_handoff(slot)
    back = codec.decode_package(codec.encode_package(pkg))
    assert len(back.kv) == len(pkg.kv) == m.cfg.num_layers
    for (k, v), (bk, bv) in zip(pkg.kv, back.kv):
        assert k.dtype == bk.dtype == torch.bfloat16
        assert torch.equal(k.cpu(), bk) and torch.equal(v.cpu(), bv)
    back.req = pkg.req               # the handle the test holds
    assert dst.inject_handoff(back)
    dst.run_until_idle()
    assert [list(map(int, h.tokens))] == want


# -- sliding-window and mixture-of-experts configurations ---------------------

def _config_llama(cuda_device, f32=False, **kw):
    """The tiny Llama at head_dim 32 with a window or experts; `f32`
    computes in f32 on the card (its default is bf16 activations)."""
    dev = cuda_device
    if f32:
        dev = tdevice.create_device("cuda")
        dev.default_dtype = torch.float32
    cfg = dataclasses.replace(LlamaConfig.tiny(), dim=128, max_position=1024,
                              fused_loss=True, **kw)
    return Llama(cfg, device=dev,
                 generator=torch.Generator("cuda").manual_seed(0))


_CONFIGS = {"window": dict(sliding_window=128),
            "moe": dict(num_experts=4, moe_top_k=2, moe_capacity_factor=2.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(_CONFIGS))
def test_config_captured_train_step_equals_eager_bitwise(cuda_device, kind):
    """A windowed (all three kernels banded at T = 512 > W) and an MoE
    train step: the captured steps' losses equal the eager ones bitwise,
    each kernel launches once per layer a step, and the captured body's
    warm-up syncs nothing with the host."""
    batches = _batches(5)
    runs = {}
    for use_graph in (False, True):
        m = _config_llama(cuda_device, **_CONFIGS[kind])
        m.set_optimizer(topt.SGD(lr=0.01, momentum=0.9))
        m.compile([batches[0]], is_train=True, use_graph=use_graph)
        losses = []
        for i, x in enumerate(batches):
            tfa.reset_device_launches()
            if use_graph and i == 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                _, loss = m.train_step(x)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            losses.append(loss.item())
            assert tfa.device_launches() == dict.fromkeys(
                tfa.KERNELS, m.cfg.num_layers)
        runs[use_graph] = losses
        if kind == "moe":
            assert all(blk.ffn._aux_losses == [] for blk in m.blocks)
    assert m.graph.graph is not None
    assert runs[True] == runs[False]
    assert len(set(runs[False])) == len(runs[False])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(_CONFIGS))
def test_config_engine_streams_equal_generate(cuda_device, kind):
    """Computing in f32 on the card, the paged engine's streams (prompts
    past the window; MoE at the dropless factor) equal generate()'s,
    and its programs stay within (1, 1)."""
    from singa_tpu_torch.serve import ServeEngine
    m = _config_llama(cuda_device, f32=True, **_CONFIGS[kind])
    prompts = _serve_prompts(6, m.cfg.vocab_size, lo=130, hi=300)
    eng = ServeEngine(m, 4, 512, block_size=16)
    got = _serve(eng, prompts)
    want = [list(map(int, m.generate(p[None], max_new_tokens=12)
                     [0, p.size:])) for p in prompts]
    assert got == want
    assert eng.compiled_counts() == (1, 1)
    assert eng._decode.graph.graph is not None


# -- the vision zoo ------------------------------------------------------------------

def _cifar_resnet18(dev, seed=0):
    from singa_tpu_torch import models
    gen = torch.Generator(dev.torch_device.type).manual_seed(seed)
    return models.resnet18(device=dev, generator=gen)


def _images(b, hw=32, seed=0):
    gen = torch.Generator("cuda").manual_seed(seed)
    return (torch.randn(b, hw, hw, 3, generator=gen, device="cuda"),
            torch.randint(0, 10, (b,), generator=gen, device="cuda"))


@pytest.fixture
def deterministic_cudnn():
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_cnn_captured_train_step_equals_eager_bitwise(cuda_device,
                                                      deterministic_cudnn):
    """CIFAR ResNet-18 in bf16: 5 captured steps (eager, warm-up,
    capture + replay, 2 replays) and 5 eager steps of a second model
    from the same seed, on two alternating batches: the same losses,
    parameters and BatchNorm running statistics, bit for bit."""
    batches = [_images(8, seed=s) for s in (1, 2)]
    runs = {}
    for use_graph in (False, True):
        m = _cifar_resnet18(cuda_device)
        m.set_optimizer(topt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4))
        m.compile([batches[0][0]], is_train=True, use_graph=use_graph)
        losses = [m.train_step(*batches[i % 2])[1].item() for i in range(5)]
        runs[use_graph] = (losses, {n: t.detach().clone() for n, t in
                                    m.get_states().items()})
    assert m.get_graph("train").graph is not None
    assert runs[True][0] == runs[False][0]
    for n, t in runs[False][1].items():
        assert torch.equal(runs[True][1][n], t), n
    assert not torch.equal(runs[True][1]["bn1.running_mean"],
                           torch.zeros(64, device="cuda"))


@pytest.mark.cuda
def test_cnn_captured_eval_equals_eager(cuda_device, deterministic_cudnn):
    """The eval step captured (third call) and replayed reads the running
    statistics by address: after a train step moves them, a replay
    equals an eager eval forward."""
    m = _cifar_resnet18(cuda_device)
    x, y = _images(8)
    m.compile([x], is_train=False, use_graph=True)
    outs = [m(x) for _ in range(3)]
    assert m.get_graph("eval").graph is not None
    m.set_optimizer(topt.SGD(lr=0.1, momentum=0.9))
    m.train_step(x, y)            # a train executor's first call: eager
    m.eval()
    replay = m(x)
    assert not torch.equal(replay, outs[-1])
    m.compile([x], is_train=False, use_graph=False)
    eager = m(x)
    assert outs[0].dtype == torch.float32
    assert torch.equal(replay, eager)


@pytest.mark.cuda
def test_cnn_f32_forward_matches_the_cpu(cuda_device):
    """The card's f32 forward (TF32 off) and one step's loss and
    gradients against the port on the CPU with the same weights: logits
    within 1e-4 of the largest, loss 1e-5 relative, each gradient
    within 2e-2 by Frobenius norm (a ReLU input within rounding of 0
    takes the other branch on one side)."""
    from singa_tpu_torch import autograd
    m = _cifar_resnet18(cuda_device)
    host = _cifar_resnet18(tdevice.create_device("cpu"))
    host.set_states({n: t.cpu() for n, t in m.get_states().items()})
    x, y = _images(8)

    def step(model, xs, ys):
        with autograd.train_mode():
            logits = model.forward(xs).float()
            loss = autograd.softmax_cross_entropy(logits, ys)
            grads = {p.param_name: g.cpu() for p, g in
                     autograd.backward(loss)}
        return logits.detach().cpu(), loss.item(), grads
    card = step(m, x, y)
    cpu = step(host, x.cpu(), y.cpu())
    assert (card[0] - cpu[0]).abs().max() <= 1e-4 * cpu[0].abs().max()
    assert abs(card[1] - cpu[1]) <= 1e-5 * abs(cpu[1])
    for n, g in cpu[2].items():
        assert (card[2][n] - g).norm() <= 2e-2 * g.norm(), n


@pytest.mark.cuda
def test_cnn_captured_dropout_draws_new_masks_and_equals_eager(
        cuda_device, deterministic_cudnn):
    """AlexNet at 64² with dropout 0.5: a captured train step registers
    the dropout generator, so each replay draws new masks.  At lr 0 the
    parameters stay put and six steps on one batch give six different
    losses (a mask frozen at capture would repeat the third's); at lr
    0.01 the captured run from a generator seed equals an eager run
    from the same seed bit for bit, in losses and parameters."""
    from singa_tpu_torch import models
    x, y = _images(8, hw=64)
    for lr in (0.0, 0.01):
        runs = {}
        for use_graph in (False, True):
            gen = torch.Generator("cuda").manual_seed(0)
            m = models.AlexNet(num_classes=10, dropout=0.5,
                               input_shape=(64, 64, 3), device=cuda_device,
                               generator=gen)
            cuda_device.SetRandSeed(7)        # the dropout layers' generator
            m.set_optimizer(topt.SGD(lr=lr))
            m.compile([x], is_train=True, use_graph=use_graph)
            losses = [m.train_step(x, y)[1].item() for _ in range(6)]
            runs[use_graph] = (losses, {n: t.detach().clone() for n, t in
                                        m.get_params().items()})
        assert m.get_graph("train").graph is not None
        assert runs[True][0] == runs[False][0], lr
        for n, t in runs[False][1].items():
            assert torch.equal(runs[True][1][n], t), (lr, n)
        if lr == 0.0:
            assert len(set(runs[True][0])) == 6, runs[True][0]


# -- the transformer family ------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2, 512, 30522],
                         ids=["token_types", "positions", "vocab"])
def test_embedding_gradient_repeats_bitwise(cuda_device, rows):
    """The table gradient at BERT-base's training shape (B=256 x T=128,
    dim 768) sums each row's repeats in one order: five backwards give
    the same bits, within f32 rounding of a float64 sum, with torch's
    deterministic mode left off.  The ids repeat as BERT's do: token
    types mostly 0, every position 256 times, and vocabulary ids drawn
    from a Zipf law (the commonest id thousands of times)."""
    from singa_tpu_torch import autograd as tautograd
    b, t, d = 256, 128, 768             # token types: the one-hot product
    rng = np.random.RandomState(0)
    if rows == 2:
        ids = (rng.rand(b, t) < 0.1).astype(np.int64)
    elif rows == 512:
        ids = np.broadcast_to(np.arange(t), (b, t)).copy()
    else:
        ids = np.minimum(rng.zipf(1.2, (b, t)) - 1, rows - 1)
    ids = torch.as_tensor(ids, device="cuda")
    g = torch.Generator("cuda").manual_seed(1)
    dy = torch.randn(b, t, d, generator=g, device="cuda")
    table = torch.zeros(rows, d, device="cuda", requires_grad=True)
    assert not torch.are_deterministic_algorithms_enabled()
    grads = [torch.autograd.grad(tautograd.embedding(table, ids), table,
                                 dy)[0] for _ in range(5)]
    assert not torch.are_deterministic_algorithms_enabled()
    for gr in grads[1:]:
        assert torch.equal(gr, grads[0])
    want = torch.zeros(rows, d, dtype=torch.float64).index_add_(
        0, ids.reshape(-1).cpu(), dy.reshape(-1, d).double().cpu())
    err = (grads[0].double().cpu() - want).abs().max() / want.abs().max()
    assert err < 1e-5, err


@pytest.mark.cuda
def test_gpt2_captured_train_step_equals_eager_bitwise(cuda_device):
    """GPT-2 at its width (dim 768, 12 heads of 64) cut to 2 layers, at
    T = 512 (the flash route) with dropout 0.1 and the fused loss: six
    captured steps equal six eager ones from the same weights and
    dropout seed bit for bit, in losses and parameters, and each step
    launches every kernel once a layer."""
    from singa_tpu_torch.models import GPT2, GPT2Config
    cfg = GPT2Config(num_layers=2, fused_loss=True)
    rng = np.random.RandomState(4)
    batches = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 512)),
                               device="cuda") for _ in range(6)]
    runs = {}
    for use_graph in (False, True):
        m = GPT2(cfg, device=cuda_device,
                 generator=torch.Generator("cuda").manual_seed(0))
        cuda_device.SetRandSeed(3)            # the dropout layers' generator
        m.set_optimizer(topt.SGD(lr=0.01, momentum=0.9))
        m.compile([batches[0]], is_train=True, use_graph=use_graph)
        losses = []
        for x in batches:
            tfa.reset_device_launches()
            losses.append(m.train_step(x)[1].item())
            assert tfa.device_launches() == dict.fromkeys(tfa.KERNELS, 2)
        runs[use_graph] = (losses, {n: t.detach().clone()
                                    for n, t in m.get_params().items()})
    assert m.get_graph("train").graph is not None
    assert runs[True][0] == runs[False][0]
    assert np.isfinite(runs[True][0]).all()
    for n, t in runs[False][1].items():
        assert torch.equal(runs[True][1][n], t), n


@pytest.mark.cuda
def test_bert_routes_t128_to_the_plain_path(cuda_device):
    """BERT at T = 128 runs the plain attention (the route starts at
    512, as the reference's), with or without a padding mask: no flash
    launch in a training step or an eval."""
    from singa_tpu_torch.models import BERT, BERTConfig
    m = BERT(BERTConfig(num_layers=2, num_labels=2), device=cuda_device,
             generator=torch.Generator("cuda").manual_seed(0))
    m.set_optimizer(topt.SGD(lr=0.01, momentum=0.9))
    ids = torch.randint(0, 30522, (4, 128), device="cuda")
    y = torch.tensor([0, 1, 1, 0], device="cuda")
    mask = torch.ones((4, 128), dtype=torch.int32, device="cuda")
    mask[:, 100:] = 0
    tfa.reset_device_launches()
    m.compile([ids], is_train=True, use_graph=False)
    _, loss = m.train_step(ids, y)
    m.eval()
    logits = m(ids, None, mask)
    assert tfa.device_launches() == dict.fromkeys(tfa.KERNELS, 0)
    assert np.isfinite(loss.item()) and logits.shape == (4, 2)


def _onnx_bert(device, num_layers=2, b=4, t=128):
    """BERT at its width (dim 768, 12 heads) cut to `num_layers`, from
    seed 0, exported by the port at (b, t) and re-imported on `device`:
    the rep, its ids and labels."""
    from singa_tpu_torch import sonnx
    from singa_tpu_torch.models import BERT, BERTConfig
    m = BERT(BERTConfig(num_layers=num_layers, num_labels=2), device=device,
             generator=torch.Generator("cuda").manual_seed(0))
    rng = np.random.RandomState(5)
    ids = torch.as_tensor(rng.randint(0, 30522, (b, t)), device="cuda")
    y = torch.as_tensor(rng.randint(0, 2, b), device="cuda")
    data = sonnx.to_onnx(m, [ids]).SerializeToString()
    return sonnx.prepare(data, device=device), ids, y


@pytest.mark.cuda
def test_onnx_bert_captured_train_step_equals_eager_bitwise(cuda_device):
    """A BERT exported and re-imported trains through compile(use_graph=
    True): five captured steps equal five eager ones from the same
    weights bit for bit, in losses and parameters; no flash launch."""
    from singa_tpu_torch import autograd as tautograd
    runs = {}
    for use_graph in (False, True):
        rep, ids, y = _onnx_bert(cuda_device)
        rep.set_optimizer(topt.SGD(lr=0.01, momentum=0.9))
        rep.set_loss(tautograd.softmax_cross_entropy)
        rep.compile([ids], is_train=True, use_graph=use_graph)
        tfa.reset_device_launches()
        losses = [rep.train_step(ids, y)[1].item() for _ in range(5)]
        assert tfa.device_launches() == dict.fromkeys(tfa.KERNELS, 0)
        runs[use_graph] = (losses, {n: t.detach().clone()
                                    for n, t in rep.get_params().items()})
    assert rep.get_graph("train").graph is not None
    assert runs[True][0] == runs[False][0]
    assert np.isfinite(runs[True][0]).all()
    for n, t in runs[False][1].items():
        assert torch.equal(runs[True][1][n], t), n


@pytest.mark.cuda
def test_onnx_shape_lane_captures_without_a_host_sync(cuda_device):
    """Shape → Gather → Concat → Reshape folds on the host: the eval
    step's warm-up runs under set_sync_debug_mode("error"), its capture
    replays, and the captured output equals the eager one."""
    from singa_tpu_torch.sonnx import proto
    f32, mk = proto.TensorProto.FLOAT, proto.make_node
    nodes = [mk("MatMul", ["x", "w"], ["h"]),
             mk("Shape", ["h"], ["s"]),
             mk("Gather", ["s", "i0"], ["d0"], axis=0),
             mk("Concat", ["d0", "neg1"], ["tgt"], axis=0),
             mk("Reshape", ["h", "tgt"], ["y"])]
    w = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    g = proto.make_graph(
        nodes, "g", [proto.make_tensor_value_info("x", f32, [2, 3, 4])],
        [proto.make_tensor_value_info("y", f32, [2, 15])],
        [proto.from_array(w, "w"),
         proto.from_array(np.array([0], np.int64), "i0"),
         proto.from_array(np.array([-1], np.int64), "neg1")])
    from singa_tpu_torch import sonnx
    rep = sonnx.prepare(proto.make_model(g), device=cuda_device)
    x = torch.randn(2, 3, 4, device="cuda")
    rep.eval()
    with torch.no_grad():
        eager = rep(x)
        rep.compile([x], is_train=False, use_graph=True)
        outs = [rep(x)]
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(rep(x))             # warm-up, then capture
            outs.append(rep(x))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs.append(rep(x))
    assert rep.get_graph("eval").graph is not None
    assert eager.shape == (2, 15)
    for o in outs:
        assert torch.equal(o, eager)


# -- data parallel over NCCL (one card: a world of 1) -------------------------

@pytest.fixture
def nccl_world(cuda_device):
    """An NCCL process group of 1 on a free local port, with the data
    mesh set; destroyed after the test."""
    import os
    import socket

    from singa_tpu_torch import parallel
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    parallel.init_distributed(f"127.0.0.1:{port}", 1, 0)
    parallel.set_mesh(parallel.data_parallel_mesh())
    try:
        assert torch.distributed.get_backend() == "nccl"
        yield cuda_device
    finally:
        parallel.finalize_distributed()


_DIST_MODES = {"plain": {}, "int8_ring": {"compression": "int8_ring"},
               "zero1": {"shard_weight_update": True}}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(_DIST_MODES))
def test_distopt_captured_step_equals_eager_bitwise(nccl_world, mode):
    """The tiny Llama through DistOpt over NCCL: five captured steps
    (collectives in the graph) equal five eager ones bitwise in losses,
    parameters and slots, each flash kernel once per layer a step, and
    the captured body's warm-up syncs nothing with the host."""
    batches = _batches(5)
    runs = {}
    for use_graph in (False, True):
        m = _small_llama(nccl_world)
        m.set_optimizer(topt.DistOpt(topt.SGD(lr=0.01, momentum=0.9),
                                     **_DIST_MODES[mode]))
        m.compile([batches[0]], is_train=True, use_graph=use_graph)
        losses = []
        for i, x in enumerate(batches):
            tfa.reset_device_launches()
            if use_graph and i == 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                _, loss = m.train_step(x)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            losses.append(loss.item())
            assert tfa.device_launches() == dict.fromkeys(
                tfa.KERNELS, m.cfg.num_layers)
        slots = {n: [t.clone() for t in topt._leaves(v)]
                 for n, v in m.optimizer._eager_state.items()}
        runs[use_graph] = (losses, {n: p.detach().clone()
                                    for n, p in m.get_params().items()},
                           slots)
    assert m.graph.graph is not None
    (le, pe, se), (lc, pc, sc) = runs[False], runs[True]
    assert lc == le and len(set(le)) == len(le)
    for n in pe:
        assert torch.equal(pc[n], pe[n]), n
        assert all(torch.equal(a, b) for a, b in zip(sc[n], se[n])), n
    if mode == "int8_ring":
        assert any(s[-1].abs().sum() > 0 for s in sc.values())


@pytest.mark.cuda
def test_plain_distopt_at_world_one_is_the_base_step(nccl_world):
    """At a world of 1 the plain DistOpt step (an NCCL allreduce of one
    rank, a product with 1.0) equals the base optimizer's, bitwise,
    eagerly and captured."""
    batches = _batches(4)
    runs = {}
    for wrap in (False, True):
        m = _small_llama(nccl_world)
        base = topt.SGD(lr=0.01, momentum=0.9)
        m.set_optimizer(topt.DistOpt(base) if wrap else base)
        m.compile([batches[0]], is_train=True, use_graph=True)
        runs[wrap] = ([m.train_step(x)[1].item() for x in batches],
                      {n: p.detach().clone()
                       for n, p in m.get_params().items()})
    assert runs[True][0] == runs[False][0]
    for n, p in runs[False][1].items():
        assert torch.equal(runs[True][1][n], p), n


# -- tensor and sequence parallelism on one card -----------------------------

@pytest.mark.cuda
def test_three_axis_step_is_the_plain_step_bitwise(nccl_world):
    """Under make_mesh({'data': 1, 'model': 1, 'seq': 1}) every Linear and
    embedding runs its Megatron form, each collective over a group of
    one, the step captured: five steps equal the plain step's bitwise in
    losses and parameters."""
    m = _small_llama(nccl_world)
    same = kernel_check.spmd_vs_plain(
        m, _batches(5), lambda: topt.SGD(lr=0.01, momentum=0.9))
    assert same["bitwise"], same
    assert same["gspmd"] and same["captured"]
    assert same["collectives_staged_first_step"] > 0
    layers = m.cfg.num_layers
    assert same["forms"] == {"column": 5 * layers + 1, "row": 2 * layers,
                             "embedding": 1, "whole": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", kernel_check.RING_DTYPES)
@pytest.mark.parametrize("case", list(kernel_check.RING_CASES))
def test_ring_body_matches_whole_sequence_attention(cuda_device, case,
                                                    dtype):
    """Ring attention's per-rank body over the shards of one card at
    base()'s attention shape: o, lse and dq/dk/dv within the flash
    limits of the plain whole-sequence attention, each kernel launched
    `ring_launches` times."""
    r = kernel_check.check_ring(case, dtype)
    assert r["ok"], r
    assert r["launches_ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(kernel_check.RING_FAULTS))
def test_planted_ring_fault_fails_the_limits(cuda_device, fault):
    case, dtype, _ = kernel_check.RING_FAULTS[fault]
    S, causal = kernel_check.RING_CASES[case]
    with kernel_check.ring_fault(fault):
        r = kernel_check.ring_errors(*kernel_check.ring_inputs(case, dtype),
                                     S, causal, dtype)
    assert not r["ok"], r


# -- pipeline stages and expert ranks on one card ------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", kernel_check.PIPE_DTYPES)
def test_pipe_body_matches_the_blocks_in_order(cuda_device, dtype):
    """base()'s 16 blocks through the per-rank GPipe body of every
    PIPE_CASES case with an in-process hop: output and gradients within
    PIPE_RTOL of the blocks in order, each flash kernel launched once a
    block a microbatch."""
    from singa_tpu_torch import autograd
    autograd.set_training(True)
    try:
        blocks, x, do = kernel_check.pipe_blocks(dtype)
        want = kernel_check.seq_run(blocks, x, do)
        for case in kernel_check.PIPE_CASES:
            r = kernel_check.check_pipe(case, dtype, blocks, x, do, want)
            assert r["ok"] and r["launches_ok"], (case, r)
    finally:
        autograd.set_training(False)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(kernel_check.PIPE_FAULTS))
def test_planted_pipe_fault_fails_the_limits(cuda_device, fault):
    case, dtype, _ = kernel_check.PIPE_FAULTS[fault]
    S, M = kernel_check.PIPE_CASES[case]
    blocks, x, do = kernel_check.pipe_blocks(dtype, num_layers=4)
    want = kernel_check.seq_run(blocks, x, do)
    with kernel_check.pipe_fault(fault):
        r = kernel_check.pipe_errors(kernel_check.pipe_run(blocks, x, do, S,
                                                           M), want, dtype)
    assert not r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", kernel_check.EP_DTYPES)
def test_expert_ranks_match_the_one_device_scatter_path(cuda_device, dtype):
    """Mixtral-8x7B's MoE layer at published widths over 2 and 4
    in-process expert ranks (einsum dispatch, partial outputs summed):
    output rows, aux loss and every gradient within the EP limits of
    the one-device scatter path."""
    inputs = kernel_check.ep_inputs(dtype)
    want = kernel_check.ep_run(*inputs, 0)
    for case, ep in kernel_check.EP_CASES.items():
        r = kernel_check.ep_errors(kernel_check.ep_run(*inputs, ep), want,
                                   dtype)
        assert r["ok"], (case, r)


@pytest.mark.cuda
def test_planner_bytes_are_what_a_captured_step_holds(cuda_device):
    """base() cut to 2 blocks, planned at a world of 1 under SGD with
    momentum: its parameter, slot and gradient bytes are those the model
    and optimizer hold after a captured step."""
    from singa_tpu_torch.parallel import planner
    cfg = dataclasses.replace(LlamaConfig.base(), num_layers=2,
                              fused_loss=True)
    sgd = lambda: topt.SGD(lr=0.01, momentum=0.9)   # noqa: E731
    plan = planner.plan_train_step(
        lambda d: Llama(cfg, device=d), sgd(),
        ((torch.Size([2, 512]), torch.int32),), {"data": 1})
    m = Llama(cfg, device=cuda_device,
              generator=torch.Generator("cuda").manual_seed(0))
    x = torch.randint(0, cfg.vocab_size, (2, 512), dtype=torch.int32,
                      device="cuda")
    m.set_optimizer(sgd())
    m.compile([x], is_train=True, use_graph=True)
    for _ in range(3):
        m.train_step(x)
    params = m.get_params().values()
    assert m.graph.graph is not None
    assert plan.param_bytes_per_device == sum(
        p.numel() * p.element_size() for p in params)
    assert plan.slot_bytes_per_device == sum(
        t.numel() * t.element_size()
        for ls in m.optimizer.slot_arrays().values() for t in ls)
    assert plan.grad_bytes_per_device == sum(
        p.grad.numel() * p.grad.element_size() for p in params)
    assert torch.cuda.get_device_properties(0).total_memory == \
        planner.HBM_BYTES["h100"] or "H100" not in \
        torch.cuda.get_device_name(0)


# -- the serving operator's tools on the card --------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("smoke", ["spec", "spill", "disagg", "mp"])
def test_loadgen_smokes_pass_on_the_card(cuda_device, smoke):
    """The load driver's smokes on the card (tiny, f32): streams bitwise
    against generate() and a single engine, the mp smoke across two
    worker processes with their own CUDA contexts."""
    from singa_tpu_torch.tools import loadgen
    assert getattr(loadgen, f"{smoke}_smoke")("tiny", None, "cuda") == 0


@pytest.mark.cuda
def test_chaos_smoke_holds_on_the_card(cuda_device, tmp_path):
    """One SIGKILL and one SIGSTOP against a 1:1 process tier on the
    card: streams bitwise, both deaths timed, both respawns adopted."""
    from singa_tpu_torch.tools import chaosd
    fails, res = chaosd.run_smoke(str(tmp_path / "r.jsonl"),
                                  device="cuda")
    assert fails == []
    assert len(res["timings"]["detect_s"]) == 2
    assert len(res["timings"]["respawn_s"]) == 2


@pytest.mark.cuda
def test_autotune_train_point_runs_the_kernels(nccl_world):
    """A train sweep point at T = 1024 (base() cut to 1 layer) launches
    each flash kernel once per layer per timed replay, counted on the
    card."""
    from singa_tpu_torch.tools import autotune as at_cli
    launches = []
    measure = at_cli.train_measure(nccl_world, config="base", layers=1,
                                   seq=1024, steps=3, launches=launches)
    step_ms, feats = measure({"batch": 2, "ce_chunk": 256, "int8_ring": 1})
    assert step_ms > 0 and feats["flops"] > 0
    assert feats["graph_pool_bytes"] > 0 and feats["wire_bytes"] == 0
    assert launches == [dict.fromkeys(tfa.KERNELS, 3)]


@pytest.mark.cuda
def test_perf_attr_payload_on_the_card(cuda_device):
    """A load run's perf_attr payload on the card validates; the
    achieved fraction is taken against the card's peaks."""
    from singa_tpu_torch.obs import attr as obs_attr
    from singa_tpu_torch.obs import cost as obs_cost
    from singa_tpu_torch.obs import schema
    from singa_tpu_torch.serve import ServeEngine
    from singa_tpu_torch.tools import loadgen
    m = tier_model(cuda_device)
    eng = ServeEngine(m, 4, 64, block_size=8, param_dtype=torch.bfloat16)
    loadgen._warm(eng, m.cfg.vocab_size, 0)
    led = obs_attr.install()
    try:
        load = loadgen.run_load(eng, loadgen.build_workload(8, 500.0, 0))
    finally:
        obs_attr.uninstall()
    payload = obs_cost.perf_attr_payload(led.snapshot(), eng,
                                         load["detail"]["wall_s"])
    eng.close()
    schema.validate_perf_attr_payload(payload)
    assert {"prefill_chunk", "decode"} <= payload["programs"].keys()
    assert 0.0 < payload["attributed_frac"] <= 1.0


# -- fault-tolerant training runs (singa_tpu_torch.train) ------------------------

def _run_gpt2(device, dropout=0.1):
    """GPT-2 at tiny widths with dropout and AdamW on `device`, weights
    from seed 0, compiled for T = 64 (the plain attention path)."""
    from singa_tpu_torch.models import GPT2, GPT2Config
    cfg = dataclasses.replace(GPT2Config.tiny(), dropout=dropout,
                              fused_loss=True)
    m = GPT2(cfg, device=device,
             generator=torch.Generator(device.torch_device.type)
             .manual_seed(0))
    m.set_optimizer(topt.AdamW(lr=1e-3, weight_decay=0.1))
    m.compile([torch.zeros(4, 64, dtype=torch.int32,
                           device=device.torch_device)],
              is_train=True, use_graph=True)
    return m


@pytest.mark.cuda
def test_registered_generator_state_resumes_a_captured_steps_masks(
        cuda_device):
    """A captured step's replays advance its registered dropout
    generator on the host as eager steps do: after five steps (two
    eager, a capture, two replays) its state equals that of an eager
    run's generator after five steps, and that state set into a fresh
    model's generator, before the fresh model captures, reproduces the
    next replays' masks (at lr 0 the parameters stay put, so the losses
    differ only by the masks) — eagerly and through its own capture."""
    x = torch.as_tensor(np.random.RandomState(1).randint(0, 256, (4, 64)),
                        dtype=torch.int32, device="cuda")

    def model(use_graph, lr=0.0):
        m = _run_gpt2(tdevice.create_device("cuda"))
        m.set_optimizer(topt.SGD(lr=lr))
        m.compile([x], is_train=True, use_graph=use_graph)
        return m
    captured, eager = model(True), model(False)
    for _ in range(5):
        captured.train_step(x)
        eager.train_step(x)
    assert captured.get_graph("train").graph is not None
    state = captured.device.generator.get_state()
    assert torch.equal(state, eager.device.generator.get_state())
    fresh = model(True)
    fresh.device.generator.set_state(state)
    for _ in range(4):                   # eager, warm-up, capture, replay
        a = captured.train_step(x)[1]
        b = fresh.train_step(x)[1]
        assert torch.equal(a, b)
    assert fresh.get_graph("train").graph is not None
    assert torch.equal(fresh.device.generator.get_state(),
                       captured.device.generator.get_state())


@pytest.mark.cuda
def test_train_runner_resumes_a_captured_step_bitwise(cuda_device,
                                                      tmp_path):
    """TrainRunner on the card: tiny GPT-2 with dropout 0.1 and AdamW,
    8 steps straight against 5 steps (saves at 3 and, final, 5), then a
    fresh model resumed in the same process to 8: losses, every
    parameter, the Adam moments, the optimizer counter and the
    generator state bitwise; the step was captured in every run, and
    the records name the card."""
    from singa_tpu_torch.obs.record import RunRecord
    from singa_tpu_torch.train import AsyncCheckpointManager, TrainRunner
    from singa_tpu_torch.utils.data import DataLoader
    data = np.random.RandomState(2).randint(0, 256, (64, 64)).astype(
        np.int32)
    store = str(tmp_path / "records.jsonl")

    def run(d, total):
        m = _run_gpt2(tdevice.create_device("cuda"))
        losses = {}
        r = TrainRunner(m, DataLoader(data, batch_size=4, seed=1,
                                      drop_last=True), total,
                        ckpt=AsyncCheckpointManager(str(tmp_path / d),
                                                    save_every=3),
                        record_store=store,
                        on_step=lambda s, o: losses.__setitem__(s, o[1]))
        res = r.run()
        r.__exit__()
        assert m.get_graph("train").graph is not None
        return m, {s: float(v) for s, v in losses.items()}, res

    straight, want, _ = run("a", 8)
    _, first, _ = run("b", 5)
    resumed, rest, res = run("b", 8)
    assert res.resumed_from == 5 and res.steps == 8
    assert {**first, **rest} == want
    for n, t in straight.get_states().items():
        assert torch.equal(resumed.get_states()[n], t), n
    for n, leaves in straight.optimizer.slot_arrays().items():
        for a, b in zip(leaves, resumed.optimizer.slot_arrays()[n]):
            assert torch.equal(a, b), n
    assert resumed.optimizer.step_counter == straight.optimizer.step_counter
    assert torch.equal(resumed.device.generator.get_state(),
                       straight.device.generator.get_state())
    entries = RunRecord(store).entries()
    assert {e["platform"] for e in entries} == {"cuda"}
    assert entries[-1]["device"] == torch.cuda.get_device_name(0)
    assert RunRecord(store).validate() == []


def _gpt2_remat_runs(cfg, batches, steps_each):
    """Plain and remat GPT-2 at `cfg` from the same weights (loaded by
    name) and dropout seed, each trained on `batches` through
    compile(use_graph=True): (losses, parameters after, generator state
    after, device launches a step, the train graph's recorded launches)
    by remat flag."""
    from singa_tpu_torch.model import _dropout_generators
    from singa_tpu_torch.models import GPT2
    runs, start = {}, None
    for remat in (False, True):
        dev = tdevice.create_device("cuda")
        m = GPT2(dataclasses.replace(cfg, remat=remat), device=dev,
                 generator=torch.Generator("cuda").manual_seed(0))
        if start is None:
            start = {n: p.detach().clone() for n, p in m.get_params().items()}
        m.set_params(start)
        (gen,) = _dropout_generators(m)
        gen.manual_seed(3)
        m.set_optimizer(topt.SGD(lr=0.01, momentum=0.9))
        m.compile([batches[0]], is_train=True, use_graph=True)
        losses, per_step = [], []
        for x in batches[:steps_each]:
            tfa.reset_device_launches()
            losses.append(m.train_step(x)[1].item())
            per_step.append(tfa.device_launches())
        runs[remat] = (losses, {n: t.detach().clone()
                                for n, t in m.get_params().items()},
                       gen.get_state(), per_step,
                       m.get_graph("train").launches)
        del m
    return runs


@pytest.mark.cuda
def test_gpt2_remat_captured_step_equals_plain_bitwise(cuda_device):
    """GPT-2 at its width cut to 2 layers, T = 512 (the flash route),
    dropout 0.1, fused loss: with every block under layer.Remat, two
    eager and two captured steps equal the plain model's bit for bit in
    losses, parameters and the dropout generator's state; a remat step
    launches the forward kernel twice a block (the recompute) and each
    backward kernel once."""
    from singa_tpu_torch.models import GPT2Config
    cfg = GPT2Config(num_layers=2, fused_loss=True)
    rng = np.random.RandomState(4)
    batches = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 512)),
                               device="cuda") for _ in range(4)]
    runs = _gpt2_remat_runs(cfg, batches, 4)
    (l0, p0, s0, n0, g0), (l1, p1, s1, n1, g1) = runs[False], runs[True]
    assert l1 == l0 and np.isfinite(l0).all()
    for n, t in p0.items():
        assert torch.equal(p1[n], t), n
    assert torch.equal(s1, s0)
    assert all(n == dict.fromkeys(tfa.KERNELS, 2) for n in n0)
    assert all(n == kernel_check.remat_launches(2) for n in n1)
    assert g1 == kernel_check.remat_launches(2)
    assert g0 == dict.fromkeys(tfa.KERNELS, 2)


@pytest.mark.cuda
def test_lstm_captured_train_step_equals_eager_bitwise(cuda_device):
    """The char-rnn at the example's widths (two LSTMs of 128 over an
    embedding of 64): captured steps equal eager ones from the same
    weights and batches bit for bit, in losses and parameters."""
    from singa_tpu_torch.tools import train_rnn
    b, t = kernel_check.CHAR_RNN_BATCH
    chars = sorted(set(train_rnn.CORPUS))
    data = np.asarray([chars.index(c) for c in train_rnn.CORPUS], np.int32)
    rng = np.random.RandomState(0)
    batches = [tuple(torch.as_tensor(a, device="cuda")
                     for a in train_rnn.batches(data, b, t, rng))
               for _ in range(5)]
    runs = {}
    for use_graph in (False, True):
        m = train_rnn.CharRNN(len(chars), device=cuda_device,
                              generator=torch.Generator("cuda").manual_seed(0),
                              **kernel_check.CHAR_RNN)
        m.set_optimizer(topt.Adam(lr=kernel_check.CHAR_RNN_LR))
        m.compile([batches[0][0]], is_train=True, use_graph=use_graph)
        losses = [m.train_step(x, y)[1].item() for x, y in batches]
        runs[use_graph] = (losses, {n: p.detach().clone()
                                    for n, p in m.get_params().items()})
    assert m.get_graph("train").graph is not None
    assert runs[True][0] == runs[False][0]
    assert runs[True][0][-1] < runs[True][0][0]
    for n, p in runs[False][1].items():
        assert torch.equal(runs[True][1][n], p), n


@pytest.mark.cuda
def test_generator_state_rewinds_inside_a_capture(cuda_device):
    """What layer.Remat's recompute relies on: inside a CUDA-graph
    capture, a registered generator's get_state / set_state read and
    move the captured offset.  A draw after set_state(the state before
    the first draw) repeats the first at every replay, and restoring
    the state found after it leaves the generator, replay after replay,
    where a capture of the first draw alone leaves it."""
    def capture(redraw):
        g = torch.Generator("cuda").manual_seed(0)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(g)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=s):
            st = g.get_state()
            a = torch.empty(4096, device="cuda").bernoulli_(0.5, generator=g)
            b = None
            if redraw:
                after = g.get_state()
                g.set_state(st)
                b = torch.empty(4096, device="cuda").bernoulli_(
                    0.5, generator=g)
                g.set_state(after)
        out = []
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            out.append((a.clone(), None if b is None else b.clone(),
                        g.get_state()))
        return out
    once, redrawn = capture(False), capture(True)
    for (a0, _, s0), (a1, b1, s1) in zip(once, redrawn):
        assert torch.equal(a1, b1) and torch.equal(a0, a1)
        assert torch.equal(s0, s1)
    assert not torch.equal(once[0][0], once[1][0])     # replays draw anew


def _picker(device):
    """Rows of an (11, 8) table picked by ids through autograd.gather
    (``jnp.take``: an out-of-range id reads NaN, zeroed here), a Linear
    to 5 classes, then two positions of the (B, T, 5) logits through
    autograd.index: position 1 by a Python int and one by a 0-dim id
    tensor, which may lie past the end (it then reads the last position
    and passes no gradient)."""
    from singa_tpu_torch import autograd, layer, model

    class Picker(model.Model):
        def __init__(self):
            super().__init__(device=device)
            g = torch.Generator(device.torch_device).manual_seed(0)
            self.table = self._new_param((11, 8))
            with torch.no_grad():
                self.table.normal_(generator=g)
            self.head = layer.Linear(5, 8, device=device, generator=g)

        def forward(self, ids, pos):
            rows = autograd.gather(self.table, 0, ids)
            rows = autograd.where(autograd.equal(rows, rows), rows, 0.0)
            logits = self.head(rows)
            return autograd.add(autograd.index(logits, (slice(None), 1)),
                                autograd.index(logits, (slice(None), pos)))

        def train_one_batch(self, ids, pos, y):
            out = self.forward(ids, pos)
            loss = self.loss(out, y)
            self.optimizer.backward_and_update(loss)
            return out, loss

    return Picker()


@pytest.mark.cuda
def test_index_and_gather_capture_with_out_of_range_ids(cuda_device):
    """autograd.index and autograd.gather read nothing back to the host,
    so a train step calling them with out-of-range ids is captured as a
    CUDA graph; its replays equal the eager steps bit for bit, and the
    rows read only through an out-of-range id (row 10, by the clamped
    ids 11 and 15 at position 1; row 9, at the position the past-the-end
    id clamps to) take no gradient."""
    b, t = 4, 6
    ids = np.random.RandomState(0).randint(0, 9, (b, t))
    ids[:2, 1] = [11, 15]
    ids[:, t - 1] = 9
    ids = torch.as_tensor(ids, device="cuda")
    pos = torch.tensor(t + 3, device="cuda")
    y = torch.as_tensor([0, 3, 1, 4], device="cuda")
    runs = {}
    for use_graph in (False, True):
        m = _picker(cuda_device)
        start = m.table.detach().clone()
        m.set_optimizer(topt.SGD(lr=0.1))
        m.compile([ids, pos], is_train=True, use_graph=use_graph)
        losses = [m.train_step(ids, pos, y)[1].item() for _ in range(5)]
        runs[use_graph] = (losses, m.table.detach().clone())
    assert m.get_graph("train").graph is not None
    assert runs[True][0] == runs[False][0]
    assert all(np.isfinite(runs[True][0]))
    assert torch.equal(runs[True][1], runs[False][1])
    table = runs[True][1]
    assert torch.equal(table[9:], start[9:])
    assert not torch.equal(table[int(ids[2, 1])], start[int(ids[2, 1])])


@pytest.mark.cuda
def test_hf_layout_round_trip_on_the_card(cuda_device):
    """A tiny Llama, a windowed one (the window binds at P = 512) and an
    MoE one in the Mixtral layout written by hand, through the HF layout
    and its importers on the card (no transformers): parameters,
    configuration, logits and greedy streams bitwise the source's, the
    flash forward once a layer a generate() call (the hf phase's
    `hf_round_trip`)."""
    import chip_smoke

    checks = []
    base = dict(vocab_size=256, dim=256, num_layers=2, num_heads=4,
                num_kv_heads=2, ffn_dim=512, max_position=1024,
                rope_theta=10000.0)
    for kw, export in ((dict(rope_scaling=8.0,
                             rope_scaling_original_max_position=256), None),
                       (dict(sliding_window=256), None),
                       (dict(num_experts=4, moe_top_k=2,
                             moe_capacity_factor=2.0),
                        chip_smoke.mixtral_layout)):
        src = Llama(LlamaConfig(**base, **kw), device=cuda_device,
                    generator=torch.Generator("cuda").manual_seed(0))
        res, _ = chip_smoke.hf_round_trip(
            src, str(kw), lambda ok, msg: checks.append((ok, msg)),
            export=export, gen=(1, 512, 4))
        assert res["generate"]["launches"]["imported"]["flash_fwd"] == 2
    assert [msg for ok, msg in checks if not ok] == []


@pytest.mark.cuda
def test_tensor_functions_on_the_card(cuda_device):
    """Every function of singa_tpu_torch.tensor on the card against numpy
    (the tensor phase's `tensor_checks`, at a smaller shape)."""
    import chip_smoke
    from singa_tpu_torch import tensor as ttensor

    rows = chip_smoke.tensor_checks(cuda_device, (1024, 512))
    assert len(rows) == len(ttensor.__all__) - 1
    assert [r for r in rows if not r["ok"]] == []


# -- the native core on the card's host ----------------------------------------

def _compiled_cifar_resnet18(dev, b):
    from singa_tpu_torch import models
    m = models.resnet18(device=dev,
                        generator=torch.Generator("cuda").manual_seed(0))
    m.set_optimizer(topt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4))
    g = torch.Generator("cuda").manual_seed(1)
    x = torch.randn((b, 32, 32, 3), generator=g, device="cuda")
    y = torch.randint(0, 10, (b,), generator=g, device="cuda")
    m.compile([x], is_train=True, use_graph=True)
    return m, x, y.to(torch.int32)


@pytest.mark.cuda
def test_native_loader_feeds_a_captured_cnn_step(cuda_device):
    """DataLoader(use_native=True) with 4 workers through
    prefetch_to_device into a captured CIFAR ResNet-18 step, two epochs
    (kernel_check.native_feed): every batch's rows are x[labels] and
    every label comes once an epoch, as phase native checks at
    ResNet-50's cell."""
    from singa_tpu_torch.utils.data import DataLoader
    b = 64
    m, x0, y0 = _compiled_cifar_resnet18(cuda_device, b)
    for _ in range(3):                    # eager, warm-up, capture
        m.train_step(x0, y0)
    x, labels = kernel_check.native_set(3 * b, (32, 32, 3), seed=2)
    loader = DataLoader(x, labels, batch_size=b, seed=0, use_native=True,
                        workers=kernel_check.NATIVE_WORKERS,
                        prefetch=kernel_check.NATIVE_PREFETCH)
    r = kernel_check.native_feed(lambda xb, yb: m.train_step(xb, yb)[1],
                                 loader, torch.from_numpy(x).cuda())
    loader.close()
    assert r["rows_match_labels"] and r["each_label_once_per_epoch"]
    assert len(r["losses"]) == 3 * kernel_check.NATIVE_EPOCHS
    assert np.isfinite(r["losses"]).all()
    assert m.graph.graph is not None


@pytest.mark.cuda
def test_schedule_of_a_card_step(cuda_device):
    """schedule() of a captured CIFAR ResNet-18 step on the card: traced
    on demand over fake tensors, an order that respects the traced
    graph's dependencies, an arena beside the capture's pool."""
    m, x, y = _compiled_cifar_resnet18(cuda_device, 32)
    for _ in range(3):
        m.train_step(x, y)
    g = m.get_graph("train")
    s = g.schedule()
    assert s.num_nodes > 100 and s.arena_bytes > 0 and g.pool_bytes > 0
    assert kernel_check.schedule_is_topological(s)


@pytest.mark.cuda
def test_native_cpu_leaves_a_card_step_as_it_was(cuda_device):
    """native_cpu() is False for the card's device, and with the native
    CPU device as the default a captured card step launches the same
    kernels, its losses bitwise, no host kernel called."""
    from singa_tpu_torch import _core

    cfg = dataclasses.replace(LlamaConfig.tiny(), dim=128, max_position=1024,
                              fused_loss=True)
    ids = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 512))

    def run():
        m = Llama(cfg, device=cuda_device,
                  generator=torch.Generator("cuda").manual_seed(0))
        m.set_optimizer(topt.SGD(lr=0.01, momentum=0.9))
        m.compile([ids], is_train=True, use_graph=True)
        tfa.reset_device_launches()
        losses = [m.train_step(ids)[1].item() for _ in range(4)]
        return losses, tfa.device_launches(), m.graph.launches

    tdevice.set_default_device(cuda_device)
    assert not tdevice.native_cpu()
    plain = run()
    tdevice.set_default_device(tdevice.create_cpu_device(use_native=True))
    try:
        assert tdevice.native_cpu()
        _core.reset_stats()
        native = run()
        assert _core.stats["calls"] == 0
    finally:
        tdevice.set_default_device(None)
    assert native == plain


# -- the example entry points (singa_tpu_torch.tools) -------------------------

@pytest.mark.cuda
def test_train_llama_command_trains_captured_and_generates(cuda_device,
                                                           capsys):
    """`train_llama --preset tiny --steps 3 --generate 4` on the card: the
    third step is the captured one, the loss falls, four tokens."""
    from singa_tpu_torch.tools import train_llama
    out = train_llama.main(["--preset", "tiny", "--steps", "3",
                            "--generate", "4"])
    assert out["device"].startswith("cuda") and out["train_captured"]
    assert np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    assert len(out["generated"]) == 4
    printed = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in printed if ln.startswith("step ")] \
        == ["step 0", "step 1", "step 2"]


@pytest.mark.cuda
def test_resume_demo_crashes_and_resumes_bitwise_on_the_card(
        cuda_device, tmp_path, monkeypatch):
    """`resume_demo --crash-at 25` ends its process at step 25; the rerun
    resumes from the newest commit and its losses and final loss are an
    uninterrupted run's, bitwise."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    from singa_tpu_torch.tools import resume_demo
    root = Path(__file__).resolve().parents[1]
    crash = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.tools.resume_demo",
         "--crash-at", "25"], cwd=tmp_path, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(root)), timeout=600)
    assert crash.returncode == 1, crash.stderr[-2000:]
    monkeypatch.chdir(tmp_path)
    resumed = resume_demo.main([])
    whole = resume_demo.main(["--ckpt-dir", "whole"])
    assert resumed["device"].startswith("cuda")
    assert resumed["resumed_from"] >= 0 and whole["resumed_from"] == -1
    n = len(resumed["losses"])
    assert resumed["losses"] == whole["losses"][-n:]
    assert resumed["final_loss"] == whole["final_loss"]
