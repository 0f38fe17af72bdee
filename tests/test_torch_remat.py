"""``layer.Remat`` (activation checkpointing) in the port, on the CPU.

Inside the port: a tiny GPT-2 with dropout 0.1 gives, with remat and
without, bitwise-equal losses, gradients and dropout-generator states
over three steps (the recompute applies the forward's masks); so does a
tiny Llama; a BatchNorm block and an MoE block warn and run plain.
Against the JAX package: GPT2Config.tiny() (dropout 0) with remat has
the reference's parameter names, follows the reference remat model's
loss trajectory, and still decodes the reference's greedy tokens; a
checkpoint of a remat model loads into a plain one and back.

Tolerances: inside the port, exact (the same ops on the same inputs);
against the reference (f32 on both sides, op order differs): losses
within rtol 1e-4 over three steps, greedy tokens identical."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import transformer as jtr
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import opt as topt
from singa_tpu_torch.models import (GPT2, GPT2Config, Llama, LlamaConfig,
                                    load_reference_params)
from singa_tpu_torch.models import transformer as ttr
from singa_tpu_torch.train import AsyncCheckpointManager

B, T = 2, 16
STEPS = 3
LOSS_RTOL = 1e-4
CPU = tdevice.create_device("cpu")


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(CPU)
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)
    jautograd.set_training(False)


def _ids(shape=(B, T), seed=3, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def ref():
    """The reference tiny GPT-2 with remat: its initial parameters by
    name, STEPS SGD losses from them, and greedy tokens of a prompt."""
    jtensor.set_seed(0)
    jm = jtr.GPT2(dataclasses.replace(jtr.GPT2Config.tiny(), remat=True))
    x = jtensor.from_numpy(_ids())
    jm.compile([x], is_train=False, use_graph=False)
    arrays = {n: np.asarray(t.data) for n, t in jm.get_params().items()}
    tokens = jm.generate(_ids((B, 8), seed=6), max_new_tokens=8)
    jm.set_optimizer(jopt.SGD(lr=0.05, momentum=0.9))
    jm.compile([x], is_train=True, use_graph=True)
    losses = [float(np.asarray(jm.train_step(x)[1].data))
              for _ in range(STEPS)]
    jautograd.set_training(False)
    return {"arrays": arrays, "losses": losses, "tokens": tokens,
            "names": list(arrays)}


def _gpt2(remat, **kw):
    cfg = dataclasses.replace(GPT2Config.tiny(), remat=remat, **kw)
    return GPT2(cfg, device=CPU, generator=torch.Generator().manual_seed(0))


def _steps(m, ids, steps=3, lr=0.05):
    """`steps` forward/backward/SGD steps from the device generator's
    seed 0: each step's loss, gradients by name and generator state."""
    CPU.generator.manual_seed(0)
    m.train(True)
    x = torch.from_numpy(ids)
    params = m.get_params()
    names = {id(p): n for n, p in params.items()}
    out = []
    for _ in range(steps):
        loss = ttr.next_token_loss(m(x), x)
        grads = dict(sorted((names[id(p)], g)
                            for p, g in tautograd.backward(loss)))
        with torch.no_grad():
            for n, g in grads.items():
                params[n] -= lr * g
        out.append((loss.detach(), grads, CPU.generator.get_state()))
    m.train(False)
    return out


def _assert_bitwise(a, b):
    for (l0, g0, s0), (l1, g1, s1) in zip(a, b):
        assert torch.equal(l0, l1)
        assert list(g0) == list(g1)
        for n in g0:
            assert torch.equal(g0[n], g1[n]), n
        assert torch.equal(s0, s1)


def test_gpt2_with_dropout_is_bitwise_the_plain_model():
    ids = _ids()
    plain, remat = _gpt2(False, dropout=0.1), _gpt2(True, dropout=0.1)
    assert all(isinstance(b, tlayer.Remat) for b in remat.blocks)
    runs = [_steps(plain, ids), _steps(remat, ids)]
    _assert_bitwise(*runs)
    # dropout drew: the generator moved, and the masks changed the loss
    assert not torch.equal(runs[0][0][2], runs[0][1][2])


def test_remat_recomputes_through_checkpoint_once_a_block(monkeypatch):
    calls = []
    real = tlayer.checkpoint

    def spy(fn, *a, **kw):
        calls.append(kw)
        return real(fn, *a, **kw)
    monkeypatch.setattr(tlayer, "checkpoint", spy)
    m = _gpt2(True, dropout=0.1)
    x = torch.from_numpy(_ids())
    with torch.no_grad():
        m(x)
    m.train(True)
    with torch.no_grad():
        m(x)                       # no gradients: nothing to checkpoint
    assert calls == []
    m(x)
    assert len(calls) == m.cfg.num_layers
    assert all(kw["use_reentrant"] is False for kw in calls)


def test_llama_remat_is_bitwise_the_plain_model():
    cfg = LlamaConfig.tiny()
    ids = _ids(vocab=cfg.vocab_size)
    runs = []
    for remat in (False, True):
        m = Llama(dataclasses.replace(cfg, remat=remat), device=CPU,
                  generator=torch.Generator().manual_seed(1))
        runs.append(_steps(m, ids, steps=2))
    _assert_bitwise(*runs)


def _bn_block():
    g = torch.Generator().manual_seed(2)
    return tlayer.Sequential(
        tlayer.Conv2d(4, 3, 3, padding=1, device=CPU, generator=g),
        tlayer.BatchNorm2d(4, device=CPU), tlayer.ReLU())


def _moe_block():
    return tlayer.MoE(4, ffn_dim=16, dim=8, device=CPU,
                      generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("make,shape,why", [
    (_bn_block, (2, 5, 5, 3), "buffers"),
    (_moe_block, (2, 6, 8), "side-channel layers \\(MoE\\)")],
    ids=["batchnorm", "moe"])
def test_unreplayable_blocks_warn_and_run_plain(make, shape, why):
    x = torch.from_numpy(np.random.RandomState(4).randn(*shape).astype(
        np.float32))
    plain, wrapped = make(), tlayer.Remat(make())
    assert not wrapped.remat_safe and not plain.remat_safe
    tautograd.set_training(True)
    y0 = plain(x)
    with pytest.warns(UserWarning, match=why):
        y1 = wrapped(x)
    assert torch.equal(y0, y1)
    g0 = torch.autograd.grad(y0.sum(), list(plain.parameters()))
    g1 = torch.autograd.grad(y1.sum(), list(wrapped.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert list(plain.get_states()) == list(wrapped.get_states())


def test_a_cache_argument_bypasses_with_the_warning():
    m = _gpt2(True)
    blk = m.blocks[0]
    x = torch.zeros(1, 4, 64)
    cache = (torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4, 16))
    tautograd.set_training(True)
    with pytest.warns(UserWarning, match="unsupported extra arg tuple"):
        y, _ = blk(x, None, cache, 0)
    tautograd.set_training(False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        y2, _ = blk(x, None, cache, 0)      # eval: straight through
    assert torch.equal(y, y2)


def test_param_keys_are_the_reference_and_transparent(ref):
    plain, remat = _gpt2(False), _gpt2(True)
    assert list(remat.get_params()) == list(plain.get_params()) \
        == ref["names"]
    assert list(remat.get_states()) == list(plain.get_states())
    assert list(remat.state_dict()) == list(plain.state_dict())
    blk = remat.blocks[0]
    assert list(blk.get_params()) == list(blk.inner.get_params())
    assert blk.attn is blk.inner.attn and blk.drop.p == blk.inner.drop.p


def test_remat_losses_follow_the_reference_remat_model(ref):
    m = _gpt2(True)
    load_reference_params(m, ref["arrays"])
    m.set_optimizer(topt.SGD(lr=0.05, momentum=0.9))
    ids = _ids()
    m.compile([ids], is_train=True, use_graph=True)
    losses = [m.train_step(ids)[1].item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]


def test_remat_model_generates_the_reference_tokens(ref):
    m = _gpt2(True)
    load_reference_params(m, ref["arrays"])
    out = m.generate(_ids((B, 8), seed=6), max_new_tokens=8)
    np.testing.assert_array_equal(out, ref["tokens"])


def test_checkpoints_cross_between_remat_and_plain(ref, tmp_path):
    src = _gpt2(True)
    load_reference_params(src, ref["arrays"])
    path = str(tmp_path / "remat.ckpt")
    src.save_states(path)
    plain = _gpt2(False)
    plain.load_states(path)
    back = _gpt2(True)
    with AsyncCheckpointManager(str(tmp_path / "run")) as ckpt:
        ckpt.save(1, plain)
        ckpt.wait()
        ckpt.load_step(1, back)
    for n, p in src.get_states().items():
        assert torch.equal(plain.get_states()[n], p)
        assert torch.equal(back.get_states()[n], p)
