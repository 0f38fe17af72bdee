"""The port's mixture-of-experts FFN (ops/moe.py, layer.MoE) and the MoE
Llama against the JAX package's, on the CPU, on numpy-seeded inputs:
routing, dispatch and the balance loss; `moe_forward` in both token
movements, forward and gradients; and LlamaConfig.tiny() with 4
experts, top-2, at capacity factors 2.0 (dropless: E / k) and 1.25
(capacity drops), with the reference's weights carried over by
`load_reference_params`, through training (with the aux term),
`generate()` and the paged ServeEngine.

Tolerances (both sides f32, differing in op order only):
  * routing: expert ids, slots and keep flags exact; gates, probs,
    combine weights and the balance loss atol 1e-6;
  * `moe_forward` outputs and gradients: atol 1e-5;
  * the model's logits: atol 1e-4; its gradients rtol 1e-4, atol 1e-5
    (the router's softmax sends ~1e-6 of rounding into the embedding's
    smallest gradient entries);
  * ten SGD steps: every loss within rtol 1e-4;
  * greedy token streams: identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import transformer as jtr
from singa_tpu.ops import moe as jmoe
from singa_tpu.serve import ServeEngine as JEngine
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import opt as topt
from singa_tpu_torch.models import Llama, LlamaConfig, load_reference_params
from singa_tpu_torch.models import transformer as ttr
from singa_tpu_torch.ops import moe as tmoe
from singa_tpu_torch.serve import ServeEngine

E, K = 4, 2
B, T = 2, 16
STEPS = 10
SLOTS, MAX_LEN, BS = 4, 32, 8
FAST = dict(backoff_base=0.001, backoff_max=0.01)
DROPLESS = E / K


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)
    jautograd.set_training(False)


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)


# -- routing, dispatch and the balance loss --------------------------------------

@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [1, 3, 16])
def test_route_dispatch_and_balance_loss_match(k, capacity):
    logits = np.random.RandomState(k * 10 + capacity).randn(12, E) \
        .astype(np.float32)
    ref = jmoe._route(jnp.asarray(logits), capacity, k)
    got = tmoe._route(torch.from_numpy(logits), capacity, k)
    for name, r, g, exact in zip(
            ("e_flat", "gate_flat", "pos", "keep", "probs", "onehot"),
            ref, got, (True, False, True, True, False, True)):
        if exact:
            np.testing.assert_array_equal(_np(g), _np(r), err_msg=name)
        else:
            np.testing.assert_allclose(_np(g), _np(r), atol=1e-6,
                                       err_msg=name)
    rc, rp, ro = jmoe.moe_dispatch(jnp.asarray(logits), capacity, k)
    tc, tp, to = tmoe.moe_dispatch(torch.from_numpy(logits), capacity, k)
    np.testing.assert_allclose(_np(tc), _np(rc), atol=1e-6)
    np.testing.assert_allclose(
        _np(tmoe.load_balance_loss(tp, to)),
        _np(jmoe.load_balance_loss(rp, ro)), atol=1e-6)
    if capacity == 1:
        assert not _np(got[3]).all(), "capacity 1 must drop assignments"


def test_top2_capacity_priority_is_rank_major():
    """A later token's first choice beats an earlier token's second
    choice for the last slot (tests/test_moe.py's case)."""
    logits = np.array([[2.0, 5.0], [5.0, 2.0]], np.float32)
    ref = _np(jmoe.moe_dispatch(jnp.asarray(logits), 1, 2)[0])
    got = _np(tmoe.moe_dispatch(torch.from_numpy(logits), 1, 2)[0])
    np.testing.assert_allclose(got, ref, atol=1e-7)
    assert (got[1, 0] > 0).any() and (got[0, 0] == 0).all()
    assert (got[0, 1] > 0).any() and (got[1, 1] == 0).all()


_MOE_CASES = {
    "k1_ample": dict(capacity_factor=4.0, top_k=1, gate=False),
    "k1_drops": dict(capacity_factor=0.5, top_k=1, gate=False),
    "k2_ample": dict(capacity_factor=4.0, top_k=2, gate=False),
    "k2_drops_swiglu": dict(capacity_factor=0.6, top_k=2, gate=True),
    "k2_dropless_swiglu": dict(capacity_factor=DROPLESS, top_k=2, gate=True),
}


def _moe_inputs(seed, n=16, d=8, h=12):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) * sc for s, sc in (
        ((n, d), 1.0), ((d, E), 0.5), ((E, d, h), 0.3), ((E, h, d), 0.3),
        ((E, d, h), 0.3), ((n, d), 1.0))]


@pytest.mark.parametrize("case", list(_MOE_CASES))
def test_moe_forward_both_dispatches_match_reference(case):
    """scatter and einsum token movement: forward, the balance loss, and
    the gradients of sum(out * dout) + aux in x and every weight."""
    c = _MOE_CASES[case]
    x, rw, wi, wo, wg, dout = _moe_inputs(len(case))
    nw = 5 if c["gate"] else 4
    kw = dict(capacity_factor=c["capacity_factor"], top_k=c["top_k"],
              return_aux=True)

    def jfn(*a):
        out, aux = jmoe.moe_forward(*a[:4], w_gate=a[4] if c["gate"] else None,
                                    dispatch_mode="scatter", **kw)
        return jnp.sum(out * dout) + aux, (out, aux)
    (_, (jout, jaux)), jg = jax.value_and_grad(
        jfn, argnums=tuple(range(nw)), has_aux=True)(
        *map(jnp.asarray, (x, rw, wi, wo, wg)[:nw]))
    outs = {}
    for mode in ("scatter", "einsum", "auto"):
        ts = [torch.tensor(a, requires_grad=True)
              for a in (x, rw, wi, wo, wg)[:nw]]
        out, aux = tmoe.moe_forward(*ts[:4], w_gate=ts[4] if c["gate"]
                                    else None, dispatch_mode=mode, **kw)
        grads = torch.autograd.grad(
            (out * torch.from_numpy(dout)).sum() + aux, ts)
        np.testing.assert_allclose(_np(out), _np(jout), atol=1e-5,
                                   err_msg=mode)
        np.testing.assert_allclose(_np(aux), _np(jaux), atol=1e-6,
                                   err_msg=mode)
        for i, (g, r) in enumerate(zip(grads, jg)):
            np.testing.assert_allclose(_np(g), _np(r), atol=1e-5,
                                       err_msg=f"{mode} grad {i}")
        outs[mode] = _np(out)
    np.testing.assert_allclose(outs["einsum"], outs["scatter"], atol=1e-5)
    np.testing.assert_array_equal(outs["auto"], outs["scatter"])


def test_moe_layer_records_aux_only_in_training():
    moe = tlayer.MoE(E, ffn_dim=12, capacity_factor=2.0, top_k=2,
                     act="swiglu", dim=8,
                     generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_moe_inputs(0)[0])
    with tautograd.eval_mode():
        moe(x)
    assert moe.aux_loss is None and moe.pop_aux_loss() is None
    with tautograd.train_mode():
        moe(x)
        moe(x)
    first, second = moe._aux_losses
    assert moe.aux_loss is second
    assert torch.equal(moe.pop_aux_loss(), first + second)
    assert moe.pop_aux_loss() is None and moe._aux_losses == []
    assert [n for n, _ in moe.named_parameters()] == \
        ["router", "w_in", "w_out", "w_gate"]
    with pytest.raises(ValueError, match="top_k"):
        tlayer.MoE(E, 8, top_k=5, dim=8)
    with pytest.raises(ValueError, match="act"):
        tlayer.MoE(E, 8, act="gelu", dim=8)


# -- the MoE tiny Llama --------------------------------------------------------------

def _cfgs(cf, **kw):
    moe = dict(num_experts=E, moe_top_k=K, moe_capacity_factor=cf, **kw)
    return (dataclasses.replace(jmodels.LlamaConfig.tiny(), **moe),
            dataclasses.replace(LlamaConfig.tiny(), **moe))


@pytest.fixture(scope="module")
def ids():
    return np.random.RandomState(3).randint(0, 256, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_arrays(ids):
    """The reference MoE tiny Llama's initial parameters, by name."""
    jtensor.set_seed(0)
    jm = jmodels.Llama(_cfgs(DROPLESS)[0])
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    return {n: np.asarray(t.data) for n, t in jm.get_params().items()}


def _jmodel(ref_arrays, ids, cf, **kw):
    jm = jmodels.Llama(_cfgs(cf, **kw)[0])
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    for n, t in jm.get_params().items():
        t.data = jnp.asarray(ref_arrays[n])
    return jm


def _tmodel(ref_arrays, cf, **kw):
    tm = Llama(_cfgs(cf, **kw)[1], device=tdevice.create_device("cpu"))
    load_reference_params(tm, ref_arrays)
    return tm


def _port_loss(tm, ids):
    x = torch.from_numpy(ids)
    loss = ttr.next_token_loss(tm(x), x)
    return loss + tm._moe_aux_loss() * tm.cfg.moe_aux_weight


@pytest.mark.parametrize("cf", [DROPLESS, 1.25])
def test_logits_and_gradients_with_aux_match_reference(ref_arrays, ids, cf):
    jm = _jmodel(ref_arrays, ids, cf)
    x = jtensor.from_numpy(ids)
    jm.train(True)
    jlogits = jm.forward(x)
    jloss = jtr.next_token_loss(jlogits, x)
    jloss = jloss + jautograd.mul(jm._moe_aux_loss(), jm.cfg.moe_aux_weight)
    names = {id(t): n for n, t in jm.get_params().items()}
    jgrads = {names[id(p)]: np.asarray(g.data)
              for p, g in jautograd.backward(jloss)}

    tm = _tmodel(ref_arrays, cf)
    assert list(tm.get_params()) == list(ref_arrays)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(ids)).numpy(),
                                   np.asarray(jlogits.data), atol=1e-4)
    tm.train(True)
    tloss = _port_loss(tm, ids)
    tgrads = {p.param_name: g.numpy() for p, g in tautograd.backward(tloss)}
    np.testing.assert_allclose(tloss.item(), np.asarray(jloss.data).item(),
                               rtol=1e-6)
    assert sorted(tgrads) == sorted(jgrads)
    for n, g in jgrads.items():
        np.testing.assert_allclose(tgrads[n], g, rtol=1e-4, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("cf", [DROPLESS, 1.25])
def test_sgd_trajectory_with_aux_matches_reference(ref_arrays, ids, cf):
    jm = _jmodel(ref_arrays, ids, cf, fused_loss=True)
    jm.set_optimizer(jopt.SGD(lr=0.05, momentum=0.9))
    x = jtensor.from_numpy(ids)
    jm.compile([x], is_train=True, use_graph=True)
    jlosses = [float(np.asarray(jm.train_step(x)[1].data))
               for _ in range(STEPS)]
    tm = _tmodel(ref_arrays, cf, fused_loss=True)
    tm.set_optimizer(topt.SGD(lr=0.05, momentum=0.9))
    tm.compile([ids], is_train=True, use_graph=True)
    tlosses = [tm.train_step(ids)[1].item() for _ in range(STEPS)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
    assert all(blk.ffn._aux_losses == [] for blk in tm.blocks)


def test_flops_per_token_counts_active_experts(ref_arrays, ids):
    jm, tm = _jmodel(ref_arrays, ids, DROPLESS), _tmodel(ref_arrays, DROPLESS)
    assert tm.num_params() == jm.num_params()
    for t in (16, 64):
        assert tm.flops_per_token(t) == jm.flops_per_token(t)


def test_remat_skips_moe_blocks(ref_arrays, ids):
    """remat=True with MoE: the same losses as remat=False over three
    steps, and one aux term per block per forward (a block recomputed in
    the backward would record a second)."""
    runs = []
    for remat in (False, True):
        tm = _tmodel(ref_arrays, DROPLESS, remat=remat)
        assert not any(blk.remat_safe for blk in tm.blocks)
        tm.train(True)
        x = torch.from_numpy(ids)
        loss = ttr.next_token_loss(tm(x), x)
        counts = [len(blk.ffn._aux_losses) for blk in tm.blocks]
        loss = loss + tm._moe_aux_loss() * tm.cfg.moe_aux_weight
        tautograd.backward(loss)
        counts += [len(blk.ffn._aux_losses) for blk in tm.blocks]
        tm.set_optimizer(topt.SGD(lr=0.05, momentum=0.9))
        tm.compile([ids], is_train=True, use_graph=True)
        runs.append(([tm.train_step(ids)[1].item() for _ in range(3)],
                     counts))
    assert runs[0] == runs[1]
    assert runs[0][1] == [1] * tm.cfg.num_layers + [0] * tm.cfg.num_layers


def test_pipeline_stages_still_raise():
    """MoE blocks with pipeline_stages build, as the reference's do: the
    stack names the side channel that keeps it sequential (it is never
    cut into stages) instead of raising."""
    cfg = dataclasses.replace(_cfgs(DROPLESS)[1], pipeline_stages=2)
    m = Llama(cfg, device=tdevice.create_device("cpu"))
    assert type(m.blocks).__name__ == "PipelineStack"
    assert "side-channel" in m.blocks._structural_blocker()


@pytest.fixture(scope="module")
def serving(ref_arrays, ids):
    """(JAX model, port model, JAX engine, port engine) at the dropless
    factor, eval mode."""
    jm = _jmodel(ref_arrays, ids, DROPLESS)
    jm.eval()
    tm = _tmodel(ref_arrays, DROPLESS)
    return (jm, tm, JEngine(jm, SLOTS, MAX_LEN, block_size=BS, **FAST),
            ServeEngine(tm, SLOTS, MAX_LEN, block_size=BS, **FAST))


def _prompts(lens, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("cf", [DROPLESS, 1.25])
def test_greedy_generate_matches_reference(ref_arrays, ids, serving, cf):
    jm = serving[0] if cf == DROPLESS else _jmodel(ref_arrays, ids, cf)
    tm = serving[1] if cf == DROPLESS else _tmodel(ref_arrays, cf)
    prompt = np.stack(_prompts((12, 12)))
    ref = jm.generate(prompt, max_new_tokens=6)
    for use_graph in (True, False):
        np.testing.assert_array_equal(
            tm.generate(prompt, max_new_tokens=6, use_graph=use_graph), ref)


def test_engine_streams_match_reference_and_generate(serving):
    """At the dropless factor a request's tokens do not depend on the
    others in its tick, so the engine's streams equal generate()'s."""
    jm, tm, je, te = serving
    prompts = _prompts((12, 20, 9, 5, 3))
    n = 6
    jh = [je.submit(p, max_new_tokens=n) for p in prompts]
    je.run_until_idle()
    th = [te.submit(p, max_new_tokens=n) for p in prompts]
    te.run_until_idle()
    got = [list(map(int, h.tokens)) for h in th]
    assert got == [list(map(int, h.tokens)) for h in jh]
    assert got == [list(map(int, tm.generate(p[None], max_new_tokens=n)
                            [0, p.size:])) for p in prompts]
    assert te.compiled_counts() == (1, 1)
