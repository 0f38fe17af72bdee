"""Step capture bookkeeping of the port (singa_tpu_torch.graph, the step
executor, generate()'s _GenSession) on the CPU, where a step is recorded
but no CUDA graph is made: what a CapturedGraph reports, reset_graph,
what a replay counts, the sessions' shared weights and their limit, and
greedy tokens of the session and of the eager path against the JAX
package's (tiny Llama in f32: identical)."""

import numpy as np
import pytest
import torch

from singa_tpu import models as jmodels
from singa_tpu import tensor as jtensor
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import graph as tgraph
from singa_tpu_torch import opt as topt
from singa_tpu_torch.models import Llama, LlamaConfig, load_reference_params
from singa_tpu_torch.models import _generate as tgenerate
from singa_tpu_torch.ops import flash_attention as tfa

B, T = 2, 64
P, N = 8, 6


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model with the same weights, prompt (2, P))."""
    prompt = np.random.RandomState(1).randint(0, 256, (2, P)).astype(np.int32)
    jtensor.set_seed(0)
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.compile([jtensor.from_numpy(prompt)], is_train=False, use_graph=False)
    tm = Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"))
    load_reference_params(tm, {n: np.asarray(t.data)
                               for n, t in jm.get_params().items()})
    return jm, tm, prompt


def _model(**kw):
    import dataclasses
    cfg = dataclasses.replace(LlamaConfig.tiny(), **kw)
    return Llama(cfg, device=tdevice.create_device("cpu"),
                 generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_graph_reports_the_steps_ops_and_flops(fused):
    m = _model(fused_loss=fused)
    m.set_optimizer(topt.SGD(lr=0.01, momentum=0.9))
    ids = np.random.RandomState(0).randint(0, 256, (B, T)).astype(np.int32)
    m.compile([ids], is_train=True, use_graph=True)
    assert m.graph is None
    m.train_step(ids)
    g = m.get_graph("train")
    assert isinstance(g, tgraph.CapturedGraph) and m.graph is g
    assert g.graph is None                    # the CPU: recorded only
    ops = g.op_types()
    assert ops.get("aten.mm", 0) + ops.get("aten.bmm", 0) > 0
    assert g.num_ops == sum(ops.values()) > 100
    # the matrix products of one step: 6 N per token (the fused loss
    # recomputes the head: + 2 dim V), and attention's 12 L dim T per
    # token, which on the CPU runs as plain einsums the counter sees
    # (on the card it runs in the flash kernels, which it does not).
    # The fused loss runs the head on T - 1 positions: 0.3% at T = 64
    expect = m.flops_per_token(T) * B * T
    assert abs(g.flops() - expect) <= 0.01 * expect
    assert g.cost_analysis() == {"flops": g.flops(),
                                 "bytes accessed": g.bytes_accessed()}
    # every f32 parameter is read by the forward at least once and its
    # update written at least once
    assert g.bytes_accessed() >= 2 * 4 * m.num_params()
    assert g.memory_analysis() == {"pool_bytes": 0}
    m.eval()
    m(ids)
    ge = m.get_graph("eval")
    assert ge is not g and ge.name == "eval" and m.graph is ge
    fwd = 2 * (m.num_params() - 256 * 64) * B * T \
        + 4 * m.cfg.num_layers * m.cfg.dim * T * B * T
    assert abs(ge.flops() - fwd) <= 0.01 * fwd


def test_indexing_ops_count_the_rows_they_move():
    """A paged arena's token write (index_put_), block write
    (index_copy_) and gather (index_select) count the rows they touch,
    not the arena; an embedding reads the rows it looks up; copy_ does
    not read its destination."""
    from singa_tpu_torch.ops import kv_cache
    nb, bs, K, D = 64, 16, 2, 8
    ck, cv = torch.zeros(nb, bs, K, D), torch.zeros(nb, bs, K, D)
    arena = ck.numel() * 4
    blocks, offsets = torch.tensor([1, 5, 9]), torch.tensor([0, 3, 15])
    k, v = torch.randn(3, K, D), torch.randn(3, K, D)
    _, g = tgraph.record("w", lambda: kv_cache.scatter_token_kv(
        ck, cv, blocks, offsets, k, v))
    # per pool: the int64 indices and the values read, 3 rows written
    assert g.bytes_accessed() == 2 * (2 * 3 * 8 + 2 * 3 * K * D * 4)
    assert torch.equal(ck[blocks, offsets], k)
    _, g = tgraph.record("b", lambda: kv_cache.scatter_block_kv(
        ck, cv, 7, torch.randn(bs, K, D), torch.randn(bs, K, D)))
    assert g.bytes_accessed() < arena / 8
    table = torch.tensor([[1, 2], [5, 9]], dtype=torch.int32)
    (dk, _), g = tgraph.record("g", lambda: kv_cache.gather_block_kv(
        ck, cv, table))
    assert g.op_types()["aten.index_select"] == 2
    assert g.bytes_accessed() < 2 * 3 * dk.numel() * 4 + arena / 8
    w, ids = torch.randn(1000, 64), torch.tensor([[1, 2, 3]])
    _, g = tgraph.record("e", lambda: torch.nn.functional.embedding(ids, w))
    assert g.bytes_accessed() == 3 * 8 + 2 * 3 * 64 * 4
    dst, src = torch.empty(100, 100), torch.randn(100, 100)
    _, g = tgraph.record("c", lambda: dst.copy_(src))
    assert g.bytes_accessed() == 2 * dst.numel() * 4


def test_reset_graph_forces_a_new_executor():
    m = _model(fused_loss=True)
    m.set_optimizer(topt.SGD(lr=0.01))
    ids = np.zeros((B, T), np.int32)
    m.compile([ids], is_train=True, use_graph=True)
    m.train_step(ids)
    ex = next(iter(m._executors.values()))
    m.generate(ids[:, :P], max_new_tokens=2)
    sess = next(iter(m._gen_sessions.values()))
    assert sess.fits(m)
    tgraph.reset_graph()
    assert m.graph is None and not sess.fits(m)
    m.train_step(ids)
    assert len(m._executors) == 1
    assert next(iter(m._executors.values())) is not ex
    assert m.optimizer.step_counter == 2
    m.generate(ids[:, :P], max_new_tokens=2)
    assert len(m._gen_sessions) == 1
    assert next(iter(m._gen_sessions.values())) is not sess


def test_replay_moves_no_wrapper_counter():
    """A replay calls no wrapper: the wrappers' counters stay, and the
    launches that ran are counted on the card (none here)."""
    class _Graph:
        replays = 0

        def replay(self):
            self.replays += 1
    g = tgraph.CapturedGraph("train", {"aten.mm": 3}, 0.0,
                             {"flash_fwd": 2, "flash_bwd_dq": 1,
                              "flash_bwd_dkv": 0})
    assert g.op_types() == {"aten.mm": 3, "flash_fwd": 2, "flash_bwd_dq": 1}
    assert g.num_ops == 6
    g.graph = _Graph()
    before = tgraph.kernel_launches()
    for _ in range(3):
        g.replay()
    assert g.graph.replays == 3
    assert tgraph.kernel_launches() == before
    tfa.reset_device_launches()
    assert tfa.device_launches() == dict.fromkeys(tfa.KERNELS, 0)


def test_cpu_steps_count_wrapper_launches_only_on_the_card():
    """On the CPU the plain versions run: no wrapper launch and no
    device counter, also through the recorded step."""
    m = _model(fused_loss=True)
    m.set_optimizer(topt.SGD(lr=0.01))
    ids = np.random.RandomState(0).randint(0, 256, (B, T)).astype(np.int32)
    m.compile([ids], is_train=True, use_graph=True)
    before = tgraph.kernel_launches()
    m.train_step(ids)
    m.train_step(ids)
    assert tgraph.kernel_launches() == before
    assert m.graph.launches == {}
    assert not tfa._device_counts


# -- generate()'s session --------------------------------------------------------------

@pytest.mark.parametrize("use_graph", [True, False], ids=["graph", "eager"])
def test_session_greedy_tokens_identical_to_reference(pair, use_graph):
    jm, tm, prompt = pair
    ref = jm.generate(prompt, max_new_tokens=N)
    np.testing.assert_array_equal(
        tm.generate(prompt, max_new_tokens=N, use_graph=use_graph), ref)
    first = ref
    for eos in (int(first[0, P]), int(first[1, P + 2])):
        np.testing.assert_array_equal(
            tm.generate(prompt, max_new_tokens=N, eos_id=eos,
                        use_graph=use_graph),
            jm.generate(prompt, max_new_tokens=N, eos_id=eos))


def test_session_is_kept_per_shape_and_follows_the_masters(pair):
    _, tm, prompt = pair
    tm._gen_sessions.clear()
    a = tm.generate(prompt, max_new_tokens=N, param_dtype=torch.bfloat16)
    assert len(tm._gen_sessions) == 1
    sess = next(iter(tm._gen_sessions.values()))
    tm.generate(prompt, max_new_tokens=N, param_dtype=torch.bfloat16)
    tm.generate(prompt[:1], max_new_tokens=N, param_dtype=torch.bfloat16)
    assert len(tm._gen_sessions) == 2
    assert next(iter(tm._gen_sessions.values())) is sess
    # the two sessions read one bf16 copy of the weights
    other = list(tm._gen_sessions.values())[1]
    assert other.params is sess.params
    assert all(t.dtype == torch.bfloat16 for t in sess.params.values())
    # the session's static weights are refreshed from the masters on
    # every call: a call after the masters change sees the change
    w = tm.get_params()["lm_head.W"]
    saved = w.detach().clone()
    with torch.no_grad():
        w.mul_(-1.0)
    try:
        b = tm.generate(prompt, max_new_tokens=N,
                        param_dtype=torch.bfloat16)
    finally:
        with torch.no_grad():
            w.copy_(saved)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(
        tm.generate(prompt, max_new_tokens=N, param_dtype=torch.bfloat16), a)
    assert all(p.dtype == torch.float32 for p in tm.get_params().values())


def test_sessions_are_capped_least_recently_used_first(pair):
    _, tm, prompt = pair
    tm._gen_sessions.clear()
    cap = tgenerate.MAX_SESSIONS
    lengths = list(range(2, 3 + cap))
    for p in lengths:
        tm.generate(prompt[:, :p], max_new_tokens=2)
    tm.generate(prompt[:, :lengths[1]], max_new_tokens=2)   # used again
    tm.generate(prompt[:, :P], max_new_tokens=2)
    kept = [k[1] for k in tm._gen_sessions]
    assert len(kept) == cap
    assert kept[-2:] == [lengths[1], P]
    assert lengths[0] not in kept and lengths[2] not in kept


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_eager_generate_keeps_no_state_and_equals_the_session(pair, dtype):
    _, tm, prompt = pair
    tm._gen_sessions.clear()
    tm._gen_params.clear()
    kw = dict(max_new_tokens=N, param_dtype=dtype)
    eager = tm.generate(prompt, use_graph=False, **kw)
    assert not tm._gen_sessions and not tm._gen_params
    np.testing.assert_array_equal(tm.generate(prompt, **kw), eager)
    for eos in (int(eager[0, P]), int(eager[1, P + 2])):
        np.testing.assert_array_equal(
            tm.generate(prompt, eos_id=eos, use_graph=False, **kw),
            tm.generate(prompt, eos_id=eos, **kw))
