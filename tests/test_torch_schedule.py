"""``CapturedGraph.schedule()`` and ``Schedule.replay`` of the port
(singa_tpu_torch.graph over its native scheduler) against the
reference's (singa_tpu.graph over csrc/scheduler.cc), on the CPU: the
replay cases of tests/test_native.py.

The reference schedules a jaxpr; the port a functionalized ``torch.fx``
graph (`graph.trace`), so the node lists differ and each side is held
to its own function: the tanh/sigmoid step replays to 1e-5 / 1e-6 of
the direct call (and of the reference's replay), hitting the host
kernels at least 4 times; a compiled Linear(8) model's train-step graph
replays the step's loss to 1e-4 / 1e-5 (bitwise here: the port's
step runs the same torch ops), and the updated parameters and slots
to 1e-5.  The arena is real: with every buffer planted at one offset
the replay goes wrong."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import graph as jgraph
from singa_tpu_torch import _core as tcore
from singa_tpu_torch import autograd, device, kernel_check, layer, model
from singa_tpu_torch import models, opt
from singa_tpu_torch.graph import CapturedGraph, trace

REPLAY_RTOL, REPLAY_ATOL = 1e-5, 1e-6
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
STATE_TOL = 1e-5


@pytest.fixture(scope="module")
def step_graph():
    """The reference's tanh/sigmoid step on numpy-seeded inputs, as a
    torch function, its traced graph and its schedule."""
    rng = np.random.RandomState(0)
    arrays = (rng.randn(16, 32).astype(np.float32),
              rng.randn(32).astype(np.float32),
              rng.randn(32, 4).astype(np.float32),
              rng.randn(8, 16).astype(np.float32))

    def step(w1, b1, w2, x):
        h = torch.tanh(x @ w1 + b1)
        o = torch.sigmoid(h) * h
        return (o @ w2).sum(), o

    args = [torch.from_numpy(a) for a in arrays]
    g = CapturedGraph("t", fx=trace(step, *args))
    return g, g.schedule(), step, args, arrays


@pytest.fixture(autouse=True)
def _port_cpu():
    device.set_default_device(device.create_device("cpu"))
    yield
    device.set_default_device(None)


def _reference_replay(arrays):
    def step(w1, b1, w2, x):
        h = jnp.tanh(x @ w1 + b1)
        o = jax.nn.sigmoid(h) * h
        return (o @ w2).sum(), o
    cj = jax.make_jaxpr(step)(*arrays)
    s = jgraph.CapturedGraph("t", jaxpr=cj).schedule()
    return s, s.replay(*arrays)


def test_replay_matches_direct_and_the_reference(step_graph):
    g, s, step, args, arrays = step_graph
    outs = s.replay(*args)
    assert s.native_hits >= 4, "hot ops should hit the host kernels"
    for got, ref in zip(outs, step(*args)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                   rtol=REPLAY_RTOL, atol=REPLAY_ATOL)
    js, jouts = _reference_replay(arrays)
    assert js.native_hits >= 4
    for got, ref in zip(outs, jouts):
        np.testing.assert_allclose(got.numpy(), ref, rtol=REPLAY_RTOL,
                                   atol=REPLAY_ATOL)
    # numpy inputs are taken too; outputs are copies, not arena views
    again = s.replay(*arrays)
    for a, b in zip(again, outs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    again[1].zero_()
    np.testing.assert_array_equal(s.replay(*args)[1].numpy(),
                                  outs[1].numpy())


def test_replay_without_native_kernels(step_graph):
    g, s, step, args, _ = step_graph
    outs = s.replay(*args, use_native=False)
    assert s.native_hits == 0
    for got, ref in zip(outs, step(*args)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                   rtol=REPLAY_RTOL, atol=REPLAY_ATOL)


def test_schedule_surface_and_order(step_graph):
    """The reference's introspection surface: a sink after every node,
    an order that respects the traced graph, offsets for each planned
    buffer inside the arena; the same arena and order each time."""
    g, s, _, args, _ = step_graph
    assert s.num_nodes == len(s.order) == 8       # 7 ops and the sink
    assert kernel_check.schedule_is_topological(s)
    assert s.arena_bytes > 0
    assert all(0 <= off < s.arena_bytes for off in s.buffer_offsets.values())
    again = g.schedule()
    assert (again.order, again.arena_bytes, again.buffer_offsets) == \
        (s.order, s.arena_bytes, s.buffer_offsets)
    bad = list(reversed(s.order))
    s2 = g.schedule()
    s2.order = bad
    assert not kernel_check.schedule_is_topological(s2)
    assert "Schedule nodes=8" in repr(s)


def test_an_unsound_arena_plan_corrupts_the_replay(step_graph):
    """Every f32 result is written into its planned slot: with every
    buffer planted at offset 0 the replay's outputs are wrong."""
    g, s, step, args, _ = step_graph
    planted = g.schedule()
    planted.buffer_offsets = dict.fromkeys(planted.buffer_offsets, 0)
    outs = planted.replay(*args)
    ref = step(*args)
    assert not np.allclose(outs[1].numpy(), ref[1].numpy(),
                           rtol=REPLAY_RTOL, atol=REPLAY_ATOL)


def test_schedule_and_replay_raise_without_the_library(step_graph,
                                                       monkeypatch):
    g, s, _, args, _ = step_graph
    monkeypatch.setattr(tcore, "_built", None)
    monkeypatch.setattr(tcore, "_error", "planted: no library")
    with pytest.raises(RuntimeError, match="planted"):
        g.schedule()
    with pytest.raises(RuntimeError, match="planted"):
        s.replay(*args)
    assert len(s.replay(*args, use_native=False)) == 2
    with pytest.raises(ValueError, match="needs 4 args"):
        s.replay(*args[:3], use_native=False)
    with pytest.raises(RuntimeError, match="no traced step"):
        CapturedGraph("empty").schedule()


class _M(model.Model):
    def __init__(self):
        super().__init__()
        self.fc = layer.Linear(8, 6)

    def forward(self, x):
        return self.fc(x)

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = autograd.mse_loss(out, y)
        self.optimizer.backward_and_update(loss)
        return out, loss


@pytest.fixture
def linear_model():
    m = _M()
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 6)
                         .astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(4).randn(4, 8)
                         .astype(np.float32))
    m.compile([x], is_train=True, use_graph=True)
    m.train_step(x, y)                  # makes the executor and its graph
    return m, x, y


def test_captured_graph_native_schedule(linear_model):
    """A compiled Linear(8) model's train-step graph: more than 5 nodes,
    an arena, an order covering every node; traced on demand, once."""
    m, x, y = linear_model
    g = m.graph
    assert g.fx_thunk is not None and g._fx is None, "traced on demand"
    s = g.schedule()
    assert s.num_nodes > 5 and s.arena_bytes > 0
    assert sorted(s.order) == list(range(s.num_nodes))
    assert kernel_check.schedule_is_topological(s)
    assert g.fx_thunk is None and g.schedule().num_nodes == s.num_nodes


def test_replay_model_train_step_graph(linear_model):
    """The replay of the traced train step from the state before a step
    reproduces that step: its loss (1e-4 / 1e-5), and the parameters,
    momentum slots and step counter it leaves (1e-5); the model itself
    is untouched by the trace."""
    m, x, y = linear_model
    ex = next(iter(m._executors.values()))
    names = ex._state()[0]
    assert names == ["param:fc.W", "param:fc.b", "slot:fc.W:0",
                     "slot:fc.b:0", "step"]
    args = ex.step_inputs((x, y))
    before = {n: t.clone() for n, t in zip(names, ex._state()[1])}
    s = m.graph.schedule()
    for n, t in zip(names, ex._state()[1]):       # the trace ran nothing
        assert torch.equal(t, before[n]), n
    out, loss = m.train_step(x, y)
    outs = s.replay(*args)
    np.testing.assert_allclose(float(outs[1]), float(loss), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(outs[0].numpy(), out.numpy(), rtol=STATE_TOL,
                               atol=STATE_TOL)
    for n, got, want in zip(names, outs[2:], ex._state()[1]):
        np.testing.assert_allclose(got.double().numpy(),
                                   want.detach().double().numpy(),
                                   rtol=STATE_TOL, atol=STATE_TOL, err_msg=n)
    assert s.native_hits > 0
    for n, a in zip(names, args):
        assert torch.equal(a, before[n]), f"replay wrote its argument {n}"


def test_replay_cnn_step_with_multi_output_ops():
    """A small CNN's train step (convolutions, max pooling with its
    indices, BatchNorm-free): its multi-output ops read their elements
    in place, and the replay reproduces the loss and parameters."""
    m = models.CNN(num_classes=10, generator=torch.Generator()
                   .manual_seed(0))
    m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9))
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 28, 28, 1), generator=g)
    y = torch.randint(0, 10, (2,), generator=g).to(torch.int32)
    m.compile([x], is_train=True, use_graph=True)
    m.train_step(x, y)
    ex = next(iter(m._executors.values()))
    args = ex.step_inputs((x, y))
    s = m.graph.schedule()
    assert any(isinstance(n.meta.get("val"), (tuple, list))
               for n in s._steps), "a multi-output op"
    assert kernel_check.schedule_is_topological(s)
    _, loss = m.train_step(x, y)
    outs = s.replay(*args)
    np.testing.assert_allclose(float(outs[1]), float(loss), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    for n, got, want in zip(ex._state()[0], outs[2:], ex._state()[1]):
        np.testing.assert_allclose(got.double().numpy(),
                                   want.detach().double().numpy(),
                                   rtol=STATE_TOL, atol=STATE_TOL, err_msg=n)
