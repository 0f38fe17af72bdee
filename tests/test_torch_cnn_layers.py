"""The port's vision ops and layers (conv, pooling, BatchNorm, the
activations, Flatten, Dropout, the loss layers) against the JAX
package's, on the CPU in f32.

Inputs come from numpy with a seed and pass between the frameworks as
numpy; weights are carried from the reference's layer into the port's.
Tolerances (f32 in both; only the order of the sums differs):
  * forward outputs and their gradients: rtol 1e-5, atol 1e-5;
  * BatchNorm (statistics over a batch, then a division by their
    square root): rtol 1e-5, atol 2e-5 for outputs and gradients, 1e-6
    for the running statistics;
  * max pooling, Flatten and Dropout exactly (maxima and copies); avg
    pooling within 1e-6; the activations and losses within rtol 1e-6,
    atol 1e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import layer as jlayer
from singa_tpu import tensor as jtensor
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer

RTOL, ATOL = 1e-5, 1e-5
BN_ATOL, STAT_ATOL = 2e-5, 1e-6


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)
    jautograd.set_training(False)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jleaf(a):
    return jtensor.Tensor(data=jnp.asarray(a), requires_grad=True,
                          stores_grad=True)


def _tleaf(a):
    return torch.tensor(a, requires_grad=True)


def _ref_grads(fn, arrays, dy):
    """The reference op's output and its gradients w.r.t. `arrays` (the
    reference records its tape in training mode only)."""
    jautograd.set_training(True)
    leaves = [_jleaf(a) for a in arrays]
    y = fn(*leaves)
    got = {id(p): np.asarray(g.data) for p, g in jautograd.backward(
        y, jnp.asarray(dy))}
    return np.asarray(y.data), [got[id(t)] for t in leaves]


def _port_grads(fn, arrays, dy):
    leaves = [_tleaf(a) for a in arrays]
    y = fn(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    return y.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, rtol=RTOL, atol=ATOL):
    (y, gs), (ry, rgs) = got, want
    np.testing.assert_allclose(y, ry, rtol=rtol, atol=atol)
    for i, (g, rg) in enumerate(zip(gs, rgs)):
        np.testing.assert_allclose(g, rg, rtol=rtol, atol=atol,
                                   err_msg=f"gradient {i}")


# -- convolution ----------------------------------------------------------------

CONV_CASES = {
    "s1_int0": dict(stride=1, padding=0),
    "s2_int1": dict(stride=2, padding=1),
    "s1_tuple": dict(stride=1, padding=(1, 2)),
    "s1_lowhigh": dict(stride=1, padding=((0, 2), (1, 0))),
    "s1_same": dict(stride=1, padding="SAME"),
    "s2_same": dict(stride=2, padding="SAME"),
    "s2_valid": dict(stride=2, padding="VALID"),
    "s1_same_depthwise": dict(stride=1, padding="SAME", groups=4),
    "s2_int1_depthwise": dict(stride=2, padding=1, groups=4),
    "s1_dilation2": dict(stride=1, padding=2, dilation=2),
    "s2_same_dilation2": dict(stride=2, padding="same", dilation=2),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_reference(case):
    kw = dict(CONV_CASES[case])
    groups = kw.pop("groups", 1)
    x = _rand(2, 9, 10, 4, seed=1)                 # odd sizes: uneven SAME
    w = _rand(3, 3, 4 // groups, 8, seed=2) * 0.3
    b = _rand(8, seed=3)
    y = jautograd.conv2d(jtensor.from_numpy(x), jtensor.from_numpy(w),
                         jtensor.from_numpy(b), groups=groups, **kw)
    dy = _rand(*y.shape, seed=4)
    want = _ref_grads(lambda *t: jautograd.conv2d(*t, groups=groups, **kw),
                      [x, w, b], dy)
    got = _port_grads(lambda *t: tautograd.conv2d(*t, groups=groups, **kw),
                      [x, w, b], dy)
    assert got[0].shape == want[0].shape
    _close(got, want)


def test_conv2d_keeps_the_input_dtype_and_refuses_bad_padding():
    x = torch.randn(1, 5, 5, 2, dtype=torch.bfloat16)
    w = torch.randn(3, 3, 2, 4, dtype=torch.bfloat16)
    assert tautograd.conv2d(x, w, padding="SAME").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="SAME or VALID"):
        tautograd.conv2d(x, w, padding="FULL")
    with pytest.raises(ValueError, match="groups"):
        tlayer.Conv2d(6, 3, 4, groups=3)


# -- pooling ----------------------------------------------------------------------

POOL_CASES = [(2, 2, 0), (3, 2, 1), (3, 1, 1), (2, 1, 0), (3, 3, 2)]


def _pool_input(kind):
    x = _rand(2, 9, 8, 3, seed=5)
    if kind == "ties":
        x = np.round(x * 2) / 2                    # many equal values
    return x


@pytest.mark.parametrize("op", ["max_pool2d", "avg_pool2d"])
@pytest.mark.parametrize("k,s,p", POOL_CASES)
@pytest.mark.parametrize("kind", ["plain", "ties"])
def test_pool_matches_reference(op, k, s, p, kind):
    x = _pool_input(kind)
    y = getattr(jautograd, op)(jtensor.from_numpy(x), k, s, p)
    dy = _rand(*y.shape, seed=6)
    want = _ref_grads(lambda t: getattr(jautograd, op)(t, k, s, p), [x], dy)
    got = _port_grads(lambda t: getattr(tautograd, op)(t, k, s, p), [x], dy)
    _close(got, want, rtol=0, atol=0 if op == "max_pool2d" else 1e-6)


@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (2, 2, 0)])
def test_max_pool_ties_after_relu_route_as_the_reference(k, s, p):
    """After a ReLU, windows of zeros tie; the gradient w.r.t. the pool's
    input and w.r.t. the ReLU's input are both the reference's, exactly
    (each side routes a window's gradient to its first largest cell)."""
    x = _rand(2, 9, 8, 3, seed=7) - 0.5           # most cells ReLU to 0
    y = jautograd.max_pool2d(jautograd.relu(jtensor.from_numpy(x)), k, s, p)
    dy = _rand(*y.shape, seed=8)

    def ref(t):
        return jautograd.max_pool2d(jautograd.relu(t), k, s, p)

    def port(t):
        return tautograd.max_pool2d(tautograd.relu(t), k, s, p)
    _close(_port_grads(port, [x], dy), _ref_grads(ref, [x], dy), 0, 0)
    r = np.maximum(x, 0)
    assert (r == 0).mean() > 0.5
    _close(_port_grads(lambda t: tautograd.max_pool2d(t, k, s, p), [r], dy),
           _ref_grads(lambda t: jautograd.max_pool2d(t, k, s, p), [r], dy),
           0, 0)


# -- BatchNorm --------------------------------------------------------------------

def _bn_pair(data_format, c=3, seed=10):
    """A reference BatchNorm2d initialised by a call, and the port's with
    its γ and β."""
    jbn = jlayer.BatchNorm2d(data_format=data_format)
    shape = (2, c, 4, 4) if data_format == "NCHW" else (2, 4, 4, c)
    jbn(jtensor.from_numpy(np.zeros(shape, np.float32)))
    jbn.gamma.data = jnp.asarray(_rand(c, seed=seed) * 0.5 + 1)
    jbn.beta.data = jnp.asarray(_rand(c, seed=seed + 1))
    tbn = tlayer.BatchNorm2d(c, data_format=data_format)
    tbn.set_params({"gamma": np.asarray(jbn.gamma.data),
                    "beta": np.asarray(jbn.beta.data)})
    return jbn, tbn


@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_batchnorm_train_matches_reference(data_format):
    jbn, tbn = _bn_pair(data_format)
    shape = (4, 3, 5, 5) if data_format == "NCHW" else (4, 5, 5, 3)
    xs = [_rand(*shape, seed=20 + i) * 2 + 1 for i in range(3)]
    jautograd.set_training(True)
    tautograd.set_training(True)
    jbn.gamma.requires_grad = jbn.gamma.stores_grad = True
    jbn.beta.requires_grad = jbn.beta.stores_grad = True
    for i, x in enumerate(xs):
        jx, tx = _jleaf(x), _tleaf(x)
        jy, ty = jbn(jx), tbn(tx)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy.data),
                                   rtol=RTOL, atol=BN_ATOL, err_msg=f"call {i}")
    dy = _rand(*shape, seed=30)
    jg = {id(p): np.asarray(g.data)
          for p, g in jautograd.backward(jy, jnp.asarray(dy))}
    tg = torch.autograd.grad(ty, [tx, tbn.gamma, tbn.beta],
                             torch.from_numpy(dy))
    for t, j in zip(tg, (jx, jbn.gamma, jbn.beta)):
        np.testing.assert_allclose(t.numpy(), jg[id(j)], rtol=RTOL,
                                   atol=BN_ATOL)
    for n in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tbn, n).numpy(),
                                   np.asarray(getattr(jbn, n).data),
                                   rtol=RTOL, atol=STAT_ATOL, err_msg=n)
    # the biased variance, not torch's module's unbiased one
    assert not np.allclose(tbn.running_var.numpy(), 1.0)


@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_batchnorm_eval_reads_the_running_statistics(data_format):
    jbn, tbn = _bn_pair(data_format)
    c = 3
    mean, var = _rand(c, seed=40), np.abs(_rand(c, seed=41)) + 0.5
    jbn.running_mean.data, jbn.running_var.data = (jnp.asarray(mean),
                                                   jnp.asarray(var))
    tbn.set_states({"running_mean": mean, "running_var": var})
    shape = (2, 3, 4, 4) if data_format == "NCHW" else (2, 4, 4, 3)
    x = _rand(*shape, seed=42)
    want = np.asarray(jbn(jtensor.from_numpy(x)).data)
    got = tbn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=BN_ATOL)
    np.testing.assert_array_equal(tbn.running_mean.numpy(), mean)


def test_batchnorm_updates_its_statistics_in_place():
    """A captured step reads the running statistics by address."""
    bn = tlayer.BatchNorm2d(3)
    ptrs = (bn.running_mean.data_ptr(), bn.running_var.data_ptr())
    with tautograd.train_mode():
        bn(torch.from_numpy(_rand(2, 4, 4, 3)))
    assert (bn.running_mean.data_ptr(), bn.running_var.data_ptr()) == ptrs
    assert not torch.equal(bn.running_mean, torch.zeros(3))
    assert sorted(bn.get_states()) == ["beta", "gamma", "running_mean",
                                       "running_var"]


# -- NCHW layers, the stateless layers and the losses ------------------------------

@pytest.mark.parametrize("layer", ["Conv2d", "MaxPool2d", "AvgPool2d",
                                   "GlobalAvgPool2d"])
@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_layer_data_formats_match_reference(layer, data_format):
    shape = (2, 3, 8, 7) if data_format == "NCHW" else (2, 8, 7, 3)
    x = _rand(*shape, seed=50)
    args = {"Conv2d": (5, 3), "MaxPool2d": (3, 2), "AvgPool2d": (3, 2),
            "GlobalAvgPool2d": ()}[layer]
    kw = {"Conv2d": dict(stride=2, padding=1), "MaxPool2d": dict(padding=1),
          "AvgPool2d": dict(padding=1), "GlobalAvgPool2d": {}}[layer]
    jl = getattr(jlayer, layer)(*args, data_format=data_format, **kw)
    want = np.asarray(jl(jtensor.from_numpy(x)).data)
    if layer == "Conv2d":
        tl = tlayer.Conv2d(*args, 3, data_format=data_format, **kw)
        tl.set_params({n: np.asarray(t.data)
                       for n, t in jl.get_params().items()})
    else:
        tl = getattr(tlayer, layer)(*args, data_format=data_format, **kw)
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_flatten_keeps_the_nhwc_order():
    x = _rand(2, 3, 4, 5, seed=60)
    want = np.asarray(jlayer.Flatten()(jtensor.from_numpy(x)).data)
    got = tlayer.Flatten()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], x[1].reshape(-1))   # (H, W, C)
    np.testing.assert_array_equal(
        tautograd.flatten(torch.from_numpy(x)).numpy(), x.reshape(-1))


@pytest.mark.parametrize("name", ["ReLU", "Tanh", "Sigmoid"])
def test_activations_match_reference(name):
    x = _rand(3, 7, seed=61)
    dy = _rand(3, 7, seed=62)
    want = _ref_grads(getattr(jlayer, name)(), [x], dy)
    got = _port_grads(getattr(tlayer, name)(), [x], dy)
    _close(got, want, rtol=1e-6, atol=1e-7)


def test_dropout_draws_from_its_generator():
    x = torch.ones(64, 64)
    gen = torch.Generator().manual_seed(3)
    d = tlayer.Dropout(0.25, generator=gen)
    assert d(x) is x                                 # eval: the identity
    with tautograd.train_mode():
        y = d(x)
        assert tlayer.Dropout(0.0)(x) is x
        gen.manual_seed(3)
        again = d(x)
    assert set(np.unique(y.numpy())) == {0.0, np.float32(1 / 0.75)}
    assert 0.2 < (y == 0).float().mean().item() < 0.3
    torch.testing.assert_close(again, y, rtol=0, atol=0)


def test_loss_layers_match_reference():
    logits, target = _rand(4, 6, seed=70), np.array([0, 5, 2, 2])
    want = float(jlayer.CrossEntropyLoss()(jtensor.from_numpy(logits),
                                           target).data)
    got = tlayer.CrossEntropyLoss()(torch.from_numpy(logits), target)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    x, t = _rand(4, 6, seed=71), _rand(4, 6, seed=72)
    want = _ref_grads(lambda a: jlayer.MSELoss()(a, jtensor.from_numpy(t)),
                      [x], np.array(1.0, np.float32))
    got = _port_grads(lambda a: tlayer.MSELoss()(a, torch.from_numpy(t)),
                      [x], np.array(1.0, np.float32))
    _close(got, want, rtol=1e-6, atol=1e-7)


def test_sequential_names_its_children_as_the_reference():
    seq = tlayer.Sequential(tlayer.Conv2d(4, 3, 2), tlayer.BatchNorm2d(4),
                            tlayer.ReLU())
    assert list(seq.get_states()) == [
        "layers.0.W", "layers.0.b", "layers.1.gamma", "layers.1.beta",
        "layers.1.running_mean", "layers.1.running_var"]
    y = seq(torch.from_numpy(_rand(1, 5, 5, 2)))
    assert y.shape == (1, 3, 3, 4) and (y >= 0).all()
