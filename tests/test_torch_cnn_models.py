"""The port's vision zoo (singa_tpu_torch.models: MLP, CNN, LeNet-5,
AlexNet, ResNet-18/34/50/101/152, VGG-11/13/16/19 with and without BN)
and its forward-FLOP counter (utils.flops) against the JAX package's,
on the CPU in f32.

Each reference model is built from a seed and materialised by a call;
its states (parameters, and BatchNorm's γ, β and running statistics set
to random values as a trained network's are) are carried into the port
by `load_reference_states`.  Tolerances (f32 in both; the order of the
sums differs):
  * eval logits: |Δ| ≤ 1e-4 · max|logit| + 1e-5;
  * three SGD steps (momentum 0.9, weight decay 1e-4, lr 0.01) through
    `train_step`: each step's loss within rtol 1e-3, and every parameter
    and running statistic after them within 2e-2 of the reference's by
    Frobenius norm.  These are wide because of ReLU, not rounding:
    where a ReLU's input lies within f32 rounding of 0 (ResNet-18 at
    B = 2 has such elements, 3e-6 from 0), one side passes the gradient
    and the other does not, which moves every upstream gradient by
    ~0.5 %, and this run (its loss rises 1.6 → 4.2) grows that
    ~10-fold a step: the parameters' changes over the three steps
    differ from the reference's by up to 12 %;
  * so the update is held one step at a time: from the reference's
    checkpoint before each step (parameters, running statistics,
    momentum), one port step changes each parameter within 2e-2 of the
    reference's change, ‖Δp − Δp_ref‖ ≤ 2e-2 ‖Δp_ref‖ (the largest
    seen 6.5e-3, ResNet-18's first step).  Planted in the port's SGD,
    a dropped momentum reads 0.75-0.80 and a dropped layer gradient
    0.68-1.0; a dropped weight decay (1e-4 here) reads 1.0-1.7e-2,
    within the limit: test_torch_opt.py holds weight decay at 0.1.
    The ops' own gradients are held to 1e-5 in test_torch_cnn_layers.py;
  * a checkpoint crossing the packages, and the FLOP counts: exact;
    the published counts: within 2 %."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import layer as jlayer
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import opt as topt
from singa_tpu_torch.utils import flops as tflops

LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-3
STATE_RTOL, CHANGE_RTOL = 2e-2, 2e-2

# name: (reference factory, port factory, input (B, H, W, C))
ZOO = {
    "mlp": (lambda: jmodels.MLP(),
            lambda: tmodels.MLP(), (2, 28, 28, 1)),
    "cnn": (lambda: jmodels.CNN(),
            lambda: tmodels.CNN(), (2, 28, 28, 1)),
    "lenet": (lambda: jmodels.LeNet5(),
              lambda: tmodels.LeNet5(), (2, 28, 28, 1)),
    "alexnet": (lambda: jmodels.AlexNet(num_classes=10, dropout=0.0),
                lambda: tmodels.AlexNet(num_classes=10, dropout=0.0,
                                        input_shape=(64, 64, 3)),
                (2, 64, 64, 3)),
    "resnet18": (lambda: jmodels.resnet18(),
                 lambda: tmodels.resnet18(), (2, 32, 32, 3)),
    "resnet34": (lambda: jmodels.resnet34(num_classes=10),
                 lambda: tmodels.resnet34(num_classes=10), (2, 32, 32, 3)),
    "resnet50": (lambda: jmodels.resnet50(num_classes=10),
                 lambda: tmodels.resnet50(num_classes=10), (2, 64, 64, 3)),
    "resnet101": (lambda: jmodels.resnet101(num_classes=10),
                  lambda: tmodels.resnet101(num_classes=10), (2, 32, 32, 3)),
    "resnet152": (lambda: jmodels.resnet152(num_classes=10),
                  lambda: tmodels.resnet152(num_classes=10), (2, 32, 32, 3)),
    "vgg11": (lambda: jmodels.vgg11(), lambda: tmodels.vgg11(),
              (2, 32, 32, 3)),
    "vgg11_nobn": (lambda: jmodels.vgg11(batch_norm=False),
                   lambda: tmodels.vgg11(batch_norm=False), (2, 32, 32, 3)),
    "vgg13": (lambda: jmodels.vgg13(), lambda: tmodels.vgg13(),
              (2, 32, 32, 3)),
    "vgg16": (lambda: jmodels.vgg16(), lambda: tmodels.vgg16(),
              (2, 32, 32, 3)),
    "vgg19": (lambda: jmodels.vgg19(), lambda: tmodels.vgg19(),
              (2, 32, 32, 3)),
}
TRAINED = ["resnet18", "vgg11", "alexnet", "cnn", "lenet", "mlp"]


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)
    jautograd.set_training(False)


def _batch(shape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randint(0, 10, shape[0]).astype(np.int32))


def _numpy_init(rng):
    """Replacements for the reference's He-normal and Xavier-uniform
    initialisers that draw with numpy: the jax.random draws compile once
    per shape (~0.4 s each on the CPU), and the weights are the test's
    own random values either way."""
    def he_normal(shape, fan_in, dev):
        std = np.sqrt(2.0 / max(1, fan_in))
        return jtensor.Tensor(data=jnp.asarray(
            rng.normal(0.0, std, shape).astype(np.float32)), device=dev)

    def xavier_uniform(shape, fan_in, fan_out, dev):
        a = np.sqrt(6.0 / max(1, fan_in + fan_out))
        return jtensor.Tensor(data=jnp.asarray(
            rng.uniform(-a, a, shape).astype(np.float32)), device=dev)
    return he_normal, xavier_uniform


def _materialise(jm, x, is_train, rng=None):
    """`jm.compile([x], is_train=...)`, graph mode for training, its
    lazy init drawing with numpy."""
    he_normal, xavier_uniform = _numpy_init(rng or np.random.RandomState(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayer, "_he_normal", he_normal)
        mp.setattr(jlayer, "_xavier_uniform", xavier_uniform)
        jm.compile([jtensor.from_numpy(x)], is_train=is_train,
                   use_graph=is_train)
    return jm


def _reference(name):
    """The reference model materialised by an eval call (its weights
    drawn with numpy from a seed), its BatchNorm states (γ, β and the
    running statistics) set to random values, as a trained network's
    are, and its states by name."""
    rng = np.random.RandomState(1)
    x, _ = _batch(ZOO[name][2])
    jm = _materialise(ZOO[name][0](), x, False, rng)
    for n, t in jm.get_states().items():
        kind = n.rsplit(".", 1)[-1]
        if kind in ("gamma", "running_var"):
            t.data = jnp.asarray(rng.uniform(0.5, 1.5, t.shape)
                                 .astype(np.float32))
        elif kind in ("beta", "running_mean"):
            t.data = jnp.asarray((rng.randn(*t.shape) * 0.1)
                                 .astype(np.float32))
    return jm, {n: np.asarray(t.data) for n, t in jm.get_states().items()}


def _port(name, states):
    tm = ZOO[name][1]()
    tmodels.load_reference_states(tm, states)
    return tm


@pytest.fixture(scope="module")
def refs():
    """Per zoo name, built on first use: the reference model, its states
    and a port model carrying them (for the tests that only read it)."""
    cache = {}

    def get(name):
        if name not in cache:
            jm, states = _reference(name)
            cache[name] = jm, states, _port(name, states)
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(ZOO))
def test_state_names_and_shapes_are_the_reference(refs, name):
    jm, states, tm = refs(name)
    got = {n: tuple(t.shape) for n, t in tm.get_states().items()}
    assert list(got) == list(states)
    assert got == {n: a.shape for n, a in states.items()}
    assert list(tm.get_params()) == list(jm.get_params())
    assert all(t.dtype == torch.float32 for t in tm.get_states().values())


@pytest.mark.parametrize("name", list(ZOO))
def test_eval_logits_match_reference(refs, name):
    jm, _, tm = refs(name)
    x, _ = _batch(ZOO[name][2], seed=2)
    jm.eval()
    want = np.asarray(jm(jtensor.from_numpy(x)).data)
    tm.eval()
    got = tm(x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max()
                               + LOGIT_ATOL)


def _sgd(mod):
    return mod.SGD(lr=0.01, momentum=0.9, weight_decay=1e-4)


@pytest.mark.parametrize("name", TRAINED)
def test_three_train_steps_match_reference(refs, name, tmp_path):
    _, states, _ = refs(name)
    batches = [_batch(ZOO[name][2], seed=10 + i) for i in range(3)]
    jm = _materialise(ZOO[name][0](), batches[0][0], True)
    jm.set_states(states)
    jm.set_optimizer(_sgd(jopt))
    jlosses, ckpts, seen = [], [], [states]
    for i, (x, y) in enumerate(batches):
        ckpts.append(str(tmp_path / f"before_step{i}.npz"))
        jm.save_states(ckpts[-1])
        jlosses.append(float(np.asarray(jm.train_step(
            jtensor.from_numpy(x), jtensor.from_numpy(y))[1].data)))
        seen.append({n: np.asarray(t.data)
                     for n, t in jm.get_states().items()})

    tm = _port(name, states)
    tm.set_optimizer(_sgd(topt))
    tm.compile([batches[0][0]], is_train=True, use_graph=True)
    tlosses = []
    for x, y in batches:
        out, loss = tm.train_step(x, y)
        assert out.dtype == torch.float32 and not loss.requires_grad
        tlosses.append(loss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert tm.optimizer.step_counter == 3
    assert tm.get_graph("train").flops() > 0
    for n, t in tm.get_states().items():
        want = seen[-1][n]
        err = np.linalg.norm(t.detach().numpy() - want) / np.linalg.norm(want)
        assert err <= STATE_RTOL, (n, err)
    moved = [n for n, t in tm._get_buffers().items()
             if not np.array_equal(t.numpy(), states[n])]
    assert len(moved) == len(tm._get_buffers())

    # each step alone, from the reference's checkpoint before it
    for i, (x, y) in enumerate(batches):
        step = ZOO[name][1]()
        step.set_optimizer(_sgd(topt))
        assert step.load_states(ckpts[i])["optimizer"] == {"step": i}
        step.compile([x], is_train=True, use_graph=True)
        step.train_step(x, y)
        for n, p in step.get_params().items():
            got = p.detach().numpy() - seen[i][n]
            want = seen[i + 1][n] - seen[i][n]
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= CHANGE_RTOL, (i, n, err)


def test_checkpoints_cross_the_packages(refs, tmp_path):
    """A reference .npz loads into the port, and a port .npz written
    after a step (momentum and step included) loads into the reference:
    every state equal."""
    jm, states, _ = refs("resnet18")
    jpath, tpath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jm.save_states(jpath)
    tm = tmodels.resnet18()
    tm.load_states(jpath)
    for n, t in tm.get_states().items():
        np.testing.assert_array_equal(t.detach().numpy(), states[n])

    x, y = _batch(ZOO["resnet18"][2])
    tm.set_optimizer(_sgd(topt))
    tm.compile([x], is_train=True, use_graph=True)
    tm.train_step(x, y)
    tm.save_states(tpath)
    jm2 = _materialise(jmodels.resnet18(), x, True)
    jm2.set_optimizer(_sgd(jopt))
    aux = jm2.load_states(tpath)
    assert aux["optimizer"] == {"step": 1}
    js = jm2.get_states()
    for n, t in tm.get_states().items():
        np.testing.assert_array_equal(np.asarray(js[n].data),
                                      t.detach().numpy(), err_msg=n)


def test_load_reference_states_refuses_what_does_not_fit(refs):
    _, states, _ = refs("cnn")
    tm = tmodels.CNN()
    missing = {n: a for n, a in states.items() if n != "fc2.b"}
    with pytest.raises(KeyError, match="missing.*fc2.b"):
        tmodels.load_reference_states(tm, missing)
    with pytest.raises(KeyError, match="extra.*bogus"):
        tmodels.load_reference_states(tm, {**states, "bogus": states["fc2.b"]})
    with pytest.raises(ValueError, match="fc1.W"):
        tmodels.load_reference_states(
            tm, {**states, "fc1.W": states["fc1.W"][:-1]})
    with pytest.raises(ValueError):
        tmodels.load_reference_states(tmodels.CNN(input_shape=(32, 32, 1)),
                                      states)


def test_classifier_casts_float_inputs_to_the_compute_dtype():
    """On a device whose compute dtype is bf16 (the card's), float inputs
    and the convolutions run in bf16, masters stay f32, and the logits
    and loss come back in f32."""
    dev = tdevice.create_device("cpu")
    dev.default_dtype = torch.bfloat16
    m = tmodels.CNN(device=dev)
    x, y = _batch((2, 28, 28, 1))
    seen = []
    m.conv1.register_forward_hook(lambda mod, i, o: seen.append(o.dtype))
    m.eval()
    assert m(x).dtype == torch.float32
    m.set_optimizer(topt.SGD(lr=0.01))
    m.compile([x], is_train=True, use_graph=True)
    out, loss = m.train_step(x, y)
    assert (out.dtype, loss.dtype) == (torch.float32, torch.float32)
    assert seen == [torch.bfloat16, torch.bfloat16]
    assert all(p.dtype == torch.float32 for p in m.get_params().values())


def test_a_captured_step_registers_the_dropout_generators():
    gen = torch.Generator().manual_seed(0)
    m = tmodels.AlexNet(num_classes=10, input_shape=(64, 64, 3),
                        generator=gen)
    assert tmodel._dropout_generators(m) == (m.device.generator,)
    m.drop1.p = m.drop2.p = 0.0
    assert tmodel._dropout_generators(m) == ()
    assert isinstance(m.drop1, tlayer.Dropout)


# -- forward FLOPs (utils.flops) ---------------------------------------------------

@pytest.mark.parametrize("name", list(ZOO))
def test_forward_flops_equal_the_reference_counter(refs, name):
    """The port counts conv and matmul FLOPs of what ran (2 a multiply-
    add), the reference those of its traced jaxpr: the same number."""
    from singa_tpu.utils.flops import model_forward_flops as jflops
    jm, _, tm = refs(name)
    x, _ = _batch(ZOO[name][2])
    want = jflops(jm, jtensor.from_numpy(x))
    assert tflops.model_forward_flops(tm, x) == want > 0


@pytest.mark.parametrize("factory,shape,gflop", [
    (lambda: tmodels.resnet50(), (2, 224, 224, 3), 8.18),
    (lambda: tmodels.resnet18(), (2, 32, 32, 3), 1.11),
], ids=["resnet50_224", "resnet18_cifar_32"])
def test_forward_flops_match_the_published_counts(factory, shape, gflop):
    """torchvision's ResNet-50 v1.5 at 224² (4.09 GMAC a forward) and
    CIFAR ResNet-18 at 32² (0.556 GMAC), at 2 FLOPs a multiply-add,
    within 2 %; counting leaves the model's mode and statistics as they
    were."""
    m = factory()
    tautograd.set_training(True)
    before = {n: t.clone() for n, t in m._get_buffers().items()}
    g = tflops.model_forward_flops(m, np.zeros(shape, np.float32)) / 1e9
    assert abs(g - gflop) / gflop < 0.02, g
    assert tautograd.is_training()
    for n, t in m._get_buffers().items():
        assert torch.equal(t, before[n]), n
