"""The port's transformer ops and layers (``autograd.layernorm``,
``gelu``, ``softmax``, ``log_softmax``; ``layer.LayerNorm``, ``Gelu``,
``Softmax``, ``MultiHeadAttention``) against the JAX package's, on the
CPU in f32.

Inputs come from numpy with a seed and pass between the frameworks as
numpy; a reference layer's weights are carried into the port's by name.
Tolerances (f32 in both; only the order of the sums differs):
  * the elementwise ops (both GELU forms, softmax, log_softmax): rtol
    1e-6, atol 1e-6, tight enough that the tanh and erf GELUs, which
    differ by up to ~5e-4 here, cannot stand in for each other; their
    input gradients within 1e-5 (jax differentiates its own formula,
    torch takes a closed form, and the two round apart by up to 2e-6);
  * LayerNorm (a mean, a variance and a division by its root) and its
    gradients: rtol 1e-5, atol 1e-5;
  * attention outputs, caches and input gradients: rtol 1e-5, atol
    1e-5."""

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
from singa_tpu_torch.models import load_reference_params

RTOL, ATOL = 1e-5, 1e-5
EW = 1e-6               # the elementwise ops
B, T, D, H = 2, 12, 32, 4


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)
    jautograd.set_training(False)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _jleaf(a):
    return jtensor.Tensor(data=jnp.asarray(a), requires_grad=True,
                          stores_grad=True)


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
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    y = fn(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    return y.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, tol, grad_tol=None):
    (y, gs), (ry, rgs) = got, want
    np.testing.assert_allclose(y, ry, rtol=tol, atol=tol)
    assert len(gs) == len(rgs)
    grad_tol = grad_tol or tol
    for i, (g, rg) in enumerate(zip(gs, rgs)):
        np.testing.assert_allclose(g, rg, rtol=grad_tol, atol=grad_tol,
                                   err_msg=f"gradient {i}")


# -- ops -----------------------------------------------------------------------

@pytest.mark.parametrize("rows", [2, 4, 64, 1500],
                         ids=["token_types", "few_rows", "positions", "vocab"])
def test_embedding_matches_reference(rows):
    """Both of the table gradient's sums (the one-hot product where rows
    repeat 128 times on average: 2 and 4 rows here; the sorted
    index_put_ otherwise) against the reference's scatter-add, with rows
    that repeat hundreds of times (as BERT's token types do) and rows
    that never occur."""
    table = _rand(rows, D, seed=5)
    ids = np.random.RandomState(6).randint(0, max(rows // 2, 1), (8, 96))
    ids[0, :40] = 1
    dy = _rand(8, 96, D, seed=7)
    _close(_port_grads(lambda t: tautograd.embedding(t, torch.from_numpy(ids)),
                       [table], dy),
           _ref_grads(lambda t: jautograd.embedding(t, ids), [table], dy),
           EW, RTOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layernorm_matches_reference(eps):
    x = _rand(B, T, D, scale=3.0) + 1.5
    g, b = _rand(D, seed=1), _rand(D, seed=2)
    dy = _rand(B, T, D, seed=3)
    _close(_port_grads(lambda *a: tautograd.layernorm(*a, eps=eps),
                       [x, g, b], dy),
           _ref_grads(lambda *a: jautograd.layernorm(*a, eps=eps),
                      [x, g, b], dy), RTOL)


def test_layernorm_keeps_bf16_rows_of_near_zero_spread_finite():
    """At BERT's eps 1e-12 a bf16 variance of a nearly constant row
    would be 0 and its rsqrt 1e6: the statistics run in f32, so the
    bf16 output is the f32 result rounded once."""
    x = np.full((4, D), 3.0, np.float32)
    x[:, ::2] += 2.0 ** -6                   # exact in bf16
    g, b = _rand(D, seed=1), _rand(D, seed=2)
    xb = torch.from_numpy(x).bfloat16()
    out = tautograd.layernorm(xb, torch.from_numpy(g).bfloat16(),
                              torch.from_numpy(b).bfloat16(), eps=1e-12)
    assert out.dtype == torch.bfloat16
    want = tautograd.layernorm(xb.float(),
                               torch.from_numpy(g).bfloat16().float(),
                               torch.from_numpy(b).bfloat16().float(),
                               eps=1e-12)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.bfloat16().float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("approximate", [True, False],
                         ids=["tanh", "erf"])
def test_gelu_matches_reference(approximate):
    x = _rand(B, T, D, scale=2.0)
    dy = _rand(B, T, D, seed=1)
    _close(_port_grads(lambda a: tautograd.gelu(a, approximate), [x], dy),
           _ref_grads(lambda a: jautograd.gelu(a, approximate), [x], dy),
           EW, RTOL)


def test_gelu_forms_differ_beyond_the_tolerance():
    x = torch.from_numpy(_rand(B, T, D, scale=2.0))
    gap = (tautograd.gelu(x, True) - tautograd.gelu(x, False)).abs().max()
    assert gap > 100 * EW
    # the reference's default is the tanh form, and so is the port's
    torch.testing.assert_close(tautograd.gelu(x), tautograd.gelu(x, True),
                               rtol=0, atol=0)
    assert tlayer.Gelu().approximate is jlayer.Gelu().approximate is True


@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("op", ["softmax", "log_softmax"])
def test_softmaxes_match_reference(op, axis):
    x = _rand(B, T, D, scale=4.0)
    dy = _rand(B, T, D, seed=1)
    _close(_port_grads(lambda a: getattr(tautograd, op)(a, axis), [x], dy),
           _ref_grads(lambda a: getattr(jautograd, op)(a, axis), [x], dy),
           EW, RTOL)


# -- layers --------------------------------------------------------------------

def _jtensor(a):
    return jtensor.Tensor(data=jnp.asarray(a), requires_grad=False)


def _carry(jl, tl):
    load_reference_params(tl, {n: np.asarray(t.data)
                               for n, t in jl.get_params().items()})


def test_layernorm_gelu_softmax_layers_match_reference():
    x = _rand(B, T, D, scale=2.0) - 0.5
    jn = jlayer.LayerNorm(D, eps=1e-12)
    ref = np.asarray(jn(_jtensor(x)).data)
    tn = tlayer.LayerNorm(D, eps=1e-12)
    _carry(jn, tn)
    assert list(tn.get_params()) == ["gamma", "beta"]
    np.testing.assert_allclose(tn(torch.from_numpy(x)).detach().numpy(), ref,
                               rtol=RTOL, atol=ATOL)
    for approximate in (True, False):
        np.testing.assert_allclose(
            tlayer.Gelu(approximate)(torch.from_numpy(x)).numpy(),
            np.asarray(jlayer.Gelu(approximate)(_jtensor(x)).data),
            rtol=EW, atol=EW)
    np.testing.assert_allclose(
        tlayer.Softmax(axis=1)(torch.from_numpy(x)).numpy(),
        np.asarray(jlayer.Softmax(axis=1)(_jtensor(x)).data),
        rtol=EW, atol=EW)


def _padding(lengths):
    m = np.zeros((len(lengths), T), np.float32)
    for i, n in enumerate(lengths):
        m[i, :n] = 1.0
    return (m > 0)[:, None, None, :]


@pytest.fixture(scope="module")
def mha_pairs():
    """(reference MHA, port MHA with its weights) for causal and not."""
    x = _rand(B, T, D)
    out = {}
    for causal in (True, False):
        jtensor.set_seed(3)
        jm = jlayer.MultiHeadAttention(H, D, causal=causal)
        jm(_jtensor(x))
        tm = tlayer.MultiHeadAttention(H, D, causal=causal,
                                       device=tdevice.create_device("cpu"))
        _carry(jm, tm)
        out[causal] = (jm, tm)
    return out


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "padding"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_mha_matches_reference(mha_pairs, causal, masked):
    jm, tm = mha_pairs[causal]
    assert list(tm.get_params()) == list(jm.get_params())
    x = _rand(B, T, D, seed=5)
    dy = _rand(B, T, D, seed=6)
    mask = _padding([T, 7]) if masked else None
    jmask = None if mask is None else _jtensor(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    _close(_port_grads(lambda a: tm(a, tmask), [x], dy),
           _ref_grads(lambda a: jm(a, jmask), [x], dy), RTOL)


def _caches(S):
    z = np.zeros((B, S, H, D // H), np.float32)
    return (jnp.asarray(z), jnp.asarray(z)), \
        (torch.from_numpy(z.copy()), torch.from_numpy(z.copy()))


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "padding"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_mha_cache_path_matches_reference(mha_pairs, causal, masked):
    """pos = 0 (an int) attends within the prompt and writes the cache;
    pos > 0 writes the new keys and attends the cache below pos + T."""
    jm, tm = mha_pairs[causal]
    P, S = 8, T + 4
    x = _rand(B, T, D, seed=7)
    full = _padding([T, 7]) if masked else None
    jc, tc = _caches(S)

    def step(xs, pos, mask):
        nonlocal jc, tc
        jmask = None if mask is None else _jtensor(mask)
        tmask = None if mask is None else torch.from_numpy(mask)
        jo, jc = jm(_jtensor(xs), jmask, jc, pos)
        with torch.no_grad():
            to, tc = tm(torch.from_numpy(xs), tmask, tc, pos)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo.data),
                                   rtol=RTOL, atol=ATOL)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=RTOL, atol=ATOL)

    # the prompt's mask covers its own keys; a cached step's covers S
    pm = None if full is None else full[..., :P]
    step(x[:, :P], 0, pm)
    cm = None if full is None else np.concatenate(
        [full, np.ones(full.shape[:3] + (S - T,), bool)], -1)
    step(x[:, P:P + 3], P, cm)
    step(x[:, P + 3:P + 4], P + 3, cm)


def test_mha_tensor_positions_equal_int_positions(mha_pairs):
    """A captured decode hands pos over as a 0-d or (B,) device tensor:
    both give the int position's output and caches."""
    _, tm = mha_pairs[True]
    x = torch.from_numpy(_rand(B, T, D, seed=8))
    outs = []
    with torch.no_grad():
        for pos in (5, torch.tensor(5), torch.tensor([5, 5])):
            _, tc = _caches(T + 4)
            tm(x[:, :5], None, tc, 0)
            outs.append(tm(x[:, 5:7], None, tc, pos))
    for o, c in outs[1:]:
        torch.testing.assert_close(o, outs[0][0], rtol=0, atol=1e-6)
        for a, b in zip(c, outs[0][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mha_refuses_widths_that_do_not_split():
    with pytest.raises(ValueError, match="heads"):
        tlayer.MultiHeadAttention(5, D)
