"""The rest of the port's autograd surface (tensor math, shapes and
indexing, activations, where and reductions, losses, trigonometric,
rounding, comparison and logic) against the JAX package's, on the CPU
in f32: one table of cases, each run through both packages on the same
numpy-seeded inputs, values and gradients compared; then the ONNX form
of each function the reference's exporter has a rule for, read back by
the port's importer.

Cases put inputs on the traps: ties (maxima, minimum/maximum, clip and
hard-sigmoid bounds), negative and out-of-range ids (gather, index,
onehot, nll_loss), split by count and by sizes, floor-mod of negatives,
halves for round, zeros for abs and sign.

Tolerances (f32 on both sides; only elementwise implementations and
the order of sums differ): values and gradients within rtol 1e-5, atol
1e-6; integer and boolean results, their dtypes and NaN fills exactly;
an export read back within 1e-6 of the native call."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import tensor as jtensor
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import sonnx as tsonnx

RTOL, ATOL = 1e-5, 1e-6
EXPORT_TOL = 1e-6
CPU = tdevice.create_device("cpu")
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(CPU)
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)
    jautograd.set_training(False)


def _r(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


A = _r(2, 3, 4)
B = _r(2, 3, 4, seed=1)
POS = _r(2, 3, 4, seed=2, lo=0.2, hi=3.0)
UNIT = _r(2, 3, 4, seed=3, lo=-0.9, hi=0.9)
TIES = np.array([[1.0, 3.0, 3.0, -1.0], [2.0, 2.0, 0.5, 2.0]], np.float32)
ON_BOUNDS = np.array([-3.0, -2.5, -1.0, 0.0, 0.5, 1.0, 2.5, 3.0, 4.0],
                     np.float32)
HALVES = np.array([-2.5, -1.5, -0.5, 0.0, 0.5, 1.5, 2.5, 0.3],
                  np.float32)
WITH_ZEROS = np.array([-1.5, 0.0, 2.0, 0.0, -0.25], np.float32)
PROBS = _r(3, 4, seed=4, lo=0.05, hi=0.95)
LABELS = (np.random.RandomState(5).rand(3, 4) > 0.5).astype(np.float32)
IDS = np.array([[1, -1, 4], [0, 5, 2]], np.int32)

# name -> (fn(ag, *leaves), the differentiable inputs).  `ag` is either
# package's autograd module; both spell each call the same way
CASES = {
    "add": (lambda ag, a, b: ag.add(a, b), [A, B]),
    "add_scalar": (lambda ag, a: ag.add(a, 2.5), [A]),
    "sub_broadcast": (lambda ag, a, b: ag.sub(a, b), [A, B[0, 0]]),
    "mul": (lambda ag, a, b: ag.mul(a, b), [A, B]),
    "div": (lambda ag, a, b: ag.div(a, b), [A, POS]),
    "neg": (lambda ag, a: ag.neg(a), [A]),
    "pow": (lambda ag, a: ag.pow(a, 3.0), [POS]),
    "pow_root": (lambda ag, a: ag.pow(a, 0.5), [POS]),
    "abs": (lambda ag, a: ag.abs(a), [WITH_ZEROS]),
    "exp": (lambda ag, a: ag.exp(a), [A]),
    "log": (lambda ag, a: ag.log(a), [POS]),
    "sqrt": (lambda ag, a: ag.sqrt(a), [POS]),
    "rsqrt": (lambda ag, a: ag.rsqrt(a), [POS]),
    "clip_bounds": (lambda ag, a: ag.clip(a, -1.0, 1.0), [ON_BOUNDS]),
    "erf": (lambda ag, a: ag.erf(a), [A]),
    "matmul": (lambda ag, a, b: ag.matmul(a, b), [A, _r(4, 5, seed=6)]),
    "einsum": (lambda ag, a, b: ag.einsum("bij,bkj->bik", a, b), [A, B]),
    "tensordot": (lambda ag, a, b: ag.tensordot(a, b, 2),
                  [A, _r(3, 4, 2, seed=7)]),
    "tensordot_axes": (lambda ag, a, b: ag.tensordot(a, b, ([0], [1])),
                       [A, _r(5, 2, seed=8)]),
    "add_bias": (lambda ag, x, b: ag.add_bias(x, b, 1), [A, _r(3, seed=9)]),
    "reshape": (lambda ag, a: ag.reshape(a, (4, 6)), [A]),
    "transpose": (lambda ag, a: ag.transpose(a), [A]),
    "transpose_axes": (lambda ag, a: ag.transpose(a, (1, 0, 2)), [A]),
    "squeeze": (lambda ag, a: ag.squeeze(a, 1), [_r(2, 1, 3, seed=10)]),
    "squeeze_all": (lambda ag, a: ag.squeeze(a), [_r(1, 3, 1, seed=11)]),
    "unsqueeze": (lambda ag, a: ag.unsqueeze(a, [0, 3]), [A]),
    "cat": (lambda ag, a, b: ag.cat([a, b], 1), [A, B]),
    "stack": (lambda ag, a, b: ag.stack([a, b], 2), [A, B]),
    # a tuple result: each part scaled by its position, then joined
    "split_count": (lambda ag, a: ag.cat(
        [ag.mul(p, float(i + 1)) for i, p in enumerate(ag.split(a, 2, 2))],
        2), [A]),
    "split_sizes": (lambda ag, a: ag.cat(
        [ag.mul(p, float(i + 1)) for i, p in enumerate(
            ag.split(a, [1, 1], 2))], 2), [A]),
    "index": (lambda ag, a: ag.index(a, (slice(None), np.array([0, 0, -1]),
                                         slice(1, 3))), [A]),
    "index_ints": (lambda ag, a: ag.index(a, (1, slice(None, None, 2), -1)),
                   [A]),
    "index_out_of_range": (lambda ag, a: ag.index(
        a, (np.array([0, 5, -1]),)), [_r(3, 4, seed=12)]),
    # numpy places a scalar beside an array index as an array index
    "index_scalar_beside_array": (lambda ag, a: ag.index(
        a, (1, slice(None), np.array([0, -1, 5, 2]))), [A]),
    "index_int_out_of_range": (lambda ag, a: ag.index(a, (slice(None), 7)),
                               [A]),
    "gather": (lambda ag, a: ag.gather(a, 1, np.array([-1, 0, 2, 2])), [A]),
    "gather_out_of_range": (lambda ag, a: ag.gather(
        a, 0, np.array([[1, 5], [-4, -1]])), [_r(3, 4, seed=13)]),
    "pad": (lambda ag, a: ag.pad(a, ((1, 0), (0, 2), (0, 0)), 5.0), [A]),
    "tile": (lambda ag, a: ag.tile(a, (2, 1)), [A]),
    "repeat": (lambda ag, a: ag.repeat(a, 2, 1), [A]),
    "repeat_flat": (lambda ag, a: ag.repeat(a, 2), [A]),
    "expand": (lambda ag, a: ag.expand(a, (3, 2, 3, 4)), [A]),
    "cumsum": (lambda ag, a: ag.cumsum(a, 2), [A]),
    "softplus": (lambda ag, a: ag.softplus(a), [A * 10]),
    "leakyrelu": (lambda ag, a: ag.leakyrelu(a, 0.1), [WITH_ZEROS]),
    "elu": (lambda ag, a: ag.elu(a, 0.7), [WITH_ZEROS]),
    "prelu": (lambda ag, a, s: ag.prelu(a, s), [A, _r(4, seed=14)]),
    "selu": (lambda ag, a: ag.selu(a), [A]),
    "hardsigmoid_bounds": (lambda ag, a: ag.hardsigmoid(a), [ON_BOUNDS]),
    "hardswish_bounds": (lambda ag, a: ag.hardswish(a), [ON_BOUNDS]),
    "mish": (lambda ag, a: ag.mish(a), [A]),
    "where": (lambda ag, a, b: ag.where(A > 0, a, b), [A, B]),
    "where_scalar": (lambda ag, a: ag.where(A > 0, a, -1.0), [A]),
    "reduce_sum": (lambda ag, a: ag.reduce_sum(a, (0, 2)), [A]),
    "reduce_sum_keep": (lambda ag, a: ag.reduce_sum(a, 1, True), [A]),
    "reduce_max_ties": (lambda ag, a: ag.reduce_max(a, 1), [TIES]),
    "reduce_max_all": (lambda ag, a: ag.reduce_max(a), [TIES]),
    "reduce_min_ties": (lambda ag, a: ag.reduce_min(a, 0, True), [TIES]),
    "reduce_prod": (lambda ag, a: ag.reduce_prod(a, 1), [A]),
    "reduce_prod_zero": (lambda ag, a: ag.reduce_prod(a), [WITH_ZEROS]),
    "binary_cross_entropy": (lambda ag, p: ag.binary_cross_entropy(
        p, LABELS), [PROBS]),
    "binary_cross_entropy_clipped": (lambda ag, p: ag.binary_cross_entropy(
        p, LABELS[0]), [np.array([0.0, 1e-8, 0.5, 1.0], np.float32)]),
    "nll_loss": (lambda ag, lp: ag.nll_loss(lp, np.array([1, -1, 3, 4])),
                 [_r(4, 4, seed=15)]),
    "cossim": (lambda ag, a, b: ag.cossim(a, b), [A, B]),
    "minimum_ties": (lambda ag, a, b: ag.minimum(a, b),
                     [TIES, np.full_like(TIES, 2.0)]),
    "maximum_ties": (lambda ag, a, b: ag.maximum(a, b),
                     [TIES, np.full_like(TIES, 2.0)]),
    "maximum_scalar": (lambda ag, a: ag.maximum(a, 2.0), [TIES]),
}
CASES.update({name: ((lambda n: lambda ag, a: getattr(ag, n)(a))(name),
                     [data]) for name, data in {
    "sin": A, "cos": A, "tan": UNIT, "asin": UNIT, "acos": UNIT,
    "atan": A, "sinh": A, "cosh": A, "asinh": A, "acosh": POS + 1.0,
    "atanh": UNIT, "ceil": A, "floor": A, "round": HALVES, "sign": WITH_ZEROS,
    "reciprocal": POS}.items()})

# results that take no gradient: name -> (fn(ag, *tensors), inputs)
NO_GRAD = {
    "mod": (lambda ag, a: ag.mod(a, 2.0), [np.array([-3.5, -2, 3, 5.5],
                                                    np.float32)]),
    "mod_negative_divisor": (lambda ag, a: ag.mod(a, -2.0),
                             [np.array([-3.0, 3.0, 4.0], np.float32)]),
    "mod_int": (lambda ag, a: ag.mod(a, 3), [np.array([-7, -3, 4, 8],
                                                      np.int32)]),
    "equal": (lambda ag, a, b: ag.equal(a, b), [TIES, np.full_like(TIES, 2)]),
    "greater": (lambda ag, a: ag.greater(a, 2.0), [TIES]),
    "greater_equal": (lambda ag, a: ag.greater_equal(a, 2.0), [TIES]),
    "less": (lambda ag, a: ag.less(a, 2.0), [TIES]),
    "less_equal": (lambda ag, a: ag.less_equal(a, 2.0), [TIES]),
    "logical_and": (lambda ag, a, b: ag.logical_and(a, b),
                    [WITH_ZEROS, WITH_ZEROS[::-1].copy()]),
    "logical_or": (lambda ag, a, b: ag.logical_or(a, b),
                   [WITH_ZEROS, WITH_ZEROS[::-1].copy()]),
    "logical_xor": (lambda ag, a, b: ag.logical_xor(a, b),
                    [WITH_ZEROS, WITH_ZEROS[::-1].copy()]),
    "logical_not": (lambda ag, a: ag.logical_not(a), [WITH_ZEROS]),
    "onehot": (lambda ag, i: ag.onehot(i, 4), [IDS]),
    "onehot_axis": (lambda ag, i: ag.onehot(i, 5, 0), [IDS]),
    "shape_of": (lambda ag, a: ag.shape_of(a), [A]),
}


def _ref(fn, arrays, dy=None):
    """The reference's output and its gradients w.r.t. `arrays` (None:
    no gradients; zeros for an input the tape never reached), as jax
    arrays, so that a jit may trace it."""
    jautograd.set_training(dy is not None)
    leaves = [jtensor.Tensor(data=jnp.asarray(a), requires_grad=dy is not None,
                             stores_grad=True) for a in arrays]
    y = fn(jautograd, *leaves)
    if dy is None:
        return y.data, None
    got = {id(p): g.data for p, g in jautograd.backward(y, jnp.asarray(dy))}
    return y.data, [got.get(id(t), jnp.zeros_like(t.data)) for t in leaves]


def _port(fn, arrays, dy=None):
    leaves = [torch.tensor(a, requires_grad=dy is not None
                           and a.dtype == np.float32) for a in arrays]
    y = fn(tautograd, *leaves)
    if dy is None:
        return y.detach().numpy(), None
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy),
                                allow_unused=True)
    return y.detach().numpy(), [
        np.zeros_like(a) if g is None else g.numpy()
        for g, a in zip(grads, arrays)]


def _dy(name):
    fn, arrays = CASES[name]
    shape = _port(fn, arrays)[0].shape
    return np.asarray(np.random.RandomState(20).randn(*shape), np.float32)


# Cases whose reference runs op by op: under jit XLA contracts x·α + β
# into one fma, which moves the exact bound points these cases sit on
EAGER = {"hardsigmoid_bounds", "hardswish_bounds"}


@pytest.fixture(scope="module")
def reference():
    """Every case's reference result: the tape of the whole table traced
    under one jit (op by op, each of its small computations compiles on
    its own, ~20 s on the CPU), but for EAGER.  name -> (value,
    gradients or None)."""
    def run(table, dys):
        return {name: _ref(fn, arrays, dys.get(name))
                for name, (fn, arrays) in table.items()}
    traced = {n: c for n, c in CASES.items() if n not in EAGER}
    dys = {n: _dy(n) for n in traced}
    out = jax.jit(lambda d: run(traced, d))(dys)
    out.update(jax.jit(lambda: run(NO_GRAD, {}))())
    out.update(run({n: CASES[n] for n in EAGER}, {n: _dy(n) for n in EAGER}))
    jautograd.set_training(False)
    return {n: (np.asarray(y), g and [np.asarray(v) for v in g])
            for n, (y, g) in out.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_function_matches_reference(reference, name):
    fn, arrays = CASES[name]
    want, wgrads = reference[name]
    got, grads = _port(fn, arrays, _dy(name))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for i, (g, w) in enumerate(zip(grads, wgrads)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("name", list(NO_GRAD))
def test_integer_and_boolean_results_match_reference(reference, name):
    fn, arrays = NO_GRAD[name]
    want, _ = reference[name]
    leaves = [torch.tensor(a, requires_grad=a.dtype == np.float32)
              for a in arrays]
    y = fn(tautograd, *leaves)
    assert not y.requires_grad
    got = y.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_split_refuses_an_unequal_count_as_the_reference():
    with pytest.raises(ValueError, match="equal division"):
        tautograd.split(torch.zeros(3, 4), 3, 1)
    with pytest.raises(ValueError):
        jautograd.split(jtensor.from_numpy(np.zeros((3, 4), np.float32)),
                        3, 1)
    with pytest.raises(ValueError, match="size one"):
        tautograd.squeeze(torch.zeros(3, 4), 0)


@pytest.mark.parametrize("name,fn", [
    ("gather", lambda ag, a, i: ag.gather(a, 1, i)),
    ("index_array", lambda ag, a, i: ag.index(a, (i, 2))),
    ("index_scalar_tensor", lambda ag, a, i: ag.index(a, (slice(None),
                                                          i[0, 0]))),
    ("index_int", lambda ag, a, i: ag.index(a, (slice(None), -1)))])
def test_indexing_reads_nothing_back_to_the_host(name, fn):
    """On meta tensors, where reading a value back to the host raises
    (as it may not inside a CUDA-graph capture): the forward and the
    backward run, with out-of-range ids as likely as any."""
    a = torch.empty(4, 6, 5, device="meta", requires_grad=True)
    i = torch.empty(3, 2, dtype=torch.long, device="meta")
    fn(tautograd, a, i).sum().backward()
    assert a.grad.shape == a.shape


def test_grad_of_reads_the_stored_gradient():
    w = torch.tensor(A, requires_grad=True)
    assert tautograd.grad_of(w) is None
    tautograd.backward(tautograd.reduce_sum(tautograd.mul(w, w)))
    torch.testing.assert_close(tautograd.grad_of(w), 2 * w.detach())


def _public_functions(path: Path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)
            and not n.name.startswith("_")}


def test_reference_functions_are_a_subset_of_the_port():
    ref = _public_functions(ROOT / "singa_tpu" / "autograd.py")
    port = _public_functions(ROOT / "singa_tpu_torch" / "autograd.py")
    assert ref - port == set()
    assert set(tautograd.__all__) >= ref


# -- ONNX: each rule the reference's exporter has, read back by the port -----

class _Net(tlayer.Layer):
    """x -> fn(autograd, x, w): a parameter `w` of x's shape, so the
    export has an initializer beside the input."""

    def __init__(self, fn, shape):
        super().__init__(device=CPU)
        self.fn = fn
        self.w = self._new_param(shape)
        with torch.no_grad():
            self.w.copy_(torch.from_numpy(_r(*shape, seed=30, lo=0.5,
                                             hi=1.5)))

    def forward(self, x):
        return self.fn(tautograd, x, self.w)


# name -> (fn(ag, x, w), input, an ONNX op the graph must hold)
EXPORTS = {
    "add": (lambda ag, x, w: ag.add(x, w), A, "Add"),
    "sub": (lambda ag, x, w: ag.sub(x, 1.5), A, "Sub"),
    "mul": (lambda ag, x, w: ag.mul(x, w), A, "Mul"),
    "div": (lambda ag, x, w: ag.div(x, w), A, "Div"),
    "pow": (lambda ag, x, w: ag.pow(ag.mul(x, w), 2.0), A, "Pow"),
    "neg_abs": (lambda ag, x, w: ag.neg(ag.abs(x)), A, "Abs"),
    "exp_log": (lambda ag, x, w: ag.log(ag.exp(ag.mul(x, w))), A, "Exp"),
    "sqrt": (lambda ag, x, w: ag.sqrt(w), A, "Sqrt"),
    "rsqrt": (lambda ag, x, w: ag.mul(x, ag.rsqrt(w)), A, "Reciprocal"),
    "erf": (lambda ag, x, w: ag.erf(x), A, "Erf"),
    "clip": (lambda ag, x, w: ag.clip(x, -0.5, 0.5), A, "Clip"),
    "matmul": (lambda ag, x, w: ag.matmul(x, ag.transpose(w, (0, 2, 1))),
               A, "MatMul"),
    "einsum": (lambda ag, x, w: ag.einsum("bij,bkj->bik", x, w), A,
               "Einsum"),
    "add_bias": (lambda ag, x, w: ag.add_bias(x, ag.index(w, (0, slice(None),
                                                              0)), 1),
                 A, "Reshape"),
    "reshape": (lambda ag, x, w: ag.reshape(ag.mul(x, w), (4, 6)), A,
                "Reshape"),
    "squeeze": (lambda ag, x, w: ag.squeeze(ag.unsqueeze(x, 1), 1), A,
                "Reshape"),
    "transpose": (lambda ag, x, w: ag.transpose(x), A, "Transpose"),
    "cat": (lambda ag, x, w: ag.cat([x, w], 2), A, "Concat"),
    "stack": (lambda ag, x, w: ag.stack([x, w], 1), A, "Unsqueeze"),
    "split": (lambda ag, x, w: ag.mul(*ag.split(x, [1, 3], 2)[:1], 2.0), A,
              "Split"),
    "gather": (lambda ag, x, w: ag.gather(x, 2, np.array([3, -1, 0])), A,
               "Gather"),
    "index": (lambda ag, x, w: ag.index(x, (1, slice(0, 2), -1)), A,
              "Slice"),
    "pad": (lambda ag, x, w: ag.pad(x, ((0, 0), (1, 2), (0, 1)), 0.5), A,
            "Pad"),
    "where": (lambda ag, x, w: ag.where(ag.greater(x, 0.0), x, w), A,
              "Where"),
    "tile": (lambda ag, x, w: ag.tile(x, (2, 1)), A, "Tile"),
    "expand": (lambda ag, x, w: ag.expand(x, (2, 2, 3, 4)), A, "Expand"),
    "cumsum": (lambda ag, x, w: ag.cumsum(x, 1), A, "CumSum"),
    "reduce_sum": (lambda ag, x, w: ag.reduce_sum(x, (0, 2), True), A,
                   "ReduceSum"),
    "reduce_max": (lambda ag, x, w: ag.reduce_max(x, 1), A, "ReduceMax"),
    "reduce_min": (lambda ag, x, w: ag.reduce_min(x), A, "ReduceMin"),
    "softplus": (lambda ag, x, w: ag.softplus(x), A, "Softplus"),
    "leakyrelu": (lambda ag, x, w: ag.leakyrelu(x, 0.2), A, "LeakyRelu"),
    "elu": (lambda ag, x, w: ag.elu(x, 0.5), A, "Elu"),
    "selu": (lambda ag, x, w: ag.selu(x), A, "Selu"),
    "prelu": (lambda ag, x, w: ag.prelu(x, w), A, "PRelu"),
    "hardsigmoid": (lambda ag, x, w: ag.hardsigmoid(x, 0.3, 0.4), A,
                    "HardSigmoid"),
    "hardswish": (lambda ag, x, w: ag.hardswish(ag.mul(x, 3.0)), A,
                  "HardSwish"),
    "mish": (lambda ag, x, w: ag.mish(x), A, "Mish"),
    "trig": (lambda ag, x, w: ag.add(ag.sin(x), ag.atan(ag.cosh(x))), A,
             "Sin"),
    "inverse": (lambda ag, x, w: ag.acosh(ag.add(w, 1.0)), A, "Acosh"),
    "rounding": (lambda ag, x, w: ag.add(ag.floor(x), ag.round(
        ag.mul(x, 3.0))), A, "Round"),
    "sign_reciprocal": (lambda ag, x, w: ag.mul(ag.sign(x),
                                                ag.reciprocal(w)), A,
                        "Reciprocal"),
    "minimum_maximum": (lambda ag, x, w: ag.maximum(ag.minimum(x, w), 0.0),
                        A, "Max"),
    "mod": (lambda ag, x, w: ag.mod(ag.mul(x, 3.0), w), A, "Floor"),
    "compare": (lambda ag, x, w: ag.where(ag.logical_and(
        ag.greater_equal(x, -0.5), ag.less(x, w)), x, 0.0), A, "And"),
    "logic": (lambda ag, x, w: ag.where(ag.logical_not(ag.logical_xor(
        ag.less_equal(x, 0.0), ag.equal(x, x))), x, w), A, "Xor"),
}


@pytest.mark.parametrize("name", list(EXPORTS))
def test_export_rule_round_trips(name):
    fn, x, op_type = EXPORTS[name]
    m = _Net(fn, x.shape)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        want = m(xt).numpy()
    proto = tsonnx.to_onnx(m, [xt])
    assert op_type in [n.op_type for n in proto.graph.node]
    data = proto.SerializeToString()
    tsonnx.check_model(tsonnx.load_model_from_string(data))
    (got,) = tsonnx.prepare(data, device=CPU).run([x])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=EXPORT_TOL,
                               atol=EXPORT_TOL)


def test_integer_mod_exports_as_onnx_floor_mod():
    m = _Net(lambda ag, x, w: ag.mod(x, 3), (4,))
    x = torch.tensor([-7, -3, 4, 8], dtype=torch.int64)
    proto = tsonnx.to_onnx(m, [x])
    node = [n for n in proto.graph.node if n.op_type == "Mod"]
    assert len(node) == 1
    (got,) = tsonnx.prepare(proto.SerializeToString(), device=CPU).run(
        [x.numpy()])
    assert got.tolist() == [2, 0, 1, 2]
