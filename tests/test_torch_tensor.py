"""The port's ``tensor`` and ``proto`` modules against the JAX package's
(``singa_tpu/tensor.py``, ``singa_tpu/proto.py``), on the CPU.

One case per public function of the reference's ``tensor`` module, on
the same numpy-seeded inputs: exact (values and dtype) for the layout,
conversion and creation functions; f32 math within 1e-6 of the
reference's largest magnitude (``rtol=1e-6`` and ``atol=1e-6·max|ref|``);
the random functions by their draws' statistics (mean and spread within
0.05 of the asked ones over 20,000 draws, in both packages) and by
``set_seed`` repeating them.  Then the module docstring's table of the
reference ``Tensor``'s members, the default device (the card: raises
here) and the ``proto`` enums and dtype maps."""

import re

import numpy as np
import pytest
import torch

from singa_tpu import proto as jproto
from singa_tpu import tensor as jtensor
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import proto as tproto
from singa_tpu_torch import tensor as ttensor

CPU = tdevice.create_device("cpu")
RTOL = 1e-6


def _inputs():
    rng = np.random.RandomState(0)
    f = np.float32
    return {"A": rng.randn(4, 6).astype(f), "B": rng.randn(4, 6).astype(f),
            "M": rng.randn(6, 5).astype(f),
            "P": (np.abs(rng.randn(4, 6)) + 0.5).astype(f),
            "R": (rng.randn(4, 6) * 3).astype(f),
            "V4": rng.randn(4).astype(f), "V6": rng.randn(6).astype(f),
            "F": rng.randn(24).astype(f),
            "Q": rng.randn(2, 4, 6).astype(f),
            "K": rng.randn(2, 6, 3).astype(f),
            "S": rng.randn(1, 4, 1, 6).astype(f),
            "I": rng.randint(0, 3, (4, 6)).astype(f),
            "J": rng.randint(0, 3, (4, 6)).astype(f)}


IN = _inputs()


def _x(T, d, *names):
    out = [T.from_numpy(IN[n], d) for n in names]
    return out[0] if len(out) == 1 else out


def _from_raw(T, d):
    if T is jtensor:
        import jax.numpy as jnp
        return T.from_raw(jnp.asarray(IN["A"]))
    return T.from_raw(torch.from_numpy(IN["A"]), d)


def _seeded(T, d):
    T.set_seed(5)
    a = T.gaussian((64,), dev=d, dtype=np.float32)
    T.set_seed(5)
    b = T.gaussian((64,), dev=d, dtype=np.float32)
    return np.array_equal(T.to_numpy(a), T.to_numpy(b))


def _np_dtype(dt):
    if isinstance(dt, torch.dtype):
        return np.dtype(str(dt).replace("torch.", ""))
    return np.dtype(dt)


def _copied(T, d):
    dst = T.zeros((4, 6), d, np.float32)
    T.copy_data_to_from(dst, _x(T, d, "F"))
    return dst


# (T, d) -> result: T is either tensor module, d the port's CPU device or
# None (the reference's default device is jax's CPU here)
EXACT = {
    "from_numpy": lambda T, d: _x(T, d, "A"),
    "to_numpy": lambda T, d: T.to_numpy(_x(T, d, "A")),
    "from_raw": _from_raw,
    "zeros": lambda T, d: T.zeros((3, 4), d, np.float32),
    "ones": lambda T, d: T.ones((3, 4), d, np.float32),
    "zeros_like": lambda T, d: T.zeros_like(_x(T, d, "A")),
    "ones_like": lambda T, d: T.ones_like(_x(T, d, "A")),
    "full": lambda T, d: T.full((3, 4), 2.5, d, np.float32),
    "arange": lambda T, d: T.arange(2, 11, 3, d),
    "eye": lambda T, d: T.eye(4, d, np.float32),
    "set_seed": _seeded,
    "copy_data_to_from": _copied,
    "default_float": lambda T, d: _np_dtype(T.default_float(d)),
    "reshape": lambda T, d: T.reshape(_x(T, d, "A"), (6, 4)),
    "transpose": lambda T, d: T.transpose(_x(T, d, "Q"), (2, 0, 1)),
    "flatten": lambda T, d: T.flatten(_x(T, d, "Q"), 1),
    "squeeze": lambda T, d: T.squeeze(_x(T, d, "S")),
    "unsqueeze": lambda T, d: T.unsqueeze(_x(T, d, "A"), 1),
    "concatenate": lambda T, d: T.concatenate(_x(T, d, "A", "B"), 1),
    "stack": lambda T, d: T.stack(_x(T, d, "A", "B"), 0),
    "split": lambda T, d: T.split(_x(T, d, "A"), 3, 1),
    "repeat": lambda T, d: T.repeat(_x(T, d, "A"), 2, 1),
    "abs": lambda T, d: T.abs(_x(T, d, "A")),
    "sign": lambda T, d: T.sign(_x(T, d, "A")),
    "relu": lambda T, d: T.relu(_x(T, d, "A")),
    "ceil": lambda T, d: T.ceil(_x(T, d, "R")),
    "floor": lambda T, d: T.floor(_x(T, d, "R")),
    "round": lambda T, d: T.round(_x(T, d, "R")),
    "max": lambda T, d: T.max(_x(T, d, "A"), 1),
    "min": lambda T, d: T.min(_x(T, d, "A")),
    "argmax": lambda T, d: T.argmax(_x(T, d, "A"), 1),
    "argmin": lambda T, d: T.argmin(_x(T, d, "A"), 0),
    "clip": lambda T, d: T.clip(_x(T, d, "A"), -0.5, 0.5),
    "lt": lambda T, d: T.lt(*_x(T, d, "A", "B")),
    "le": lambda T, d: T.le(_x(T, d, "A"), 0.0),
    "gt": lambda T, d: T.gt(*_x(T, d, "I", "J")),
    "ge": lambda T, d: T.ge(*_x(T, d, "I", "J")),
    "eq": lambda T, d: T.eq(*_x(T, d, "I", "J")),
}

MATH = {
    "add": lambda T, d: T.add(*_x(T, d, "A", "B")),
    "sub": lambda T, d: T.sub(*_x(T, d, "A", "B")),
    "mul": lambda T, d: T.mul(*_x(T, d, "A", "B")),
    "div": lambda T, d: T.div(*_x(T, d, "A", "P")),
    "matmul": lambda T, d: T.matmul(*_x(T, d, "A", "M")),
    "mult": lambda T, d: T.mult(*_x(T, d, "A", "M")),
    "eltwise_mult": lambda T, d: T.eltwise_mult(*_x(T, d, "A", "B")),
    "axpy": lambda T, d: T.axpy(2.5, *_x(T, d, "A", "B")),
    "add_column": lambda T, d: T.add_column(*_x(T, d, "V4", "A")),
    "add_row": lambda T, d: T.add_row(*_x(T, d, "V6", "A")),
    "sum_columns": lambda T, d: T.sum_columns(_x(T, d, "A")),
    "sum_rows": lambda T, d: T.sum_rows(_x(T, d, "A")),
    "tensordot": lambda T, d: T.tensordot(*_x(T, d, "A", "M"), 1),
    "batchmatmul": lambda T, d: T.batchmatmul(*_x(T, d, "Q", "K")),
    "einsum": lambda T, d: T.einsum("ij,jk->ik", *_x(T, d, "A", "M")),
    "exp": lambda T, d: T.exp(_x(T, d, "A")),
    "log": lambda T, d: T.log(_x(T, d, "P")),
    "sqrt": lambda T, d: T.sqrt(_x(T, d, "P")),
    "pow": lambda T, d: T.pow(_x(T, d, "P"), 1.5),
    "square": lambda T, d: T.square(_x(T, d, "A")),
    "tanh": lambda T, d: T.tanh(_x(T, d, "A")),
    "sigmoid": lambda T, d: T.sigmoid(_x(T, d, "A")),
    "softmax": lambda T, d: T.softmax(_x(T, d, "A"), -1),
    "sum": lambda T, d: T.sum(_x(T, d, "A"), 1, True),
    "sum_all": lambda T, d: T.sum_all(_x(T, d, "A")),
    "mean": lambda T, d: T.mean(_x(T, d, "A"), 0),
}

RANDOM = {
    "gaussian": (lambda T, d: T.gaussian((20000,), 1.0, 2.0, d,
                                         np.float32), (1.0, 2.0)),
    "uniform": (lambda T, d: T.uniform((20000,), -1.0, 3.0, d,
                                       np.float32), (1.0, 4 / 12 ** 0.5)),
    "bernoulli": (lambda T, d: T.bernoulli((20000,), 0.3, d, np.float32),
                  (0.3, (0.3 * 0.7) ** 0.5)),
}


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, jtensor.Tensor):
        return x.to_numpy()
    return np.asarray(x)


def test_every_public_function_has_a_case():
    public = set(jtensor.__all__) - {"Tensor"}
    assert set(EXACT) | set(MATH) | set(RANDOM) == public
    assert set(ttensor.__all__) == set(jtensor.__all__)
    assert ttensor.Tensor is torch.Tensor


def _pairs(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        return list(zip(got, want))
    return [(got, want)]


@pytest.mark.parametrize("name", sorted(EXACT))
def test_layout_and_creation_equal_the_reference(name):
    for g, w in _pairs(EXACT[name](ttensor, CPU), EXACT[name](jtensor, None)):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(MATH))
def test_f32_math_equals_the_reference(name):
    for g, w in _pairs(MATH[name](ttensor, CPU), MATH[name](jtensor, None)):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()))


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_draws_match_the_reference_in_distribution(name):
    draw, (mean, std) = RANDOM[name]
    for T, d in ((ttensor, CPU), (jtensor, None)):
        x = _np(draw(T, d))
        assert x.shape == (20000,) and x.dtype == np.float32
        assert abs(x.mean() - mean) < 0.05 and abs(x.std() - std) < 0.05
    if name == "bernoulli":
        assert set(np.unique(_np(draw(ttensor, CPU)))) == {0.0, 1.0}
    if name == "uniform":
        x = _np(draw(ttensor, CPU))
        assert x.min() >= -1.0 and x.max() < 3.0


def test_random_functions_take_an_explicit_generator():
    g = torch.Generator().manual_seed(11)
    x = ttensor.gaussian((5, 3), dev=CPU, dtype=torch.float32, generator=g)
    want = torch.randn((5, 3), generator=torch.Generator().manual_seed(11))
    assert torch.equal(x, want)
    ttensor.set_seed(3)
    a = ttensor.uniform((8,), dev=CPU, dtype=torch.float32)
    ttensor.set_seed(3)
    assert torch.equal(ttensor.uniform((8,), dev=CPU, dtype=torch.float32),
                       a)


def test_dtypes_from_torch_numpy_and_proto():
    for dt in (torch.bfloat16, np.float16, tproto.DataType.kInt64,
               "float64"):
        z = ttensor.zeros((2,), CPU, dt)
        assert z.dtype == {np.float16: torch.float16,
                           tproto.DataType.kInt64: torch.int64,
                           "float64": torch.float64}.get(dt, dt)
    assert ttensor.zeros(3, CPU).dtype == torch.float32     # the CPU's
    assert ttensor.to_numpy(ttensor.ones((2,), CPU, torch.bfloat16)).dtype \
        == np.float32
    with pytest.raises(ValueError):
        ttensor.zeros((2,), CPU, np.complex64)


def test_in_place_functions_raise_as_the_reference():
    a, b = _x(ttensor, CPU, "A", "M")
    for T, args in ((ttensor, (a, b)),
                    (jtensor, _x(jtensor, None, "A", "M"))):
        with pytest.raises(ValueError, match="axpy shape mismatch"):
            T.axpy(1.0, *args)
        with pytest.raises(ValueError, match="add_column"):
            T.add_column(args[0], args[1])
        with pytest.raises(ValueError, match="add_row"):
            T.add_row(args[0], args[1])


def test_no_device_means_the_card(monkeypatch):
    """Given no device the functions use the default device, the card:
    without one they raise instead of falling back to the CPU."""
    monkeypatch.setattr(tdevice, "_default_device", None)
    for fn in (lambda: ttensor.zeros((2,)),
               lambda: ttensor.from_numpy(IN["A"]),
               lambda: ttensor.gaussian((2,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def _table():
    doc = ttensor.__doc__
    body = doc.split("================")[2:-2]
    rows = {}
    for ln in "".join(body).splitlines():
        m = re.match(r"^\s{4}(\S+)\s{2,}(.+)$", ln)
        if m:
            rows[m.group(1)] = m.group(2)
    return rows


def test_method_table_covers_the_reference_tensor():
    skip = {"__init__", "__slots__", "__module__", "__doc__", "__dict__",
            "__array_priority__", "__qualname__", "__firstlineno__",
            "__static_attributes__", "__weakref__", "data", "_grad"}
    members = {k for k in vars(jtensor.Tensor) if k not in skip}
    members |= set(jtensor.Tensor.__slots__) - skip
    rows = _table()
    assert members <= set(rows), sorted(members - set(rows))
    assert set(rows) <= members, sorted(set(rows) - members)
    for name, text in rows.items():
        for attr in re.findall(r"\bt\.(\w+)", text):
            assert hasattr(torch.Tensor, attr), (name, attr)
        for fn in re.findall(r"(?<![.\w])([a-z_]+)\(", text):
            assert fn in ttensor.__all__ or fn in ("len", "repr"), \
                (name, fn)


# -- proto -------------------------------------------------------------------

@pytest.mark.parametrize("enum", ["DataType", "DeviceType", "LangType"])
def test_proto_enums_equal_the_reference(enum):
    ref, got = getattr(jproto, enum), getattr(tproto, enum)
    assert {m.name: m.value for m in got} == {m.name: m.value for m in ref}


def test_proto_dtype_maps_equal_the_reference():
    for dt in jproto.DataType:
        if dt in (jproto.DataType.kBfloat16, jproto.DataType.kUnknown):
            continue
        assert tproto.to_np_dtype(dt) == jproto.to_np_dtype(dt)
    # numpy has no bf16 without ml_dtypes: the port names the torch map
    with pytest.raises(ValueError, match="to_torch_dtype"):
        tproto.to_np_dtype(tproto.DataType.kBfloat16)
    for m in (tproto, jproto):
        with pytest.raises(ValueError):
            m.to_np_dtype(m.DataType.kUnknown)
    for dtype in list(jproto._TO_NP.values()) + [np.dtype(np.bool_),
                                                 np.dtype(np.complex64)]:
        assert tproto.from_np_dtype(dtype) == jproto.from_np_dtype(dtype)
    assert set(tproto._FROM_NP) == set(jproto._FROM_NP) - {
        jproto.to_np_dtype(jproto.DataType.kBfloat16)}


def test_proto_torch_maps_agree_with_the_numpy_ones():
    for dt in tproto.DataType:
        if dt == tproto.DataType.kUnknown:
            with pytest.raises(ValueError):
                tproto.to_torch_dtype(dt)
            continue
        t = tproto.to_torch_dtype(dt)
        assert tproto.from_torch_dtype(t) == dt
        if dt != tproto.DataType.kBfloat16:
            assert torch.from_numpy(
                np.zeros(1, tproto.to_np_dtype(dt))).dtype == t
    assert tproto.to_torch_dtype(tproto.DataType.kBfloat16) == torch.bfloat16
    assert tproto.from_torch_dtype(torch.complex64) == \
        tproto.DataType.kUnknown
