"""The port's DataLoader cursor, its state dict and its ``data.next``
fault site, against the JAX package's numpy pipeline
(``singa_tpu.utils.data.DataLoader(use_native=False)``).

A loop that breaks mid-epoch leaves the cursor there: iterating again
yields the rest of the same permutation, in both packages.  A state
dict carried into a fresh loader resumes bitwise, and a ``data.next``
plan fires on the same draws and as often as the reference's.  The
batches are held exactly."""

import warnings

import numpy as np
import pytest

from singa_tpu import faults as jfaults
from singa_tpu.utils import data as jdata
from singa_tpu_torch import faults as tfaults
from singa_tpu_torch.utils import data as tdata


@pytest.fixture(autouse=True)
def _no_plan_leak():
    yield
    tfaults.uninstall()
    jfaults.uninstall()


def _arrays(n=40):
    x = np.random.RandomState(0).randn(n, 3).astype(np.float32)
    return x, np.arange(n, dtype=np.int32)


def _pair(**kw):
    x, y = _arrays(kw.pop("n", 40))
    kw = dict(batch_size=8, shuffle=True, seed=1, **kw)
    return jdata.DataLoader(x, y, use_native=False, **kw), \
        tdata.DataLoader(x, y, **kw)


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def _draw(loader, n):
    out = []
    for b in loader:
        out.append(b)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("drawn", [1, 3])
def test_a_broken_epoch_resumes_as_the_reference(drawn):
    ref, port = _pair()
    first = _draw(port, drawn)
    _assert_same(first, _draw(ref, drawn))
    rest, want = list(port), list(ref)
    assert len(rest) == len(want) == 5 - drawn
    _assert_same(rest, want)
    # the used batches are not yielded again, and the next epoch is whole
    seen = np.concatenate([b[1] for b in first + rest])
    assert sorted(seen) == list(range(40))
    _assert_same(list(port), list(ref))


def test_state_dict_resumes_bitwise_in_a_fresh_loader():
    _, port = _pair()
    list(port)                       # epoch 0
    _draw(port, 2)                   # two batches of epoch 1
    state = port.state_dict()
    assert state == {"epoch": 1, "batch_idx": 2, "seed": 1,
                     "num_samples": 40}
    tail = [b for _ in range(2) for b in port]   # rest of 1, all of 2
    x, y = _arrays()
    fresh = tdata.DataLoader(x, y, batch_size=8, shuffle=True, seed=99)
    fresh.load_state_dict(state)
    assert fresh.state_dict() == state
    _assert_same([b for _ in range(2) for b in fresh], tail)
    ref = jdata.DataLoader(x, y, batch_size=8, shuffle=True, seed=99,
                           use_native=False)
    ref.load_state_dict(state)
    _assert_same([b for _ in range(2) for b in ref], tail)


def test_a_changed_length_warns_once():
    _, port = _pair()
    state = port.state_dict()
    x, y = _arrays(24)
    other = tdata.DataLoader(x, y, batch_size=8)
    with pytest.warns(UserWarning, match="length changed"):
        other.load_state_dict(state)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        other.load_state_dict(state)


@pytest.mark.parametrize("text", ["data.next=error:every=2",
                                  "data.next=nan:at=3",
                                  "data.next=error:p=0.5,times=3"])
def test_data_next_fires_as_the_reference(text):
    ref, port = _pair()

    def run(loader, faults_mod):
        plan = faults_mod.FaultPlan.parse(text, seed=4)
        out = []
        with faults_mod.active(plan):
            for _ in range(3):               # epochs
                it = iter(loader)
                while True:
                    try:
                        out.append(("ok", next(it)))
                    except faults_mod.InjectedFault:
                        out.append(("fault", None))
                        continue          # a retry skips the batch
                    except StopIteration:
                        break
        return plan.fire_count("data.next"), out, loader.state_dict()

    jn, jout, jstate = run(ref, jfaults)
    tn, tout, tstate = run(port, tfaults)
    assert tn == jn > 0
    assert tstate == jstate
    assert [k for k, _ in tout] == [k for k, _ in jout]
    for (k, g), (_, w) in zip(tout, jout):
        if k == "ok":
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
    if "nan" in text:
        nan_rows = [np.isnan(b[0]).all() for k, b in tout if k == "ok"]
        assert nan_rows.count(True) == 1
