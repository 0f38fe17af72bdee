"""The port's native core (singa_tpu_torch._core over its copy of the C++
runtime, singa_tpu_torch/csrc/core) against the reference's
(singa_tpu._core over csrc/), on the CPU.

Both libraries are built from the same code with the same flags
(csrc/Makefile's), by the same g++ on the same host, so every kernel
wrapper is held to the reference's bitwise; against torch the
tolerances are stated per case.  The scheduler's order, arena and
offsets and the 1-worker loader's batches are held equal.  Tests that
start threads run their body on a thread joined with a timeout
(`_bounded`); the compiler runs under `_build`'s own timeout.

Also here: ``device``'s additions (``create_cpu_device(use_native=)``,
``Platform``, ``native_cpu``), ``autograd.Operator`` and the native
dispatch of the nine ops, ``DataLoader(workers=, prefetch=,
use_native=)`` and ``parallel``'s ``plan_train_step`` export."""

import subprocess
import threading
import warnings

import numpy as np
import pytest
import torch

from singa_tpu import _core as jcore
from singa_tpu import autograd as jautograd
from singa_tpu import device as jdevice
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.utils import data as jdata
from singa_tpu_torch import _build
from singa_tpu_torch import _core as tcore
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import kernel_check
from singa_tpu_torch import models as tmodels
from singa_tpu_torch.utils import data as tdata

# each test that starts threads ends within this, or fails
THREAD_TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def cores():
    """Both libraries, built once for the file."""
    return jcore.lib(), tcore.lib()


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)


def _bounded(fn, timeout=THREAD_TIMEOUT_S):
    """fn() on a thread joined within `timeout`: its result, or a
    failure if it did not end (a deadlocked loader) or raised."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:      # re-raised on the test's thread
            out["error"] = e
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"did not end within {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _rng(seed):
    return np.random.RandomState(seed)


def test_version_is_the_references(cores):
    assert tcore.version() == jcore.version() == "singa_core 0.1.0"
    assert tcore.available()


def test_one_loaded_library_a_process(cores):
    """`built()` is the one per-process cache: the library `lib()` hands
    out, from a file keyed in the port's build directory; calling it
    again neither rebuilds nor reloads."""
    b = tcore.built()
    assert b.lib is tcore.lib() and tcore.built() is b
    assert b.path.parent == _build._BUILD_DIR and b.path.exists()
    assert b.path.name.startswith("singa_core-") and b.seconds >= 0.0


def _f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# wrapper: (call on (module, arrays), arrays from a RandomState, torch
# reference, torch tolerance (rtol, atol))
WRAPPERS = {
    "gemm": (lambda c, a, b: c.gemm(a, b),
             lambda r: (_f32(r, 37, 53), _f32(r, 53, 29)),
             lambda a, b: a @ b, (1e-5, 1e-5)),
    "gemm_transa_alpha": (lambda c, a, b: c.gemm(a, b, transa=True,
                                                 alpha=0.5),
                          lambda r: (_f32(r, 53, 37), _f32(r, 53, 29)),
                          lambda a, b: 0.5 * (a.T @ b), (1e-5, 1e-5)),
    "gemm_transb": (lambda c, a, b: c.gemm(a, b, transb=True),
                    lambda r: (_f32(r, 37, 53), _f32(r, 29, 53)),
                    lambda a, b: a @ b.T, (1e-5, 1e-5)),
    "add": (lambda c, a, b: c.add(a, b),
            lambda r: (_f32(r, 1000), _f32(r, 1000)),
            torch.add, (0, 0)),
    "sub": (lambda c, a, b: c.sub(a, b),
            lambda r: (_f32(r, 1000), _f32(r, 1000)),
            torch.sub, (0, 0)),
    "mul": (lambda c, a, b: c.mul(a, b),
            lambda r: (_f32(r, 1000), _f32(r, 1000)),
            torch.mul, (0, 0)),
    "div": (lambda c, a, b: c.div(a, b),
            lambda r: (_f32(r, 1000), _f32(r, 1000) + 3.0),
            torch.div, (0, 0)),
    "relu": (lambda c, a: c.relu(a), lambda r: (_f32(r, 1027),),
             torch.relu, (0, 0)),
    "sigmoid": (lambda c, a: c.sigmoid(a), lambda r: (_f32(r, 1027),),
                torch.sigmoid, (1e-6, 1e-7)),
    "tanh": (lambda c, a: c.tanh(a), lambda r: (_f32(r, 1027),),
             torch.tanh, (1e-6, 1e-7)),
    "exp": (lambda c, a: c.exp(a), lambda r: (_f32(r, 1027),),
            torch.exp, (1e-6, 0)),
    "relu_grad": (lambda c, a, dy: c.relu_grad(a, dy),
                  lambda r: (_f32(r, 1027), _f32(r, 1027)),
                  lambda a, dy: torch.where(a > 0, dy, 0.0), (0, 0)),
    "softmax": (lambda c, a: c.softmax(a), lambda r: (_f32(r, 10, 100),),
                lambda a: torch.softmax(a, -1), (1e-5, 1e-7)),
    "array_sum": (lambda c, a: np.float32(c.array_sum(a)),
                  lambda r: (_f32(r, 100003),),
                  lambda a: a.double().sum().float(), (1e-6, 1e-4)),
    "conv2d_nhwc": (lambda c, x, w: c.conv2d_nhwc(x, w, (2, 2), (1, 1)),
                    lambda r: (_f32(r, 2, 8, 8, 3), _f32(r, 3, 3, 3, 5)),
                    lambda x, w: torch.nn.functional.conv2d(
                        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                        stride=2, padding=1).permute(0, 2, 3, 1),
                    (1e-5, 1e-5)),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_is_the_references_bitwise_and_torchs(cores, name):
    call, make, ref, (rtol, atol) = WRAPPERS[name]
    arrays = make(_rng(sorted(WRAPPERS).index(name)))
    mine = call(tcore, *arrays)
    theirs = call(jcore, *arrays)
    np.testing.assert_array_equal(np.asarray(mine), np.asarray(theirs))
    want = ref(*[torch.from_numpy(a) for a in arrays]).numpy()
    np.testing.assert_allclose(mine, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["gemm", "add", "tanh", "softmax",
                                  "conv2d_nhwc"])
def test_wrapper_takes_tensors_without_a_copy(cores, name):
    """A contiguous f32 CPU tensor goes in by its address and a tensor
    comes out, equal to the numpy call's; a non-contiguous one is made
    contiguous first."""
    call, make, _, _ = WRAPPERS[name]
    arrays = make(_rng(7))
    ts = [torch.from_numpy(a) for a in arrays]
    got = call(tcore, *ts)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), call(tcore, *arrays))
    if ts[0].ndim == 2:
        t = torch.from_numpy(np.ascontiguousarray(arrays[0].T)).T
        assert not t.is_contiguous()
        np.testing.assert_array_equal(
            np.asarray(call(tcore, t, *ts[1:])), call(tcore, *arrays))


def test_sgd_update_in_place_is_the_references(cores):
    rng = _rng(3)
    p, g, m = _f32(rng, 257), _f32(rng, 257), _f32(rng, 257)
    pj, mj = p.copy(), m.copy()
    pt, mt = torch.from_numpy(p.copy()), torch.from_numpy(m.copy())
    jcore.sgd_update(pj, g, mj, lr=0.1, momentum=0.9, weight_decay=1e-2)
    tcore.sgd_update(pt, g, mt, lr=0.1, momentum=0.9, weight_decay=1e-2)
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(mt.numpy(), mj)
    gt = torch.from_numpy(g) + 1e-2 * torch.from_numpy(p)
    mw = 0.9 * torch.from_numpy(m) + gt
    np.testing.assert_allclose(mt.numpy(), mw.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pt.numpy(), p - 0.1 * mw.numpy(), rtol=1e-6,
                               atol=1e-7)
    q = np.ones(10, np.float32)
    tcore.sgd_update(q, np.full(10, 0.5, np.float32), None, lr=0.1)
    np.testing.assert_allclose(q, 0.95, rtol=1e-6)
    with pytest.raises(ValueError, match="in place"):
        tcore.sgd_update(np.ones(4), np.ones(4, np.float32), None, lr=0.1)


def test_reductions_hold_beside_torchs_openmp(cores):
    """torch's OpenMP runtime and the library's (the system libgomp) in
    one process: the library's threaded reduction and product hold their
    tolerance against float64 here, at this process's thread counts."""
    assert torch.get_num_threads() >= 1 and tcore.omp_max_threads() >= 1
    rng = _rng(11)
    a = _f32(rng, 1 << 20)
    assert abs(tcore.array_sum(a) - a.astype(np.float64).sum()) <= \
        1e-6 * np.abs(a).sum()
    x, w = _f32(rng, 300, 200), _f32(rng, 200, 100)
    np.testing.assert_allclose(tcore.gemm(x, w),
                               x.astype(np.float64) @ w.astype(np.float64),
                               rtol=1e-4, atol=1e-4)


# -- scheduler ----------------------------------------------------------------

GRAPHS = {
    # the reference's diamond, a chain whose outputs die early, and a
    # node list out of order with buffers of mixed sizes
    "diamond": [("a", [0], [1], [256]), ("b", [1], [2], [256]),
                ("c", [1], [3], [256]), ("d", [2, 3], [4], [256])],
    "chain": [(f"n{i}", [i], [i + 1], [100 * (i + 1)]) for i in range(8)],
    "shuffled": [("c", [3, 1], [4], [70]), ("a", [0], [1, 2], [64, 4096]),
                 ("b", [2], [3], [1000]), ("d", [4, 2], [5], [9])],
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_native_graph_plans_as_the_references(cores, name):
    mine, theirs = tcore.NativeGraph(), jcore.NativeGraph()
    for node in GRAPHS[name]:
        assert mine.add_node(*node, flops=7) == theirs.add_node(*node,
                                                                flops=7)
    assert mine.toposort() == theirs.toposort()
    assert mine.plan_memory() == theirs.plan_memory()
    assert mine.num_nodes == theirs.num_nodes == len(GRAPHS[name])
    assert mine.total_flops == 7 * len(GRAPHS[name])
    arena, offsets = mine.plan_memory()
    assert 0 < arena <= sum(-(-s // 64) * 64 for n in GRAPHS[name]
                            for s in n[3])


def test_native_graph_cycle_raises(cores):
    g = tcore.NativeGraph()
    g.add_node("a", [1], [0], [64])
    g.add_node("b", [0], [1], [64])
    with pytest.raises(ValueError, match="cycle"):
        g.toposort()
    with pytest.raises(ValueError, match="cycle"):
        g.plan_memory()


# -- data loader --------------------------------------------------------------

def _epochs(loader, epochs):
    out = []
    for _ in range(epochs):
        out.append([loader.next() for _ in range(loader.batches_per_epoch)])
    return out


def test_native_loader_epoch_rows_match_labels(cores):
    x, y = _f32(_rng(3), 100, 4), np.arange(100, dtype=np.int32)
    ld = tcore.NativeLoader(x, y, batch=32, shuffle=True, seed=7)
    try:
        assert ld.batches_per_epoch == 4
        (batches,) = _bounded(lambda: _epochs(ld, 1))
    finally:
        ld.close()
    seen = [int(v) for _, by in batches for v in by]
    assert sorted(seen) == list(range(100))
    for bx, by in batches:
        np.testing.assert_array_equal(bx, x[by])


def test_native_loader_four_workers_three_epochs(cores):
    """The reference's stress case: 4 workers, a ring of 4, 1000 rows,
    three epochs, each whole and each batch's rows its labels'."""
    x, y = _f32(_rng(4), 1000, 1), np.arange(1000, dtype=np.int32)
    ld = tcore.NativeLoader(x, y, batch=32, shuffle=True, seed=0,
                            workers=4, prefetch=4)
    try:
        epochs = _bounded(lambda: _epochs(ld, 3))
    finally:
        ld.close()
    for batches in epochs:
        assert sorted(int(v) for _, by in batches for v in by) == \
            list(range(1000))
        for bx, by in batches:
            np.testing.assert_array_equal(bx[:, 0], x[by, 0])


def test_native_loader_one_worker_is_the_references_bitwise(cores):
    x, y = _f32(_rng(5), 70, 2, 3), np.arange(70, dtype=np.int32)
    kw = dict(batch=16, shuffle=True, seed=3, workers=1, prefetch=2)
    mine, theirs = tcore.NativeLoader(x, y, **kw), \
        jcore.NativeLoader(x, y, **kw)
    try:
        got = _bounded(lambda: _epochs(mine, 2))
        want = _bounded(lambda: _epochs(theirs, 2))
    finally:
        mine.close()
        theirs.close()
    for ge, we in zip(got, want):
        for (gx, gy), (wx, wy) in zip(ge, we):
            assert gx.shape == wx.shape and gx.shape[1:] == (2, 3)
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_native_loader_holds_its_arrays_and_closes(cores):
    """The threads read x after the constructor returns: the loader
    keeps the contiguous f32 copy it passed (a cast from float64 here),
    and close() joins them, after which next() stops."""
    x = _rng(6).randn(40, 3)                     # float64: cast, a temporary
    ld = tcore.NativeLoader(x, None, batch=8, seed=1, workers=2)
    assert ld.x.dtype == np.float32 and ld.x.flags["C_CONTIGUOUS"]
    bx, by = _bounded(ld.next)
    assert by is None and bx.shape == (8, 3)
    assert any(np.array_equal(bx[0], r) for r in x.astype(np.float32))
    _bounded(ld.close)
    ld.close()
    with pytest.raises(StopIteration):
        ld.next()


def test_pool_reuses_its_bucket(cores):
    p = tcore.pool_alloc(1000)
    used = tcore.pool_bytes_in_use()
    assert p and used >= 1024 and tcore.pool_bytes_reserved() >= used
    tcore.pool_free(p)
    assert tcore.pool_bytes_in_use() < used
    q = tcore.pool_alloc(1000)                   # the same 1,024-byte bucket
    assert q == p
    tcore.pool_free(q)
    tcore.pool_trim()


def test_core_under_asan():
    """The copy's sources and its test binary under ASan and UBSan (the
    reference's `make asan`)."""
    if not _bounded(_build.asan_supported, 300):
        pytest.skip("g++ here links no -fsanitize=address,undefined program")
    exe = _bounded(_build.build_asan, 300)
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, (r.stdout + r.stderr)[-1500:]
    assert "ALL NATIVE TESTS PASSED" in r.stdout


def test_a_failed_build_raises_everywhere_it_is_asked_for(monkeypatch):
    """No quiet fall back: with the build made to fail, lib(), the
    native CPU device, NativeGraph, NativeLoader and DataLoader(
    use_native=True) raise with the compiler's message; available() is
    False."""
    monkeypatch.setattr(tcore, "_built", None)
    monkeypatch.setattr(tcore, "_error", None)
    monkeypatch.setattr(_build, "GXX_FLAGS",
                        _build.GXX_FLAGS + ["-DSG_PLANTED", "-include",
                                            "no_such_header.h"])
    with pytest.raises(RuntimeError, match="no_such_header"):
        tcore.lib()
    assert not tcore.available()
    x = np.zeros((4, 2), np.float32)
    for make in (lambda: tcore.NativeGraph(),
                 lambda: tcore.NativeLoader(x, None, 2),
                 lambda: tdevice.create_cpu_device(use_native=True),
                 lambda: tdata.DataLoader(x, batch_size=2, use_native=True),
                 lambda: tcore.gemm(x, x.T)):
        with pytest.raises(RuntimeError, match="native core unavailable"):
            make()


# -- DataLoader ---------------------------------------------------------------

def test_dataloader_native_is_the_references_with_one_worker(cores):
    x, y = _f32(_rng(8), 50, 3), np.arange(50, dtype=np.int32)
    kw = dict(batch_size=16, seed=1, use_native=True, workers=1)
    mine, theirs = tdata.DataLoader(x, y, **kw), jdata.DataLoader(x, y, **kw)
    try:
        for _ in range(2):
            got = _bounded(lambda: list(mine))
            want = _bounded(lambda: list(theirs))
            assert len(got) == len(want) == 4
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)
            assert mine.state_dict() == theirs.state_dict()
    finally:
        mine.close()
        theirs.close()


def test_dataloader_int_input_warns_and_takes_numpy(cores):
    ids = np.arange(40, dtype=np.int64).reshape(10, 4)
    with pytest.warns(UserWarning, match="integer input"):
        dl = tdata.DataLoader(ids, batch_size=4, use_native=True)
    assert dl._native is None
    ref = jdata.DataLoader(ids, batch_size=4, use_native=False)
    for (gx, _), (wx, _) in zip(dl, ref):
        assert gx.dtype == np.int32
        np.testing.assert_array_equal(gx, wx)


def test_dataloader_seek_warns_closes_and_resumes(cores):
    """A non-zero position closes the native loader with a warning and
    resumes on the numpy pipeline, as the reference's does."""
    x, y = _f32(_rng(9), 40, 2), np.arange(40, dtype=np.int32)
    mine = tdata.DataLoader(x, y, batch_size=8, seed=2, use_native=True)
    theirs = jdata.DataLoader(x, y, batch_size=8, seed=2, use_native=True)
    state = {"epoch": 1, "batch_idx": 2, "seed": 2, "num_samples": 40}
    with pytest.warns(UserWarning, match="cannot seek"):
        mine.load_state_dict(state)
    with pytest.warns(UserWarning, match="cannot seek"):
        theirs.load_state_dict(state)
    assert mine._native is None and theirs._native is None
    got, want = list(mine), list(theirs)
    assert len(got) == len(want) == 3
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    state = {"epoch": 0, "batch_idx": 0, "seed": 2, "num_samples": 40}
    fresh = tdata.DataLoader(x, y, batch_size=8, seed=2, use_native=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fresh.load_state_dict(state)         # position 0: stays native
    assert fresh._native is not None
    fresh.close()


def test_dataloader_counts_fires_and_closes(cores, monkeypatch):
    """The native pipeline counts the cursor, fires data.next once a
    batch and applies its corruption; close() ends it (idempotent), and
    the numpy pipeline has nothing to close."""
    from singa_tpu_torch import faults
    x, y = _f32(_rng(10), 30, 2), np.arange(30, dtype=np.int32)
    dl = tdata.DataLoader(x, y, batch_size=8, use_native=True, workers=2)
    fired = []
    monkeypatch.setattr(faults, "fire", lambda site, **kw: fired.append(
        (site, kw["epoch"], kw["batch"])))
    it = iter(dl)
    _bounded(lambda: next(it))
    assert dl.state_dict()["batch_idx"] == 1
    rest = _bounded(lambda: list(it))
    assert len(rest) == 3 and dl.state_dict()["epoch"] == 1
    assert fired == [("data.next", 0, b) for b in range(1, 5)]
    _bounded(dl.close)
    dl.close()
    assert dl._native is None
    tdata.DataLoader(x, y, batch_size=8).close()


# -- device -------------------------------------------------------------------

def test_device_additions(cores):
    cpu = tdevice.create_cpu_device()
    assert isinstance(cpu, tdevice.CppCPU) and cpu.use_native is False
    assert tdevice.create_device("cpu").use_native is False
    native = tdevice.create_cpu_device(use_native=True)
    assert native.use_native and native.torch_device.type == "cpu"
    tdevice.set_default_device(cpu)
    assert not tdevice.native_cpu()
    tdevice.set_default_device(native)
    assert tdevice.native_cpu()
    tdevice.set_default_device(None)
    assert not tdevice.native_cpu()
    assert tdevice.Platform.GetNumGPUs() == torch.cuda.device_count()
    assert tdevice.Platform.DeviceQuery() == ""
    assert tdevice.Platform.CreateCudaDevices(0) == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.create_cuda_device(0)
    assert tdevice.enable_lazy_alloc(True) is None
    names = set(tdevice.__all__)
    assert {"Platform", "create_cpu_device", "create_cuda_device",
            "enable_lazy_alloc", "native_cpu"} <= names
    assert set(jdevice.__all__) - names == {
        "TpuDevice", "create_tpu_device", "pjrt_plugin_info",
        "pjrt_native_probe"}


def test_plan_train_step_is_exported_as_the_references():
    import singa_tpu.parallel as jparallel
    import singa_tpu_torch.parallel as tparallel
    assert "plan_train_step" in jparallel.__all__
    assert "plan_train_step" in tparallel.__all__
    assert tparallel.plan_train_step is tparallel.planner.plan_train_step


# -- autograd: the native dispatch and Operator -------------------------------

def _native_default():
    tdevice.set_default_device(tdevice.create_cpu_device(use_native=True))


def test_relu_matmul_gradient_through_the_host_kernels(cores):
    """The reference's native autograd case: relu(matmul) on the native
    device, its gradient against numpy (1e-4); the forward bitwise the
    reference's (the same host kernels), the gradient within 1e-6 (its
    products are torch's here, XLA's there)."""
    rng = _rng(0)
    A, W0 = _f32(rng, 8, 8), _f32(rng, 8, 4)
    _native_default()
    tcore.reset_stats()
    w = torch.from_numpy(W0.copy()).requires_grad_()
    y = tautograd.relu(tautograd.matmul(torch.from_numpy(A), w))
    ((_, gw),) = tautograd.backward(tautograd.reduce_sum(y))
    assert tcore.stats["calls"] == 2
    pre = A @ W0
    np.testing.assert_allclose(gw.numpy(), A.T @ (pre > 0), rtol=1e-4,
                               atol=1e-4)

    dev = jdevice.create_cpu_device(use_native=True)
    jautograd.set_training(True)
    try:
        W = jtensor.Tensor(data=W0, device=dev, requires_grad=True,
                           stores_grad=True)
        jy = jautograd.relu(jautograd.matmul(jtensor.from_numpy(A, dev), W))
        jg = jautograd.backward(jautograd.reduce_sum(jy))[0][1].to_numpy()
    finally:
        jautograd.set_training(False)
    np.testing.assert_allclose(gw.numpy(), jg, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy.data))


def test_mlp_steps_native_against_torch_and_the_reference(cores):
    """Three eager MLP steps (SGD 0.9): through the host kernels against
    torch's kernels within the reference's 1e-4 / 1e-5, the host kernels
    called on one and not the other (kernel_check.native_mlp_losses);
    the port's native losses against the reference's native losses
    from the same weights within 1e-5 relative."""
    native, calls = kernel_check.native_mlp_losses(True)
    plain, plain_calls = kernel_check.native_mlp_losses(False)
    assert calls > 0 and plain_calls == 0
    np.testing.assert_allclose(native, plain, rtol=1e-4, atol=1e-5)

    m = tmodels.MLP(perceptron_size=16, num_classes=4, input_shape=(10,),
                    generator=torch.Generator().manual_seed(0))
    start = {n: p.detach().numpy().copy() for n, p in m.get_params().items()}
    x = np.random.RandomState(1).randn(8, 10).astype(np.float32)
    y = np.random.RandomState(2).randint(0, 4, 8).astype(np.int32)
    dev = jdevice.create_cpu_device(use_native=True)
    jdevice.set_default_device(dev)
    jm = jmodels.MLP(perceptron_size=16, num_classes=4)
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
    jx, jy = jtensor.from_numpy(x, dev), jtensor.from_numpy(y, dev)
    jm.compile([jx], is_train=True, use_graph=False)
    jm.set_params(start)
    jcore.reset_stats()
    ref = [float(jm.train_step(jx, jy)[1].to_numpy()) for _ in range(3)]
    assert jcore.stats["calls"] > 0
    np.testing.assert_allclose(native, ref, rtol=1e-5)


class _TScale(tautograd.Operator):
    """y = a · b · 3 with a hand-written backward."""

    def forward(self, a, b):
        self._a, self._b = a, b
        return a * b * 3.0

    def backward(self, dy):
        return dy * self._b * 3.0, dy * self._a * 3.0


class _TSoftplus(tautograd.Operator):
    """fwd only: torch autograd differentiates it."""

    def fwd(self, a):
        return torch.log1p(torch.exp(a))


class _JScale(jautograd.Operator):
    def forward(self, a, b):
        self._a, self._b = a, b
        return a * b * 3.0

    def backward(self, dy):
        return dy * self._b * 3.0, dy * self._a * 3.0


class _JSoftplus(jautograd.Operator):
    def fwd(self, a):
        import jax.numpy as jnp
        return jnp.log1p(jnp.exp(a))


def test_operator_subclasses_as_the_references(cores):
    """An Operator with a hand-written backward and one with only fwd:
    outputs and gradients against the reference's (1e-6 relative)."""
    rng = _rng(12)
    a0, b0 = _f32(rng, 5, 3), _f32(rng, 5, 3)
    a = torch.from_numpy(a0.copy()).requires_grad_()
    b = torch.from_numpy(b0.copy()).requires_grad_()
    y = _TSoftplus()(_TScale()(a, b))
    ga, gb = torch.autograd.grad(y.sum(), (a, b))

    jautograd.set_training(True)
    try:
        ja = jtensor.Tensor(data=a0, requires_grad=True, stores_grad=True)
        jb = jtensor.Tensor(data=b0, requires_grad=True, stores_grad=True)
        jy = _JSoftplus()(_JScale()(ja, jb))
        grads = dict((id(p), g.to_numpy()) for p, g in
                     jautograd.backward(jautograd.reduce_sum(jy)))
    finally:
        jautograd.set_training(False)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy.data),
                               rtol=1e-6)
    np.testing.assert_allclose(ga.numpy(), grads[id(ja)], rtol=1e-6)
    np.testing.assert_allclose(gb.numpy(), grads[id(jb)], rtol=1e-6)
    with torch.no_grad():
        assert not _TScale()(a, b).requires_grad
    with pytest.raises(TypeError, match="non-tensor"):
        _TScale()(a, 2.0)


class _TSquare(tautograd.Operator):
    """x² with a native forward through the host kernels (mul)."""

    def forward(self, a):
        self._a = a
        return a * a

    def native_fwd(self, a):
        self._a = a
        return tcore.mul(a, a)

    def backward(self, dy):
        return 2 * dy * self._a


class _TSquareFwd(_TSquare):
    backward = tautograd.Operator.backward

    def fwd(self, a):
        return a * a


def test_native_candidate_follows_the_ports_tape_rule(cores):
    """native_fwd runs for f32 host tensors on the native device: with a
    hand-written backward also when a gradient is needed, without one
    only when none is; never for bf16, off the native device, or under
    a trace.  A gradient is needed by the port's rule: torch's grad mode
    and an input that requires one, whatever ``autograd.training`` says.
    So a fwd-only op on such an input takes the torch path here, where
    the reference, with ``training`` False, runs it natively (a stated
    difference, held in the next test)."""
    x = torch.from_numpy(_f32(_rng(13), 6)).requires_grad_()

    def calls(op, t, native=True):
        tdevice.set_default_device(tdevice.create_cpu_device(
            use_native=native))
        tcore.reset_stats()
        out = op(t)
        return tcore.stats["calls"], out
    n, y = calls(_TSquare(), x)
    assert n == 1 and y.requires_grad
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_array_equal(g.numpy(), (2 * x).detach().numpy())
    assert calls(_TSquareFwd(), x)[0] == 0
    assert calls(_TSquareFwd(), x.detach())[0] == 1
    assert calls(_TSquare(), x.detach().bfloat16())[0] == 0
    assert calls(_TSquare(), x, native=False)[0] == 0
    from torch.fx.experimental.proxy_tensor import make_fx
    tdevice.set_default_device(tdevice.create_cpu_device(use_native=True))
    tcore.reset_stats()
    gm = make_fx(lambda t: tautograd.relu(tautograd.tanh(t)))(x.detach())
    assert tcore.stats["calls"] == 0
    assert "aten.tanh" in str(gm.graph)


class _JSquareFwd(jautograd.Operator):
    """x², fwd only, with a native forward through the reference's host
    kernels (mul)."""

    def fwd(self, a):
        return a * a

    def native_fwd(self, a):
        return jcore.mul(a, a)


def test_tape_switch_is_grad_mode_here_and_training_in_the_reference(
        cores, monkeypatch):
    """The stated difference in what switches the tape on.  With
    ``autograd.training`` False (both packages' default) and torch's
    grad mode on, the reference records nothing (``backward`` returns
    []) and the port records a gradient; under ``torch.no_grad()``
    neither records.  A fwd-only Operator on the native device: one
    native call in the reference, none here with grad mode on (torch
    autograd needs the torch forward), one under ``torch.no_grad()``."""
    monkeypatch.setattr(tautograd, "training", False)
    assert jautograd.training is False
    x0 = _f32(_rng(14), 6)
    jdev = jdevice.create_cpu_device(use_native=True)

    def ref_x():
        return jtensor.Tensor(data=x0, device=jdev, requires_grad=True,
                              stores_grad=True)

    def ref_grads():
        jx = ref_x()
        return jautograd.backward(jautograd.reduce_sum(jautograd.mul(jx, jx)))

    def port_grads(x):
        return tautograd.backward(tautograd.reduce_sum(tautograd.mul(x, x)))

    x = torch.from_numpy(x0.copy()).requires_grad_()
    assert ref_grads() == []
    ((leaf, g),) = port_grads(x)
    assert leaf is x
    np.testing.assert_allclose(g.numpy(), 2 * x0, rtol=1e-6)
    with torch.no_grad():
        assert ref_grads() == [] and port_grads(x) == []

    jcore.reset_stats()
    jy = _JSquareFwd()(ref_x())
    assert jcore.stats["calls"] == 1 and jy.creator is None
    _native_default()
    tcore.reset_stats()
    y = _TSquareFwd()(x)
    assert tcore.stats["calls"] == 0 and y.requires_grad
    with torch.no_grad():
        y = _TSquareFwd()(x)
    assert tcore.stats["calls"] == 1 and not y.requires_grad
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy.data))


# the nine ops the reference's CppCPU runs natively, on inputs that meet
# their conditions: (call, input shapes)
NATIVE_OPS = {
    "add": (lambda a, b: tautograd.add(a, b), [(4, 5), (4, 5)]),
    "mul": (lambda a, b: tautograd.mul(a, b), [(4, 5), (4, 5)]),
    "matmul": (lambda a, b: tautograd.matmul(a, b), [(4, 5), (5, 3)]),
    "linear": (lambda x, w, b: tautograd.linear(x, w, b),
               [(4, 5), (5, 3), (3,)]),
    "relu": (lambda a: tautograd.relu(a), [(4, 5)]),
    "sigmoid": (lambda a: tautograd.sigmoid(a), [(4, 5)]),
    "tanh": (lambda a: tautograd.tanh(a), [(4, 5)]),
    "softmax": (lambda a: tautograd.softmax(a), [(4, 5)]),
    "conv2d": (lambda x, w: tautograd.conv2d(x, w, None, 1, 1),
               [(2, 6, 6, 3), (3, 3, 3, 4)]),
}


@pytest.mark.parametrize("name", list(NATIVE_OPS))
def test_native_op_matches_torch_path(cores, name):
    """Each op on the native device against the same op on the plain CPU
    device: outputs within 1e-5 and, where the reference's rule lets it
    go native with a gradient (every op but conv2d), input gradients
    within 1e-5; the host kernels called once (conv2d: only without a
    gradient)."""
    call, shapes = NATIVE_OPS[name]
    rng = _rng(14)
    arrays = [_f32(rng, *s) for s in shapes]

    def run(native, grad):
        tdevice.set_default_device(tdevice.create_cpu_device(
            use_native=native))
        ts = [torch.from_numpy(a.copy()).requires_grad_(grad)
              for a in arrays]
        tcore.reset_stats()
        out = call(*ts)
        n = tcore.stats["calls"]
        grads = torch.autograd.grad(out.square().sum(), ts) if grad else ()
        return out.detach(), grads, n
    for grad in (False, True):
        out, grads, n = run(True, grad)
        pout, pgrads, pn = run(False, grad)
        assert pn == 0
        assert n == (0 if name == "conv2d" and grad else 1)
        np.testing.assert_allclose(out.numpy(), pout.numpy(), rtol=1e-5,
                                   atol=1e-5)
        for g, pg in zip(grads, pgrads):
            np.testing.assert_allclose(g.numpy(), pg.numpy(), rtol=1e-5,
                                       atol=1e-5)
