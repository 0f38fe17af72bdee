"""The port's ops (RoPE, attention routing, KV cache) against the JAX
package's, on the CPU, plus the port's import hygiene and device rules.

Inputs come from numpy with a seed and pass between the frameworks as
numpy.  Tolerances: f32 math in both, differing only in op order and in
the cos/sin/exp implementations — atol 1e-5 (1e-6 for the cache writes,
which are exact copies)."""

import ast
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import attention as jattn
from singa_tpu.ops import kv_cache as jkv
from singa_tpu.ops import rope as jrope
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.ops import attention as tattn
from singa_tpu_torch.ops import kv_cache as tkv
from singa_tpu_torch.ops import rope as trope

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- RoPE ---------------------------------------------------------------------

@pytest.mark.parametrize("scaling", [0.0, 8.0])
def test_rope_tables_match(scaling):
    jc, js = jrope.rope_frequencies(32, 96, 500000.0, scaling, 32)
    tc, ts = trope.rope_frequencies(32, 96, 500000.0, scaling, 32)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=ATOL)
    np.testing.assert_allclose(_np(ts), np.asarray(js), atol=ATOL)


def test_llama31_scaling_matches():
    inv = 1.0 / (10000.0 ** (np.arange(0, 64, 2, dtype=np.float32) / 64))
    j = jrope.llama31_rope_scaling(jnp.asarray(inv), 8.0, 1.0, 4.0, 64)
    t = trope.llama31_rope_scaling(torch.from_numpy(inv), 8.0, 1.0, 4.0, 64)
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6)


@pytest.mark.parametrize("offset", [0, 5, "vector"])
def test_apply_rope_matches(offset):
    x = _rand(3, 4, 2, 16, seed=1)
    jc, js = jrope.rope_frequencies(16, 32, 10000.0, 8.0, 16)
    tc, ts = trope.rope_frequencies(16, 32, 10000.0, 8.0, 16)
    if offset == "vector":
        off = np.array([0, 7, 20], np.int32)
        j = jrope.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(off))
        t = trope.apply_rope(torch.from_numpy(x), tc, ts, torch.from_numpy(off))
    else:
        j = jrope.apply_rope(jnp.asarray(x), jc, js, offset)
        t = trope.apply_rope(torch.from_numpy(x), tc, ts, offset)
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=ATOL)


def test_apply_rope_keeps_bf16():
    x = torch.from_numpy(_rand(1, 4, 2, 16)).bfloat16()
    tc, ts = trope.rope_frequencies(16, 32)
    assert trope.apply_rope(x, tc, ts, 3).dtype == torch.bfloat16


# -- attention ----------------------------------------------------------------

@pytest.mark.parametrize("K,causal,masked", [(4, False, False),
                                             (2, True, False),
                                             (2, False, True)])
def test_sdpa_reference_matches(K, causal, masked):
    q, k, v = _rand(2, 6, 4, 8, seed=2), _rand(2, 9, K, 8, seed=3), \
        _rand(2, 9, K, 8, seed=4)
    mask = None
    if masked:
        mask = np.random.RandomState(5).rand(2, 1, 1, 9) > 0.3
        mask[..., 0] = True
    j = jattn._sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, mask, 0.35)
    t = tattn._sdpa_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal,
                              None if mask is None else torch.from_numpy(mask),
                              0.35)
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=ATOL)


def test_banded_reference_matches():
    q, k, v = _rand(1, 16, 2, 8, seed=6), _rand(1, 16, 2, 8, seed=7), \
        _rand(1, 16, 2, 8, seed=8)
    j = jattn._banded_reference(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), 5, 0.3)
    t = tattn._banded_reference(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), 5, 0.3)
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=ATOL)


def test_use_flash_routing(monkeypatch):
    q = torch.zeros(1, 512, 4, 32)
    k = torch.zeros(1, 512, 2, 32)
    assert not tattn._use_flash(q, k), "a CPU tensor never routes to the card"
    assert not tattn._use_flash(torch.zeros(1, 256, 4, 32), k)
    assert not tattn._use_flash(q, torch.zeros(1, 512, 3, 32))
    on_card = SimpleNamespace(shape=q.shape, is_cuda=True)
    assert tattn._use_flash(on_card, k)
    monkeypatch.setenv("SINGA_DISABLE_FLASH", "1")
    assert not tattn._use_flash(on_card, k)


def test_attention_entry_points_match_jax():
    q, k, v = _rand(1, 12, 4, 8, seed=9), _rand(1, 12, 2, 8, seed=10), \
        _rand(1, 12, 2, 8, seed=11)
    j = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(_np(tattn.sdpa(tq, tk, tv, True)),
                               np.asarray(j), atol=ATOL)
    np.testing.assert_allclose(_np(tattn.attention(tq, tk, tv, causal=True)),
                               np.asarray(j), atol=ATOL)


# -- KV cache -----------------------------------------------------------------

@pytest.mark.parametrize("pos", [3, "vector"])
def test_update_cache_matches(pos):
    B, S, K, D, T = 3, 12, 2, 4, 2
    ck0, cv0 = _rand(B, S, K, D, seed=12), _rand(B, S, K, D, seed=13)
    kn, vn = _rand(B, T, K, D, seed=14), _rand(B, T, K, D, seed=15)
    p = np.array([0, 4, 9], np.int32) if pos == "vector" else pos
    jk, jv = jkv.update_cache(jnp.asarray(ck0), jnp.asarray(cv0),
                              jnp.asarray(kn), jnp.asarray(vn),
                              jnp.asarray(p) if pos == "vector" else p)
    ck, cv = torch.from_numpy(ck0.copy()), torch.from_numpy(cv0.copy())
    tk, tv = tkv.update_cache(ck, cv, torch.from_numpy(kn),
                              torch.from_numpy(vn),
                              torch.from_numpy(p) if pos == "vector" else p)
    assert tk is ck and tv is cv, "the port updates the cache in place"
    np.testing.assert_allclose(_np(tk), np.asarray(jk), atol=1e-6)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=1e-6)


def test_init_cache_shapes():
    caches = tkv.init_cache(3, 2, 16, 2, 8, torch.bfloat16)
    assert len(caches) == 3
    assert caches[0][0].shape == (2, 16, 2, 8)
    assert caches[0][1].dtype == torch.bfloat16


@pytest.mark.parametrize("limit,window,T", [(7, None, 1), ("vector", None, 1),
                                            (9, 3, 1), ("vector", 4, 2)])
def test_cached_sdpa_matches(limit, window, T):
    B, S, H, K, D = 3, 10, 4, 2, 8
    q = _rand(B, T, H, D, seed=16)
    ck, cv = _rand(B, S, K, D, seed=17), _rand(B, S, K, D, seed=18)
    lim = np.array([2, 6, 10], np.int32) if limit == "vector" else limit
    j = jkv.cached_sdpa(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                        jnp.asarray(lim) if limit == "vector" else lim,
                        window=window)
    t = tkv.cached_sdpa(torch.from_numpy(q), torch.from_numpy(ck),
                        torch.from_numpy(cv),
                        torch.from_numpy(lim) if limit == "vector" else lim,
                        window=window)
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=ATOL)


# -- hygiene ------------------------------------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "singa", "singa_tpu", "tools", "ml_dtypes",
              "onnx")


def _forbidden_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in _FORBIDDEN]
    return bad


def test_port_imports_no_jax_and_no_reference_package():
    """The package (serve/disagg, serve/net, autotune, train and tools
    included), chip_smoke.py and the module whose builder the process
    tier's workers import: no jax, no JAX package and not its
    ``tools``."""
    files = sorted((REPO / "singa_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"]
    assert {"disagg", "net", "tools", "sonnx", "parallel",
            "autotune", "train"} <= {f.parent.name for f in files}
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"singa_tpu_torch/tools/loadgen.py",
            "singa_tpu_torch/tools/chaosd.py",
            "singa_tpu_torch/tools/autotune.py",
            "singa_tpu_torch/tools/ckpt_fsck.py",
            "singa_tpu_torch/autotune/table.py",
            "singa_tpu_torch/obs/cost.py",
            "singa_tpu_torch/train/state.py",
            "singa_tpu_torch/train/ckpt.py",
            "singa_tpu_torch/train/loop.py",
            "singa_tpu_torch/train/preempt.py",
            "singa_tpu_torch/utils/timing.py",
            "singa_tpu_torch/utils/profiler.py",
            "singa_tpu_torch/tensor.py",
            "singa_tpu_torch/proto.py",
            "singa_tpu_torch/models/convert.py",
            "singa_tpu_torch/tools/obsq.py",
            "singa_tpu_torch/ops/ring_attention.py",
            "singa_tpu_torch/parallel/mesh.py",
            "singa_tpu_torch/parallel/spmd.py",
            "singa_tpu_torch/parallel/tensor_parallel.py",
            "singa_tpu_torch/parallel/pipeline.py",
            "singa_tpu_torch/parallel/planner.py"} <= names
    assert len(files) > 10
    found = {str(f.relative_to(REPO)): _forbidden_imports(f) for f in files}
    assert not {f: b for f, b in found.items() if b}


def test_forbidden_import_detector_catches_each_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom singa_tpu.ops import rope\n"
                   "import singa_tpu_torch\nfrom . import device\n"
                   "from singa import tensor\nimport ml_dtypes\n"
                   "from onnx import helper\nimport onnxruntime\n")
    assert _forbidden_imports(src) == ["jax.numpy", "singa_tpu.ops", "singa",
                                       "ml_dtypes", "onnx"]


def test_auto_device_is_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.create_device("auto")
    tdevice.set_default_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.get_default_device()


def test_kernel_build_is_lazy_and_names_missing_nvcc(monkeypatch, tmp_path):
    from singa_tpu_torch import _build
    assert _build.source_path("flash_fwd").exists()
    assert not _build._loaded, "nothing builds at import"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_planted_faults_apply_once_to_the_kernel_source():
    from singa_tpu_torch import _build, kernel_check
    src = _build.source_path("flash_fwd").read_text()
    for name, (case, old, new) in kernel_check.FLASH_FAULTS.items():
        assert case in kernel_check.FLASH_CASES
        faulty = kernel_check.flash_fault_source(name)
        assert faulty == src.replace(old, new) and faulty != src


def test_kernel_limits_pass_rounding_and_catch_a_row_local_fault():
    """A bf16 rounding of the plain version's o passes the limits; the
    same o with one row's P·V short of 16 of its 768 keys does not."""
    from singa_tpu_torch import kernel_check
    from singa_tpu_torch.ops import flash_attention as tfa
    q, k, v = (torch.from_numpy(_rand(1, 1024, 2, 64, seed=s) * 0.3)
               for s in range(3))
    ro, rl = tfa._flash_fwd_reference(q, k, v, True, 0.125)
    rounded = ro.to(torch.bfloat16)
    assert kernel_check.flash_errors(rounded, rl, ro, rl,
                                     torch.bfloat16)["ok"]
    p = torch.softmax((q[0, 767, 0] @ k[0, :768, 0].T) * 0.125, dim=-1)
    faulty = rounded.clone()
    faulty[0, 767, 0] -= (p[:16, None] * v[0, :16, 0]).sum(0).bfloat16()
    errs = kernel_check.flash_errors(faulty, rl, ro, rl, torch.bfloat16)
    assert not errs["ok"] and errs["max_abs_do"] < 2e-2, errs


def test_cpu_device_is_explicit():
    dev = tdevice.create_device("cpu")
    assert dev.torch_device.type == "cpu"
    assert dev.default_dtype == torch.float32
    dev.SetRandSeed(3)
    a = torch.rand(4, generator=dev.generator)
    dev.SetRandSeed(3)
    assert torch.equal(a, torch.rand(4, generator=dev.generator))
    dev.Sync()
    assert dev.memory_stats() == {}
    with pytest.raises(ValueError, match="unknown device kind"):
        tdevice.create_device("tpu")
