"""CPU tests of how the port's CUDA kernels are built: the build key, the
include path of the shared header, and the planted-fault tables that
chip_smoke.py builds from the kernel sources.  Nothing here needs nvcc or
a card: `_build._out_path` only hashes files."""

import importlib.util
from pathlib import Path

import pytest

from singa_tpu_torch import _build, kernel_check

_ROOT = Path(__file__).resolve().parents[1]


def _tree(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    return csrc


def test_out_path_changes_when_a_shared_header_changes(tmp_path, monkeypatch):
    csrc = _tree(tmp_path)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    src = csrc / "k.cu"
    first = _build._out_path(src)
    assert first == _build._out_path(src), "the key is stable"
    (csrc / "h.cuh").write_text("// two\n")
    edited = _build._out_path(src)
    assert edited != first and edited.parent == first.parent
    (csrc / "h.cuh").write_text("// one\n")
    assert _build._out_path(src) == first
    (csrc / "extra.cuh").write_text("// new header\n")
    assert _build._out_path(src) != first


def test_a_copy_outside_csrc_builds_beside_itself_keyed_on_headers(
        tmp_path, monkeypatch):
    """The planted-fault copies live in a temporary directory: they build
    there, and an edited header rebuilds them too."""
    csrc = _tree(tmp_path)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    copy = tmp_path / "fault.cu"
    copy.write_text('#include "h.cuh"\n')
    first = _build._out_path(copy)
    assert first.parent == tmp_path and first.name.startswith("fault-")
    (csrc / "h.cuh").write_text("// two\n")
    assert _build._out_path(copy) != first


def test_nvcc_finds_the_shared_header_and_links_no_driver_library():
    flags = _build.NVCC_FLAGS
    assert flags[flags.index("-I") + 1] == str(_build._CSRC)
    assert (_build._CSRC / "hopper.cuh").exists()
    fwd = _build.source_path("flash_fwd").read_text()
    assert '#include "hopper.cuh"' in fwd
    # cuTensorMapEncodeTiled comes through the runtime, so no -lcuda
    assert not any(f.startswith("-lcuda") for f in flags)
    header = (_build._CSRC / "hopper.cuh").read_text()
    assert "cudaGetDriverEntryPoint" in header


_FAULTS = ([("flash_fwd", kernel_check.FLASH_FAULTS, n)
            for n in kernel_check.FLASH_FAULTS]
           + [("flash_bwd", kernel_check.FLASH_BWD_FAULTS, n)
              for n in kernel_check.FLASH_BWD_FAULTS])


@pytest.mark.parametrize("kernel,table,name", _FAULTS,
                         ids=[n for _, _, n in _FAULTS])
def test_planted_fault_text_occurs_once_in_its_source(kernel, table, name):
    case, old, new = table[name]
    src = _build.source_path(kernel).read_text()
    assert src.count(old) == 1, f"{name}: {src.count(old)} matches"
    assert new != old and case in kernel_check.FLASH_CASES
    faulty = kernel_check._fault_source(kernel, table, name)
    assert faulty.count(new) == 1 + src.count(new)


def test_train_step_faults_name_every_planted_fault_without_a_window():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  _ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    planted = {**kernel_check.FLASH_FAULTS, **kernel_check.FLASH_BWD_FAULTS}
    assert set(smoke.TRAIN_FAULTS) <= set(planted)
    windowless = {n for n, (case, _, _) in planted.items()
                  if kernel_check.FLASH_CASES[case][7] is None}
    assert windowless == set(smoke.TRAIN_FAULTS)
