"""Build and bind the port's CUDA kernels.

Each kernel source ``singa_tpu_torch/csrc/<name>.cu`` exposes a plain C
entry point.  At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into ``build/singa_tpu_torch/<name>-<hash>.so`` at the root
of the checkout, keyed on the hash of the source and of every shared
header ``csrc/*.cuh``, and loaded with ``ctypes``.  A source outside
``csrc/`` builds beside itself and still finds those headers (``-I``).
No driver library is linked: a kernel that needs a driver-API function
(``cuTensorMapEncodeTiled``) fetches it through the runtime.  `build`
starts one ``nvcc`` per source, all at once.  Nothing is built when a
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence

__all__ = ["Built", "build", "load", "source_path", "nvcc_path"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "singa_tpu_torch"
_DEFAULT_CUDA_HOME = "/usr/local/cuda"   # the CUDA toolkit's install default

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(_CSRC)]


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float      # compile time in this process (0.0 when cached)
    log: str            # nvcc/ptxas output of the build


#: loaded libraries by the path of their .so
_loaded: Dict[str, Built] = {}


def source_path(name: str) -> Path:
    return _CSRC / f"{name}.cu"


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), _DEFAULT_CUDA_HOME):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _out_path(src: Path) -> Path:
    """Where `src` builds to, keyed on it and on the shared headers."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    out_dir = _BUILD_DIR if src.parent == _CSRC else src.parent
    return out_dir / f"{src.stem}-{digest}.so"


def build(srcs: Sequence[Path]) -> List[Built]:
    """Compile each source not built yet (one nvcc each, all started
    together; raises after all have ended if any failed) and load it."""
    outs = [_out_path(Path(s)) for s in srcs]
    jobs = []
    for src, out in zip(srcs, outs):
        if str(out) in _loaded or out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((Path(src), out, tmp, time.perf_counter(), proc))
    seconds, failed = {}, []
    for src, out, tmp, t0, proc in jobs:
        log = proc.communicate()[0]
        seconds[out] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    built = []
    for out in outs:
        if str(out) not in _loaded:
            log_path = out.with_suffix(".log")
            log = log_path.read_text() if log_path.exists() else ""
            _loaded[str(out)] = Built(ctypes.CDLL(str(out)), out,
                                      seconds.get(out, 0.0), log)
        built.append(_loaded[str(out)])
    return built


def load(name: str) -> Built:
    """Compile (once per source hash) and load kernel library `name`."""
    return build([source_path(name)])[0]
