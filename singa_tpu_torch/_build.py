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

The host runtime (``csrc/core/``, a copy of the JAX package's C++ core)
builds with ``g++`` (`gxx_path`: $CXX or the one on PATH, whichever
links OpenMP) the same way: one compiler per source, all started
together, then one link into ``build/singa_tpu_torch/singa_core-<hash>.so``
(`build_core`), keyed on the sources, the flags, the compiler and the
host CPU that ``-march=native`` resolves to, since such a binary must
not run on another CPU.  `build_asan` builds the core's test binary
under AddressSanitizer and UndefinedBehaviorSanitizer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence

__all__ = ["Built", "build", "load", "source_path", "nvcc_path",
           "build_core", "build_asan", "asan_supported", "gxx_path"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_CORE = _CSRC / "core"
_BUILD_DIR = _PKG.parent / "build" / "singa_tpu_torch"
_DEFAULT_CUDA_HOME = "/usr/local/cuda"   # the CUDA toolkit's install default

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(_CSRC)]


# the JAX package's csrc/Makefile flags, so both libraries compute the
# same bits
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-fopenmp",
             "-Wall", "-Wextra"]
GXX_LDFLAGS = ["-shared", "-fopenmp", "-lpthread", "-ldl"]
ASAN_FLAGS = ["-O1", "-g", "-fno-omit-frame-pointer",
              "-fsanitize=address,undefined", "-std=c++17", "-fopenmp",
              "-Wall", "-Wextra"]
CORE_SOURCES = ("tensor_math_cpp.cc", "scheduler.cc", "dataloader.cc",
                "allocator.cc")
CORE_HEADER = "singa_core.h"
CORE_TEST = "test_core.cc"


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


# ---------------------------------------------------------------------------
# the host runtime (csrc/core), built with g++
# ---------------------------------------------------------------------------

#: the g++ chosen by `gxx_path`, once per process
_gxx: Optional[str] = None


def gxx_path() -> str:
    """The first of $CXX and the g++ on PATH that links an OpenMP
    program (a toolchain may set CXX to a g++ without libgomp)."""
    global _gxx
    if _gxx is None:
        cands = [c for c in (os.environ.get("CXX"), "g++") if c]
        found = [p for p in dict.fromkeys(map(shutil.which, cands)) if p]
        why = []
        for gxx in found:
            try:
                _probe(gxx, ["-fopenmp"],
                       "#include <omp.h>\nint main() { return "
                       "omp_get_max_threads() > 0 ? 0 : 1; }\n")
            except RuntimeError as e:
                why.append(str(e))
                continue
            _gxx = gxx
            break
        else:
            raise RuntimeError("no g++ that links -fopenmp: tried "
                               f"{cands} (found {found})\n" + "\n".join(why))
    return _gxx


def _probe(gxx: str, flags: Sequence[str], source: str) -> None:
    """Compile and link `source` with `flags`; raise when it fails."""
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "probe.cc"
        src.write_text(source)
        _run([gxx, *flags, str(src), "-o", str(Path(d) / "probe")],
             timeout=120.0)


_GXX_TIMEOUT_S = 300.0


def _run(cmd: List[str], timeout: float = _GXX_TIMEOUT_S) -> str:
    """Run a compiler command; raise with its log when it fails."""
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    return proc.stdout


def _host_key(gxx: str, flags: Sequence[str], files: Sequence[Path]) -> str:
    """Hash of the sources, the flags, the compiler's version and the
    target -march=native resolves to on this host."""
    h = hashlib.sha256()
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    for query in (["--version"], ["-march=native", "-Q", "--help=target"]):
        h.update(subprocess.run([gxx, *query], stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True,
                                timeout=_GXX_TIMEOUT_S,
                                check=True).stdout.encode())
    return h.hexdigest()[:16]


def _core_files() -> List[Path]:
    return [_CORE / CORE_HEADER] + [_CORE / s for s in CORE_SOURCES]


def _compile_link(out: Path, gxx: str, flags: Sequence[str],
                  sources: Sequence[Path], link: Sequence[str]) -> str:
    """One g++ per source, all started together, then one link into a
    temporary name renamed to `out`, so concurrent builds never load a
    partial file; returns the compilers' output, raises with it when a
    step fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f"{out.name}.", dir=out.parent))
    try:
        objs = [tmp / f"{src.stem}.o" for src in sources]
        jobs = [subprocess.Popen([gxx, *flags, "-c", str(src), "-o", str(o)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for src, o in zip(sources, objs)]
        logs, failed = [], []
        for src, proc in zip(sources, jobs):
            try:
                text = proc.communicate(timeout=_GXX_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                for p in jobs:
                    p.kill()
                    p.communicate()
                raise RuntimeError(f"g++ on {src.name} ran past "
                                   f"{_GXX_TIMEOUT_S} s")
            logs.append(text)
            if proc.returncode != 0:
                failed.append(f"g++ failed on {src.name} (exit "
                              f"{proc.returncode}):\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        linked = tmp / out.name
        logs.append(_run([gxx, *map(str, objs), *link, "-o", str(linked)]))
        os.replace(linked, out)
        return "".join(logs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_core() -> Built:
    """Compile (once per key, across processes) and load the host
    runtime; raises with the compiler's log when the build fails.
    ``_core.lib()`` is the per-process cache: call that instead."""
    gxx = gxx_path()
    out = _BUILD_DIR / ("singa_core-" + _host_key(
        gxx, GXX_FLAGS + GXX_LDFLAGS, _core_files()) + ".so")
    seconds, log = 0.0, ""
    if not out.exists():
        t0 = time.perf_counter()
        log = _compile_link(out, gxx, GXX_FLAGS,
                            [_CORE / s for s in CORE_SOURCES], GXX_LDFLAGS)
        seconds = time.perf_counter() - t0
    return Built(ctypes.CDLL(str(out)), out, seconds, log)


def asan_supported() -> bool:
    """Whether the g++ of `gxx_path` links a program under the
    sanitizers."""
    try:
        _probe(gxx_path(), ["-fsanitize=address,undefined"],
               "int main() { return 0; }\n")
    except RuntimeError:
        return False
    return True


def build_asan() -> Path:
    """The core's test binary (csrc/core/test_core.cc over every core
    source) under ASan and UBSan, built once per key; raises with the
    compiler's log when the build fails."""
    gxx = gxx_path()
    files = _core_files() + [_CORE / CORE_TEST]
    out = _BUILD_DIR / f"test_core_asan-{_host_key(gxx, ASAN_FLAGS, files)}"
    if not out.exists():
        _compile_link(out, gxx, ASAN_FLAGS, files[1:],
                      ["-fsanitize=address,undefined", "-fopenmp",
                       "-lpthread", "-ldl"])
    return out
