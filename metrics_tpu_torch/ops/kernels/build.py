"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles, with ``nvcc``
alone, into its own shared library that :mod:`ctypes` loads; no source includes
PyTorch's headers, so a build takes seconds. The libraries go to
``build/kernels/`` at the repository root (listed in ``.gitignore``) under a
name that carries a hash of the source and of the shared headers
(``csrc/*.cuh``), so an edited source builds anew and an unchanged one is
reused. The first call to :func:`library` builds every kernel
at once, one ``nvcc`` process per source, all started together.

The host library of the text metrics (``metrics_tpu_torch/native/*.cpp``,
the edit distance) is built apart, by :func:`build_host_library` with the
host's C++ compiler, so that the CPU tests build and load the same native
code the card machine does; it goes to the same directory under the same
naming rule.

Nothing here runs at import: the CPU tests import every module of the package,
and the machine they run on has no ``nvcc``.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("fold", "hist", "binned", "segment", "toeplitz", "match")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# argument types of each library's C entry points (see the csrc sources)
_SIGNATURES = {
    "fold": {"fold_rows": (_P,) * 5 + (_I,) * 4 + (_P,)},
    "hist": {"histogram": (_P, _I, _L, _L, _P, _I, _L, _L, _P, _I, _L, _L, _L, _L, _L, _L, _I, _P, _P)},
    "binned": {
        "binned_counts": (_P, _P, _P, _L, _I, _I, _P, _P, _P, _P, _P),
        "binned_scratch_ints": (_L, _I, _I),
    },
    "segment": {"segment_fold": (_P,) * 11 + (_I,) * 5 + (_P,), "segment_scratch_ints": (_I, _I, _I)},
    "toeplitz": {"toeplitz_solve": (_P, _P, _P, _P, _L, _I, _P), "toeplitz_shared_length": ()},
    "match": {"greedy_match": (_P,) * 9 + (_L, _L, _I, _I, _I, _I, _P), "match_scratch_words": (_L, _I, _I, _I)},
}
# return types other than int (a CUDA error code)
_RESTYPES = {"segment_scratch_ints": _L, "binned_scratch_ints": _L, "match_scratch_words": _L}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: wall seconds the last :func:`build_all` that compiled anything spent
#: compiling (0.0 until one has)
last_build_seconds = 0.0
HOST_CXX_FLAGS = ("-O3", "-shared", "-fPIC")
#: wall seconds the last :func:`build_host_library` that compiled spent
#: compiling (0.0 until one has)
last_host_build_seconds = 0.0


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``,
    else the toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin on PATH")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel; return the
    library path of each. Raises with the compiler's output if one fails."""
    global last_build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    todo = {name: path for name, path in targets.items() if not path.is_file()}
    start = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, targets[name])  # atomic: a concurrent build never sees half a file
    if todo:
        last_build_seconds = time.perf_counter() - start
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (one of :data:`SOURCES`), building all
    kernels on first use."""
    with _lock:
        if not _libs:
            for lib_name, path in build_all().items():
                lib = ctypes.CDLL(str(path))
                for fn_name, argtypes in _SIGNATURES[lib_name].items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = _RESTYPES.get(fn_name, ctypes.c_int)
                _libs[lib_name] = lib
        return _libs[name]


def host_library_path(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Where :func:`build_host_library` puts the library of ``source``: a
    name that carries a hash of the source and of the flags."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(HOST_CXX_FLAGS).encode())
    return build_dir / f"lib{source.stem}-{digest.hexdigest()[:12]}.so"


def build_host_library(source: Path, build_dir: Path = BUILD_DIR, cxx: str = "g++") -> Path:
    """Compile the C++ file ``source`` with the host compiler ``cxx`` into a
    shared library in ``build_dir``, unless the library of this source is
    there already; return its path. Raises ``RuntimeError`` with the
    compiler's output if the build fails: nothing falls back."""
    global last_host_build_seconds
    path = host_library_path(source, build_dir)
    if path.is_file():
        return path
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *HOST_CXX_FLAGS, str(source), "-o", str(tmp)]
    start = time.perf_counter()
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    except OSError as e:
        raise RuntimeError(f"host library build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host library build failed: {' '.join(cmd)}\n{proc.stdout.decode(errors='replace')}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    last_host_build_seconds = time.perf_counter() - start
    return path


def check(err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({_error_name(err)})")


def _error_name(err: int) -> Optional[str]:
    try:
        rt = ctypes.CDLL("libcudart.so")
    except OSError:
        return None
    rt.cudaGetErrorString.restype = ctypes.c_char_p
    rt.cudaGetErrorString.argtypes = (ctypes.c_int,)
    return rt.cudaGetErrorString(err).decode()
