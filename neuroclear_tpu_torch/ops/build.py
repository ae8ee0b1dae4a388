"""Build the CUDA kernels of ``ops/csrc`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``: ``wgmma`` exists only there) into
``neuroclear_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the sources, the shared headers (``csrc/*.cuh``) and the
flags, so a changed source rebuilds and an unchanged one is loaded as it is.
The kernels' TMA tensor maps are encoded with the CUDA driver API's
``cuTensorMapEncodeTiled``, fetched through the runtime's
``cudaGetDriverEntryPoint``, so nothing links ``libcuda``.  No PyTorch or
CUTLASS header is compiled, so ``ninja`` is not needed and a build takes
seconds.  Every pointer and the stream cross the boundary as ``c_void_p``;
each entry point returns a ``cudaError_t`` that the wrappers turn into an
exception.

Nothing here runs at import: the first wrapper call on a CUDA tensor builds
and loads its library, and ``build_all`` builds every library at once, one
``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

c_ptr, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C signature of every entry point: (argtypes, restype)
SIGNATURES = {
    "conv3x3": {
        "nc_conv3x3_bf16": ([c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_int,
                             c_int, c_int, c_int, c_int, c_int, c_ptr], c_int),
    },
    "wconv_dw": {
        "nc_wconv_dw_bf16": ([c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_int,
                              c_int, c_int, c_int, c_int, c_int, c_int, c_ptr], c_int),
    },
    "inorm": {
        "nc_pair_sums": ([c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ll, c_ll, c_int, c_int,
                          c_int, c_ll, c_int, c_int, c_ptr], c_int),
        "nc_affine_map_act": ([c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ll, c_ll, c_int,
                               c_int, c_int, c_ptr], c_int),
        "nc_bwd_map": ([c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ll, c_ll, c_int,
                        c_int, c_int, c_ptr], c_int),
    },
}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found under {cuda_home}/bin or on PATH; "
                           "the CUDA kernels are built on the machine with the card")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (popen, tmp_path, final_path), or
    None when the library is already built."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    try:
        stdout, stderr = proc.communicate(timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc for {name}.cu ran past {BUILD_TIMEOUT_S} s")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                           f"{stdout}{stderr}")
    out.with_suffix(".log").write_text(stdout + stderr)  # -Xptxas -v report
    os.replace(tmp, out)


def build_all(names=None) -> dict[str, float]:
    """Build every library not built yet, one nvcc per source in parallel.
    Returns the seconds each build took (0.0 for one already built)."""
    names = list(names or sources())
    with _LOCK:
        t0 = time.monotonic()
        jobs = {n: _start(n) for n in names}
        secs = {}
        errors = []
        for n, job in jobs.items():
            if job is None:
                secs[n] = 0.0
                continue
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
            secs[n] = time.monotonic() - t0
        if errors:
            raise RuntimeError("\n".join(errors))
        return secs


def ptxas_report(name: str) -> str:
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass_wgmma_count(name: str) -> int:
    """The number of ``HGMMA`` (wgmma) instructions in the built library's
    SASS, by ``cuobjdump -sass`` beside ``nvcc``."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(_library_path(name))], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    return sum("HGMMA" in ln for ln in out.splitlines())


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = bind(ctypes.CDLL(str(_library_path(name))), name)
        return _LIBS[name]


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set the C signatures of library ``name``'s entry points on ``lib``."""
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes, f.restype = argtypes, restype
    lib.nc_error_string.argtypes, lib.nc_error_string.restype = [c_int], ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.nc_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
