"""Build the port's CUDA kernels and load them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` into an object file, and the objects are
linked into ONE shared library named by a hash of the sources and flags,
under ``llm_np_cp_tpu_torch/_build/`` (listed in ``.gitignore``).  Each
source exposes plain ``extern "C"`` launchers that return
``cudaGetLastError()``; no PyTorch header is included, so a build takes
seconds.

The build runs at first use (``library()``), never at import: the
package imports on machines that have no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(cuda_home) / "bin" / "nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of the flags and every source and header under csrc/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise with nvcc's stderr on failure.
    Returns each command's stderr (ptxas register/shared-memory report)."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        logs.append(out + err)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def build() -> Path:
    """Compile the sources into the hashed library unless it exists;
    returns its path.  Records timing and ptxas output in ``BUILD_INFO``."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    lib_path = BUILD_DIR / f"libllm_np_cp_kernels_{_digest()}.so"
    if lib_path.exists():
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        logs = _run_all([
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s), "-o", str(o)]
            for s, o in zip(sources, objs)
        ])
        tmp_lib = Path(tmp) / lib_path.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)]])
        os.replace(tmp_lib, lib_path)  # atomic: a reader never sees half a file
    BUILD_INFO.update(
        path=str(lib_path), seconds=time.perf_counter() - t0, cached=False,
        ptxas="\n".join(logs),
    )
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _LIB = lib
        return _LIB


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# launcher name → argtypes (every pointer and the stream are c_void_p)
SIGNATURES: dict[str, tuple] = {
    # q, k, v, out, B, S, H, K, D, scale, softcap (0 = off), window (0 = off),
    # dtype code, stream
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P),
    # q, k, v, k_scale, v_scale, mask, out, B, S, H, K, D, scale, softcap,
    # dtype code, int8 cache flag, stream
    "decode_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P),
    # x, gamma, w, part_val, part_idx, out, N, H, V, tied, eps, unit_offset,
    # softcap, dtype code, stream
    "sample_epilogue_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _I, _P),
    "sample_epilogue_num_tiles": (_I,),
}


def _declare(lib: ctypes.CDLL) -> None:
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.llm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.llm_cuda_error_string.restype = ctypes.c_char_p


def check(err: int, kernel: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if err != 0:
        msg = library().llm_cuda_error_string(err)
        raise RuntimeError(
            f"{kernel} launch failed: CUDA error {err} "
            f"({msg.decode() if msg else 'unknown'})"
        )
