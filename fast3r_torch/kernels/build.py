"""Build and load the port's CUDA C++ kernels (``fast3r_torch/csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started together,
and one more ``nvcc`` call links the objects into one shared library with a
plain C interface, loaded through ``ctypes`` (no PyTorch headers, so the
build takes seconds).  The library lands in ``fast3r_torch/_build/`` (listed
in ``.gitignore``) under a name that carries a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads at once.
``ptxas`` reports each kernel's registers, shared memory and spills into a
``.log`` file beside the library.

Each C entry point returns ``cudaGetLastError()`` after its launches; the
wrappers call :func:`check` on it, which raises on anything but 0.  A build
failure raises too: there is no fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signature of every entry point (see the extern "C" blocks in csrc/)
SIGNATURES = {
    "fast3r_attention_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I,
                             _L, _L, _L, _L, _L, _L, _L, _L, _L, _F,
                             _P, _I, _P],
    "fast3r_attention_bwd": [_P] * 9 + [_I] * 5 + [_L] * 21 + [_F, _P],
    "fast3r_trunk_head_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _P],
    "fast3r_fused_gemm": [_I, _I] + [_P] * 13 + [_I, _I, _I, _F, _P],
    "fast3r_ln_mlp": [_P] * 12 + [_I, _I, _I, _I, _F, _P],
    "fast3r_gemm_smem_bytes": [],
    "fast3r_attention_bwd_smem_bytes": [],
    "fast3r_resize_bilinear": [_P] * 8 + [_L, _I, _I, _I, _I, _P],
    "fast3r_ring_attention_plan": [_I, _I, _P, _P],
    "fast3r_ring_attention_fwd": [_I, _P, _P, _P] + [_L] * 12 + [_P] * 6
                                 + [_I] * 6 + [_F, _L, _P],
    "fast3r_ring_attention_bwd_plan": [_I, _I, _I, _P, _P, _P],
    "fast3r_ring_attention_bwd_dq": [_I] + [_P] * 4 + [_L] * 16 + [_P] * 7
                                    + [_I] * 5 + [_F, _L, _P],
    "fast3r_ring_attention_bwd_dkv": [_I] + [_P] * 4 + [_L] * 16 + [_P, _L]
                                     + [_P] * 7 + [_I] * 5 + [_F, _L, _P],
}


def find_nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(CSRC_DIR.glob("*.cu*")):  # the sources and their headers
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libfast3r_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    return res.stdout + res.stderr


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is already there."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / (s.stem + ".o") for s in _sources()]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                             for s, o in zip(_sources(), objs))]
        logs, failed = [], []
        for cmd, p in procs:
            text = p.communicate()[0]
            logs.append(f"$ {' '.join(cmd)}\n{text}")
            if p.returncode != 0:
                failed.append(f"nvcc failed ({p.returncode}):\n{logs[-1]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = Path(tmpdir) / out.name
        logs.append(_run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                          *map(str, objs)]))
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp, out)  # atomic: another process never loads half a file
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fast3r_error_string.argtypes = [ctypes.c_int]
    lib.fast3r_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().fast3r_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
