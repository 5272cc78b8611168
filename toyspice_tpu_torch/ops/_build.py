"""Build ``csrc/run_kernel.cu`` with ``nvcc`` at first use and bind it with
``ctypes``.

One ``nvcc`` call compiles the source to a shared library with a plain C
entry point (no PyTorch headers, so the build takes seconds).  The library
goes to ``toyspice_tpu_torch/_build/``, named by a hash of the source and
the flags, so an edited source builds anew and an unchanged one loads.  A
missing ``nvcc`` or a failed build raises: there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG / "csrc" / "run_kernel.cu"
BUILD_DIR = PKG / "_build"
# -fmad=false: every product and sum rounds on its own, as in the torch
# plain version (ops/run.py), so the two agree to the last bit
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the whole-run kernel is built from "
                       f"{SOURCE} with the CUDA toolkit")


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"librun_kernel-{h.hexdigest()[:16]}.so"


def build():
    """Compile the kernel if its library is missing; returns its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The bound library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.tsr_run.argtypes = [i, p, i, p, p, p, p, p, p, p, p, i,
                                d, d, d, d, i, p]
        lib.tsr_run.restype = i
        lib.tsr_error_string.argtypes = [i]
        lib.tsr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def error_string(err):
    return load().tsr_error_string(int(err)).decode()
