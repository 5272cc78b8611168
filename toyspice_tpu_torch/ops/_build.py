"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them
with ``ctypes``.

Each kernel library compiles from one source (``csrc/run_kernel.cu``,
``csrc/run_kernel_phys.cu`` and ``csrc/run_kernel_mag.cu``, the compat,
physics and magnetic instantiations of ``csrc/run_kernel.cuh``, each
built twice: without and, with ``-DTSR_STORE``, with the waveform store,
and each of those again with ``-DTSR_WIDE``, the 64-row and block buckets
alone, as a library of its own;
``csrc/op_kernel.cu``, ``csrc/dc_sweep_kernel.cu``,
``csrc/stamped_solve.cu``, all on ``csrc/newton.cuh``;
``csrc/ac_kernel.cu``, the stamped solve's systems of 33 to 64 and every
warp segment of ``csrc/newton.cuh`` and ``csrc/run_kernel.cuh``, on
``csrc/gj_warp.cuh``; ``csrc/gj_kernel.cu``, and the stamped solve's
and the AC kernel's systems past 64, on ``csrc/gj_block.cuh``) with one
``nvcc`` call to a shared library with a plain C entry point (no PyTorch
headers, so a build takes seconds); the calls for every missing library
start together.  A
library goes to ``toyspice_tpu_torch/_build/``, named by a hash of its
source, the shared header and the flags, so an edited source builds anew
and an unchanged one loads.  A missing ``nvcc`` or a failed build raises:
there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
SOURCES = {"run": CSRC / "run_kernel.cu",
           "run_store": CSRC / "run_kernel.cu",
           "run_phys": CSRC / "run_kernel_phys.cu",
           "run_phys_store": CSRC / "run_kernel_phys.cu",
           "run_mag": CSRC / "run_kernel_mag.cu",
           "run_mag_store": CSRC / "run_kernel_mag.cu",
           "op": CSRC / "op_kernel.cu", "stamped": CSRC / "stamped_solve.cu",
           "dc": CSRC / "dc_sweep_kernel.cu", "ac": CSRC / "ac_kernel.cu",
           "gj": CSRC / "gj_kernel.cu"}
# the run kernel's store builds and its 64-row and block buckets
# (ops/run.py run_bucket): their instantiations compile in calls of their
# own, beside the others
RUN_LIBS = ("run", "run_store", "run_phys", "run_phys_store", "run_mag",
            "run_mag_store")
SOURCES.update({name + "_wide": SOURCES[name] for name in RUN_LIBS})
DEFINES = {name + wide: (("-DTSR_STORE",) if name.endswith("_store")
                         else ()) + (("-DTSR_WIDE",) if wide else ())
           for name in RUN_LIBS for wide in ("", "_wide")}
HEADERS = (CSRC / "newton.cuh", CSRC / "run_kernel.cuh",
           CSRC / "gj_block.cuh", CSRC / "gj_warp.cuh")
BUILD_DIR = PKG / "_build"
# -fmad=false: every product and sum rounds on its own, as in the torch
# plain versions (ops/run.py, ops/op.py, ops/solve_stamped.py, ops/dc.py,
# ops/ac.py, ops/solve.py), so the two agree to the last bit
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_libs = {}
# ``load`` builds and binds under one lock: the mesh's per-device threads
# (parallel/mesh.py) may ask for a library at once, and two builds of it
# would write one temporary file
_load_lock = threading.Lock()
# the wrappers' launch counts, read-modify-write from those threads
_count_lock = threading.Lock()


def count(wrapper):
    """Add one to ``wrapper.launches`` (a wrapper calls it where it has
    launched its kernel)."""
    with _count_lock:
        wrapper.launches += 1


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the kernels are built from "
                       f"{CSRC} with the CUDA toolkit")


def library_path(name="run"):
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes()
                       + b"".join(p.read_bytes() for p in HEADERS)
                       + " ".join(FLAGS + flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def flags(name):
    """The nvcc flags of one library beyond ``FLAGS``."""
    return list(DEFINES.get(name, ()))


def build(names=tuple(SOURCES), extra_flags=()):
    """Compile the named kernels whose libraries are missing, one ``nvcc``
    process each, all at once; returns {name: library path} and, in
    ``build.log``, each compile's output (``extra_flags`` such as
    ``-Xptxas -v`` show there), in ``build.seconds`` each compile's
    seconds from the start of all of them to its end."""
    out = {name: library_path(name) for name in names}
    todo = [name for name in names if not out[name].exists()]
    build.log, build.seconds = {}, {}
    if not todo:
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = out[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, *flags(name), *extra_flags, "-o", str(tmp),
               str(SOURCES[name])]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))

    def drain(name):  # each compile's output read as it comes
        build.log[name] = procs[name][2].communicate()[0]
        build.seconds[name] = time.perf_counter() - t0

    readers = [threading.Thread(target=drain, args=(name,))
               for name in procs]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{build.log[name]}")
        else:
            os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


build.log = {}
build.seconds = {}

RUN_SIG = "iiiiipii" + "p" * 10 + "iddddiddi" + "pqp"
RUN_STORE_SIG = "iiiiipii" + "p" * 10 + "iddddiddi" + "dii" + "p" * 4 + "pqp"
_ARGTYPES = {
    # tsr_run(np1, nonlinear, mag, physics, trap, topo, topo_len,
    #         nl_doubles, dev, rc, state, jv, t, dt, acc, att, fail, nri,
    #         nlanes, tstop, minstep, tmax, trtol, max_attempts, reltol,
    #         abstol, max_iter, work, work_len, stream)
    # tsr_run_store(the same up to max_iter, tstart, max_store, stream_flag,
    #               out_x, out_t, out_n, overflow, work, work_len, stream)
    # tsr_run_phys, tsr_run_mag and their _store entries: the same
    # tsr_run_seg_shape(np1, nlanes, topo_len, nl_doubles, out[6])
    # tsr_run_bucket(np1, topo_len, nl_doubles)
    # the _wide libraries: their base's entries, the 64-row and block
    # buckets alone
    "run": (("tsr_run", RUN_SIG), ("tsr_run_seg_shape", "iiiip"),
            ("tsr_run_bucket", "iii")),
    "run_store": (("tsr_run_store", RUN_STORE_SIG),),
    "run_phys": (("tsr_run_phys", RUN_SIG),),
    "run_phys_store": (("tsr_run_phys_store", RUN_STORE_SIG),),
    "run_mag": (("tsr_run_mag", RUN_SIG),),
    "run_mag_store": (("tsr_run_mag_store", RUN_STORE_SIG),),
    "run_wide": (("tsr_run", RUN_SIG),),
    "run_store_wide": (("tsr_run_store", RUN_STORE_SIG),),
    "run_phys_wide": (("tsr_run_phys", RUN_SIG),),
    "run_phys_store_wide": (("tsr_run_phys_store", RUN_STORE_SIG),),
    "run_mag_wide": (("tsr_run_mag", RUN_SIG),),
    "run_mag_store_wide": (("tsr_run_mag_store", RUN_STORE_SIG),),
    # tsr_op(np1, topo, topo_len, lane_doubles, dev, dyn, x0, jv0, x, jv,
    #        iters, conv, nlanes, reltol, abstol, max_iter, gmin_floor,
    #        physics, work, work_len, stream)
    # tsr_opdc_seg_shape(np1, nlanes, topo_len, lane_doubles, out[6])
    "op": (("tsr_op", "ipii" + "p" * 8 + "iddidi" + "pqp"),
           ("tsr_opdc_seg_shape", "iiiip")),
    # tsr_stamped(n, tab, tab_len, view, view_len, nnz, nrhs, vals, rvals,
    #             gmin, x, nlanes, work, work_len, stream)
    "stamped": (("tsr_stamped", "ipipiii" + "p" * 4 + "ipqp"),),
    # tsr_dc_sweep(np1, topo, topo_len, lane_doubles, dev, dyn, vs,
    #              vs_stride, npts, x, iters, conv, nlanes, reltol, abstol,
    #              max_iter, gmin_floor, physics, work, work_len, stream)
    "dc": (("tsr_dc_sweep", "ipii" + "p" * 3 + "qi" + "p" * 3
            + "iddidi" + "pqp"),),
    # tsr_ac(np1, nb, nf, g, bh, r, omega, x, work, work_len, stream)
    "ac": (("tsr_ac", "iii" + "p" * 5 + "pqp"),),
    # tsr_gj(n, a, b, x, nsys, work, work_len, stream)
    "gj": (("tsr_gj", "ipppqpqp"),),
}


def load(name="run"):
    """The bound library of one kernel (built at first use)."""
    with _load_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build((name,))[name]))
            kinds = {"i": ctypes.c_int, "q": ctypes.c_longlong,
                     "p": ctypes.c_void_p, "d": ctypes.c_double}
            for fn_name, sig in _ARGTYPES[name]:
                fn = getattr(lib, fn_name)
                fn.argtypes = [kinds[c] for c in sig]
                fn.restype = ctypes.c_int
            lib.tsr_error_string.argtypes = [ctypes.c_int]
            lib.tsr_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def error_string(err, name="run"):
    return load(name).tsr_error_string(int(err)).decode()
