"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` -- no PyTorch headers, so a
build takes seconds.  Libraries go into ``build/repro_torch_kernels/`` at
the root of the checkout (or ``$REPRO_TORCH_BUILD_DIR``), named by a hash
of the source and the flags, so an edited source is rebuilt at first use
and an unchanged one is loaded as it is.  ``build_all`` starts one ``nvcc``
per source, all at once.  A build or load failure raises.
"""
from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("dcsim_step", "telemetry_bin", "flash_attention", "ssm_scan",
           "flash_attention_bwd", "ssm_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the most replicas one launch of an engine kernel takes: both put the
# replica on the grid's y axis, whose extent CUDA caps at 65,535
MAX_REPLICAS = 65535

# loaded libraries of this process, by source name
_LOADED: dict = {}

# (cache, key) -> how often that per-key cache missed in this process: a
# library loaded ("build.load", by its path), a kernel's scratch words made
# ("dcsim_step.scratch", "telemetry_bin.scratch"); each key should miss
# once (analysis/recompile.py reads it)
MISSES: collections.Counter = collections.Counter()


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    pkg = pathlib.Path(__file__).resolve().parents[2]
    root = pkg.parent if pkg.name == "src" else pkg
    return root / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or NVCC): the CUDA kernels of "
        "repro_torch are built from source at first use")


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, in parallel.
    Returns {name: (path, seconds, ptxas report)}, the seconds from that
    ``nvcc``'s start to its exit; sources already built report 0 seconds
    and an empty report."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs, result = {}, {}
    nvcc = None
    for name in names:
        lib = library_path(name)
        if lib.exists():
            result[name] = (lib, 0.0, "")
            continue
        nvcc = nvcc or nvcc_path()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib, tmp, time.perf_counter())
    # one waiting thread per nvcc, so each is timed to its own exit
    with concurrent.futures.ThreadPoolExecutor(max(len(jobs), 1)) as pool:
        waits = {name: pool.submit(_wait, proc, t0)
                 for name, (proc, _, _, t0) in jobs.items()}
    failures = []
    for name, (proc, lib, tmp, _) in jobs.items():
        report, secs = waits[name].result()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{report}")
            continue
        os.replace(tmp, lib)
        result[name] = (lib, secs, report)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return result


def _wait(proc, t0):
    report, _ = proc.communicate()
    return report, time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, built first if needed: once
    a process (counted in ``MISSES``)."""
    lib = _LOADED.get(name)
    if lib is None:
        MISSES["build.load", str(library_path(name))] += 1
        path, _, _ = build_all((name,))[name]
        lib = ctypes.CDLL(str(path))
        _declare(name, lib)
        _LOADED[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "dcsim_step":
        fn = lib.dcsim_advance_launch
        fn.argtypes = [P] * 11 + [F, F, F, I, I, I, I, I] + [P] * 7 + [P]
        fn.restype = I
        fn = lib.dcsim_advance_launch_f64
        fn.argtypes = [P] * 11 + [F, F, F, I, I, I, I] + [P] * 7 + [P]
    elif name == "telemetry_bin":
        fn = lib.telemetry_bin_launch
        fn.argtypes = [P, P, I, P, P, I, F, F, F, I, P, P, P, I, I, P, P] \
            + [P] * 5 + [I, I, I, P]
    elif name == "flash_attention":
        fn = lib.flash_attention_launch
        fn.argtypes = [P] * 4 + [I] * 7 + [P, I, I, F, F, P]
    elif name == "ssm_scan":
        fn = lib.ssm_scan_launch
        fn.argtypes = [P] * 7 + [I] * 5 + [P]
    elif name == "flash_attention_bwd":
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = [P] * 10 + [I] * 7 + [P, I, I, F, F, P]
    elif name == "ssm_scan_bwd":
        fn = lib.ssm_scan_bwd_launch
        fn.argtypes = [P] * 13 + [I] * 5 + [P]
    else:
        raise ValueError(f"unknown kernel source {name!r}")
    fn.restype = I
