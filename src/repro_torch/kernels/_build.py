"""Build the Hopper kernels with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

into ``build/kernels/`` at the repository root (listed in .gitignore). The
file name carries a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. ``build()`` starts one
nvcc per missing library, all at once, and waits for them together.
Nothing here runs at import time: the module imports on machines without
nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("bucket_probe", "l2_topk", "gbdt_predict")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (on PATH or under "
                           "/usr/local/cuda/bin)")
    return path


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers / shared memory / spills) of the
    last build of ``name``, or "" if it was loaded from an earlier build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Optional[Iterable[str]] = None) -> Dict[str, pathlib.Path]:
    """Compile every missing library among ``names`` (default: all), one
    nvcc process each, in parallel. Raises with nvcc's output on failure."""
    names = tuple(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    try:
        for n, path in paths.items():
            if path.exists():
                continue
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            paths[n].with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {n}.cu "
                              f"(exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    return _LIBS[name]
