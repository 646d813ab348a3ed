"""Build the port's CUDA kernels and load them through ``ctypes``.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  The libraries land in ``_build/<hash>/`` beside the
package, keyed on a hash of every source and the flags, and are built at
first use: one ``nvcc`` process per source, all started together.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # source -> nvcc output of the last build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every ``.cu`` under ``csrc/`` that is not built yet;
    returns ``{kernel name: library path}``.  Raises with the compiler's
    output when a build fails."""
    out_dir = BUILD / _digest()
    targets = {src.stem: out_dir / f"lib{src.stem}.so"
               for src in sorted(CSRC.glob("*.cu"))}
    todo = [name for name, lib in targets.items() if not lib.exists()]
    if not todo:
        return targets
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (``csrc/<name>.cu``)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _libs[name] = lib
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def current_stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
