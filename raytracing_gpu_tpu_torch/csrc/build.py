"""Build the port's CUDA kernels with nvcc into a ctypes-loadable library.

`library_path()` compiles `csrc/*.cu` for Hopper (sm_90a) into
`raytracing_gpu_tpu_torch/_build/<hash>/libintersect.so`, keyed by a hash of
the sources and the flags, and returns the path; a later call with unchanged
sources reuses it. The build runs at first use, never at import. The library
has a plain C interface (no PyTorch headers), so a build takes seconds.

Flags: -fmad=false and no --use_fast_math keep every multiply and add
separately rounded and division and sqrt IEEE, which the kernels' bit-exact
agreement with their PyTorch twins depends on.

Run `python -m raytracing_gpu_tpu_torch.csrc.build` to build and print the
path and the compiler's register and shared-memory report.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_ROOT = CSRC.parent / "_build"
SOURCES = ("intersect.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LIB_NAME = "libintersect.so"


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then PATH, then /usr/local/cuda; raises if
    there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(verbose: bool = False) -> Path:
    """Path of the built library, compiling it first if needed."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # build into a temporary name and rename, so a concurrent or interrupted
    # build never leaves a partial library under the final name
    fd, tmp = tempfile.mkstemp(prefix="lib", suffix=".so.tmp", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"[{time.perf_counter() - t0:.1f} s, exit {proc.returncode}]\n")
    (out_dir / "build.log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {SOURCES}:\n{log}")
    os.replace(tmp, lib)
    if verbose:
        print(log)
    return lib


if __name__ == "__main__":
    path = library_path()
    print(path)
    print((path.parent / "build.log").read_text())
