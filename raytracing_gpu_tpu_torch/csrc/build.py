"""Build the port's CUDA kernels with nvcc into a ctypes-loadable library.

`library_path()` compiles `csrc/*.cu` for Hopper (sm_90a) into
`raytracing_gpu_tpu_torch/_build/<hash>/libintersect.so`, keyed by a hash of
the sources and the flags, and returns the path; a later call with unchanged
sources reuses it. The build runs at first use, never at import: one
`nvcc -c` per source, all started together, then one link. The library has
a plain C interface (no PyTorch headers), so a build takes seconds. One
library, so one copy of nvcc's static CUDA runtime serves all its entry
points.

Flags: -fmad=false and no --use_fast_math keep every multiply and add
separately rounded and division and sqrt IEEE, which the kernels' bit-exact
agreement with their PyTorch twins depends on.

Run `python -m raytracing_gpu_tpu_torch.csrc.build` to build and print the
path and the compiler's register and shared-memory report; `--compare`
times one nvcc over all the sources against this build, each into a fresh
directory, in turns.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_ROOT = CSRC.parent / "_build"
SOURCES = ("intersect.cu", "frame_loop.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)
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
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def _side_by_side(cmds) -> tuple[str, int]:
    """Run the commands all at once; (their log, the first failing exit code
    or 0)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    log, rc = "", 0
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log += f"$ {' '.join(cmd)}\n{out}[exit {proc.returncode}]\n"
        rc = rc or proc.returncode
    return log, rc


def library_path(root: Path = BUILD_ROOT, verbose: bool = False) -> Path:
    """Path of the built library, compiling it first if needed."""
    out_dir = root / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # build in a directory of its own and rename the library, so a concurrent
    # or interrupted build never leaves a partial library under the final name
    work = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir))
    objs = [str(work / f"{Path(s).stem}.o") for s in SOURCES]
    t0 = time.perf_counter()
    log, rc = _side_by_side([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                             for s, o in zip(SOURCES, objs)])
    if rc == 0:
        link_log, rc = _side_by_side([[nvcc, *LINK_FLAGS, "-o", str(work / LIB_NAME),
                                       *objs]])
        log += link_log
    log += f"[{time.perf_counter() - t0:.1f} s: the sources side by side, then the link]\n"
    (out_dir / "build.log").write_text(log)
    if rc == 0:
        os.replace(work / LIB_NAME, lib)
    shutil.rmtree(work, ignore_errors=True)
    if rc != 0:
        raise RuntimeError(f"nvcc failed building {SOURCES}:\n{log}")
    if verbose:
        print(log)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The library, built first if needed and loaded once per process."""
    return ctypes.CDLL(str(library_path()))


def compare() -> None:
    """Print the seconds of one nvcc over all the sources and of this build
    (one nvcc per source, side by side, then the link), in turns (one, side
    by side, side by side, one), each into a fresh directory."""
    nvcc = find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        for i, way in enumerate(("one", "side", "side", "one")):
            t0 = time.perf_counter()
            if way == "one":
                subprocess.run([nvcc, *NVCC_FLAGS, *LINK_FLAGS, "-o", f"{tmp}/one{i}.so",
                                *(str(CSRC / s) for s in SOURCES)],
                               check=True, capture_output=True)
            else:
                library_path(Path(tmp) / f"side{i}")
            what = ("one nvcc over the sources" if way == "one"
                    else "one nvcc per source, side by side, then the link")
            print(f"{what}: {time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    import sys

    if "--compare" in sys.argv:
        compare()
    else:
        path = library_path()
        print(path)
        print((path.parent / "build.log").read_text())
