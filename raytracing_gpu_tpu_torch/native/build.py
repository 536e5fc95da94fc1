"""Build the native host library (the `.svati` parser and the image writers)
with g++.

`library_path()` compiles `svati_parser.cpp` and `image_io.cpp` into
`raytracing_gpu_tpu_torch/_build/native-<hash>/librgt_native.so`, keyed by a
hash of the sources and the flags, and returns the path; a later call with
unchanged sources reuses it. The build runs at first use, never at import,
under a temporary name that is renamed into place, so several processes may
build at once. The compiler's output goes to `build.log` beside the library.
Set RGT_NATIVE=0 to turn the native paths off.

Run `python -m raytracing_gpu_tpu_torch.native.build` to build and print the
path.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_ROOT = HERE.parent / "_build"
SOURCES = ("svati_parser.cpp", "image_io.cpp")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lz",)
LIB_NAME = "librgt_native.so"


def enabled() -> bool:
    """False when RGT_NATIVE=0 turns the native paths off."""
    return os.environ.get("RGT_NATIVE", "1") != "0"


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Path of the built library, compiling it first if needed; raises
    RuntimeError when g++ is missing or fails."""
    out_dir = BUILD_ROOT / f"native-{source_hash()}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="lib", suffix=".so.tmp", dir=out_dir)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, *(str(HERE / s) for s in SOURCES), *LIBS]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed: {e}") from e
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"[{time.perf_counter() - t0:.1f} s, exit {proc.returncode}]\n")
    # each builder writes its own log and renames it, as the library
    fd, tmp_log = tempfile.mkstemp(prefix="build", suffix=".log.tmp", dir=out_dir)
    with os.fdopen(fd, "w") as f:
        f.write(log)
    os.replace(tmp_log, out_dir / "build.log")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed building {SOURCES}:\n{log}")
    os.replace(tmp, lib)
    return lib


if __name__ == "__main__":
    path = library_path()
    print(path)
    print((path.parent / "build.log").read_text())
