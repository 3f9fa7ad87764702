"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/kernels/<name>-<hash>.so`` under the repository root
(listed in ``.gitignore``), then loaded with ``ctypes``. The hash covers the
source and the flags, so an edited kernel rebuilds and an unchanged one is
reused. Nothing is built at import time: the first ``load`` of a kernel in a
process builds it if needed; ``build_all`` builds several at once, one
``nvcc`` process per source, all started together.
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
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {candidate} and on PATH)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> Tuple[subprocess.Popen, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), tmp


def _finish(name: str, proc: subprocess.Popen, tmp: str) -> Path:
    try:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu ({proc.returncode}):\n{output}")
        out = library_path(name)
        os.replace(tmp, out)
        return out
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_all(names: Iterable[str]) -> Dict[str, Tuple[Path, float]]:
    """Compile every ``csrc/<name>.cu`` not yet built, all ``nvcc`` processes
    running at once. Returns {name: (library, seconds until it was ready)}."""
    t0 = time.perf_counter()
    done, running = {}, {}
    try:
        for name in names:
            if library_path(name).is_file():
                done[name] = (library_path(name), 0.0)
            else:
                running[name] = _start(name)
        for name, (proc, tmp) in running.items():
            done[name] = (_finish(name, proc, tmp), time.perf_counter() - t0)
    finally:
        for name, (proc, tmp) in running.items():   # after a failure: stop the rest
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return done


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    return build_all([name])[name][0]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name)))
