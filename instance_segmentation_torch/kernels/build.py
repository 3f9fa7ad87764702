"""Build and load the CUDA kernels and host helpers of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/kernels/<name>-<hash>.so`` under the repository root
(listed in ``.gitignore``), then loaded with ``ctypes``. A ``csrc/<name>.c``
is host code (no device code: ``png_unfilter.c``, ``warp_affine.c``),
compiled by the host C compiler (``$CC``, else ``cc``) the same way, on any
machine, without contracting a multiply and an add into one operation
(``-ffp-contract=off``: ``warp_affine.c`` rounds each as OpenCV does). The hash
covers the source and the flags, so an edited source rebuilds and an
unchanged one is reused. Nothing is built at import time: the first
``load`` of a library in a process builds it if needed; ``build_all``
builds several at once, one compiler process per source, all started
together. ``nvcc`` runs with
``-Xptxas -v``; its output (each kernel's registers, spills and shared
memory) is kept beside the library as ``<name>-<hash>.log`` and read by
``ptxas_usage``. ``launch`` calls an entry point on a device's current
stream.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_CC_FLAGS = ("-std=c11", "-O2", "-ffp-contract=off", "-shared", "-fPIC")
HOST_CC_LIBS = ("-lm",)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {candidate} and on PATH)")
    return found


def host_cc_path() -> str:
    cc = os.environ.get("CC") or "cc"
    found = shutil.which(cc)
    if found is None:
        raise RuntimeError(f"host C compiler {cc!r} not found (set CC)")
    return found


def source(name: str) -> Path:
    """``csrc/<name>.cu`` (a CUDA kernel), else ``csrc/<name>.c`` (host code)."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.is_file() else CSRC / f"{name}.c"


def _flags(src: Path) -> Tuple[str, ...]:
    return NVCC_FLAGS if src.suffix == ".cu" else HOST_CC_FLAGS


def library_path(name: str) -> Path:
    src = source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> Tuple[subprocess.Popen, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    src = source(name)
    cuda = src.suffix == ".cu"
    cmd = [nvcc_path() if cuda else host_cc_path(), *_flags(src), "-o", tmp, str(src),
           *(() if cuda else HOST_CC_LIBS)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), tmp


def _finish(name: str, proc: subprocess.Popen, tmp: str) -> Path:
    try:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{proc.args[0]} failed for {source(name).name} "
                               f"({proc.returncode}):\n{output}")
        out = library_path(name)
        out.with_suffix(".log").write_text(output)
        os.replace(tmp, out)
        return out
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_all(names: Iterable[str]) -> Dict[str, Tuple[Path, float]]:
    """Compile every source of ``csrc/`` named in ``names`` not yet built,
    all compiler processes running at once. Returns {name: (library, seconds until it was ready)}."""
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
    """Compile ``csrc/<name>.cu`` or ``.c`` unless its library is already built."""
    return build_all([name])[name][0]


def _kernel_name(mangled: str) -> str:
    """The last identifier of a mangled kernel name that ends in "_kernel"
    (each identifier is prefixed by its length), else the mangled name."""
    head = mangled[:mangled.rfind("_kernel") + len("_kernel")]
    for n in range(len("_kernel") + 1, min(len(head), 64)):
        if head[:-n].endswith(str(n)):
            return head[-n:]
    return mangled


def ptxas_usage(name: str) -> List[str]:
    """One line per kernel of ``csrc/<name>.cu`` as ``-Xptxas -v`` reported
    it when the library was built: "kernel: N registers, S bytes spill
    stores, L bytes spill loads, X bytes smem"."""
    log = library_path(name).with_suffix(".log")
    lines, kernel = [], None
    for line in log.read_text().splitlines() if log.is_file() else []:
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = _kernel_name(entry.group(1))
            spills = None
        elif kernel and "spill stores" in line:
            spills = re.findall(r"(\d+) bytes spill (stores|loads)", line)
        elif kernel and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            spill = ", ".join(f"{n} bytes spill {k}" for n, k in spills or [])
            lines.append(f"{kernel}: {regs} registers, {spill}, "
                         f"{smem.group(1) if smem else 0} bytes smem")
            kernel = None
    return lines


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)``: a C entry point called with the raw handle of
    ``device``'s current CUDA stream, with ``device`` made the current device
    first when it is not (an entry point launches on the current device).
    Returns the entry point's CUDA error code."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.c``, built on first use."""
    return ctypes.CDLL(str(build(name)))
