"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and is
compiled at first use into ``build/ddlb_tpu_torch/`` at the root of the
checkout (a directory ``.gitignore`` lists) with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

then loaded with ``ctypes``. The library's file name carries a hash of its
source and of every header beside it (``csrc/*.cuh``, such as
``hopper_gemm.cuh``, the Hopper GEMM tile of K2 and K6), so an edited
kernel or header is rebuilt and a stale library is never loaded.
``nvcc``'s output, including ``-Xptxas -v``'s registers, shared memory and
spills per kernel, is kept beside it as ``<name>-<hash>.log``. ``build``
starts one ``nvcc`` per source, all at once. A failed build raises; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ddlb_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
#: seconds one nvcc may take before the build is declared hung
BUILD_TIMEOUT_S = 600


def nvcc_path() -> str:
    """The CUDA compiler: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of ddlb_tpu_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the hash of its source
    and of every ``csrc/*.cuh`` (a header it may include)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, name: str, output: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(CSRC / f"{name}.cu")]


def build(*names: str) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, in parallel; returns ``{name: library path}``."""
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    failures = []
    try:
        for name, path in todo.items():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            # the child holds its own copy of the log's descriptor
            with open(path.with_suffix(".log"), "w") as log:
                proc = subprocess.Popen(
                    nvcc_command(nvcc, name, tmp),
                    stdout=log,
                    stderr=subprocess.STDOUT,
                )
            procs[name] = (proc, tmp)
        for name, (proc, tmp) in procs.items():
            try:
                rc = proc.wait(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                rc = f"timeout after {BUILD_TIMEOUT_S} s"
            if rc != 0:
                tmp.unlink(missing_ok=True)
                log = todo[name].with_suffix(".log").read_text()
                failures.append(f"{name}: nvcc exit {rc}\n{log[-4000:]}")
                continue
            os.replace(tmp, todo[name])
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name)[name]))


def build_log(name: str) -> str:
    """nvcc's output for the current source of ``name`` ('' if unbuilt)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """``ptxas -v``'s registers and spill stores a thread of every kernel in
    a build log, keyed by the kernel's mangled name."""
    found, name = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1] if "'" in line else None
        elif name and "Used" in line and "registers" in line:
            found.setdefault(name, {})["registers"] = int(line.split("Used")[1].split()[0])
        elif name and "spill stores" in line:
            found.setdefault(name, {})["spill_stores"] = int(
                line.split("bytes spill stores")[0].split(",")[-1])
    return found
