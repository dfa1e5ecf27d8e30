"""Build the CUDA sources under ``csrc/`` with nvcc; load them with ctypes.

Each ``.cu`` file exposes a plain C interface and is compiled on its own
into a shared library for Hopper (``sm_90a``), so a build takes seconds
and needs no PyTorch headers.  Libraries land in ``build/repro_torch/``
at the root of the checkout (override with ``REPRO_TORCH_BUILD_DIR``),
named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  :func:`build` starts one nvcc
per source, all at once.

``--fmad=false`` keeps nvcc from contracting ``a*b + c`` into one fused
multiply-add: the flit step's float comparisons must round every step
as the reference does, and the selective scan's update rounds each
product as its plain twin does (its backward recomputes the states as
the forward rounds them).  Attention's inner products call
``fmaf`` themselves or run on the tensor cores (``mma``), which the flag
leaves alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"possibility": "possibility.cu",
           "simstep": "simstep.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_split": "flash_attention_split.cu",
           "flash_attention_tc": "flash_attention_tc.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "flash_attention_bwd_tc": "flash_attention_bwd_tc.cu",
           "selective_scan": "selective_scan.cu",
           "selective_scan_bwd": "selective_scan_bwd.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    """Where the library ``name`` of the current source and flags lies."""
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named libraries (all by default) that are not built
    yet, one nvcc process per source, all started together.  Returns
    the build seconds per library (0.0 for one already built); raises
    with nvcc's output if any build fails.  The ptxas register and
    shared-memory report goes to ``<lib>.log`` beside each library."""
    names = list(SOURCES) if names is None else list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}:\n{log.decode(errors='replace')}")
            continue
        tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    """The ptxas lines (registers, shared memory, spills) of a build; a
    function's stack and spill line, which ptxas prints without its
    prefix, is given the name of the function it follows."""
    log = library_path(name).with_suffix(".log")
    if not log.is_file():
        return ""
    out, func = [], ""
    for line in log.read_text().splitlines():
        if "Function properties for" in line:
            func = line.split("Function properties for", 1)[1].strip()
        if "ptxas" in line:
            out.append(line)
        elif "spill" in line:
            out.append(f"ptxas spills  : {func}: {line.strip()}")
    return "\n".join(out)
