"""Build the port's CUDA kernels from ``csrc/*.cu`` and load them with ctypes.

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface (no PyTorch headers: seconds per file, not minutes) under
``build/torch_kernels/`` at the repository root, a directory ``.gitignore``
lists. A library's file name carries a hash of its source, the local headers
it includes (``#include "x.cuh"``) and the flags, so an edited source or
header rebuilds on its next use and an unchanged one loads as built.
``build_all`` starts one ``nvcc`` per source at once; ``library`` builds
what is missing on first use. Nothing is built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("paged_attention", "mha", "gemm_os", "conv_im2col", "maxpool",
           "reshuffle", "sampler")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "port's CUDA kernels are built on the machine with the GPU")
    return str(path)


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_bytes(path: Path, seen=None) -> bytes:
    """``path``'s bytes followed by those of every local header it includes,
    transitively, each once."""
    seen = set() if seen is None else seen
    seen.add(path)
    text = path.read_bytes()
    out = [text]
    for inc in _LOCAL_INCLUDE.findall(text):
        header = path.parent / inc.decode()
        if header not in seen:
            out.append(_source_bytes(header, seen))
    return b"".join(out)


def lib_path(name: str) -> Path:
    src = _source_bytes(CSRC / f"{name}.cu")
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Tuple[str, float]]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns, per source, the compiler's report (``-Xptxas -v``:
    registers, shared memory, spills) and the seconds from the start of
    the builds to that ``nvcc``'s exit (``("", 0.0)`` for a library already
    built). Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = tmp.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as fh:     # a file, not a pipe: nvcc never blocks
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        procs[name] = (proc, tmp, out, log)
    reports = {name: ("", 0.0) for name in names}
    done = set()
    while len(done) < len(procs):
        for name, (proc, *_rest) in procs.items():
            if name not in done and proc.poll() is not None:
                done.add(name)
                reports[name] = ("", time.perf_counter() - t0)
        time.sleep(0.02)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        text = log.read_text()
        log.unlink(missing_ok=True)
        reports[name] = (text, reports[name][1])
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n"
                          f"{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built if missing);
    one load per process."""
    path = lib_path(name)
    if not path.exists():
        build_all([name])
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_on(device, fn, *args) -> int:
    """``fn(*args, stream)``: a kernel's C launch function, called on
    ``device``'s current stream with ``device`` as the current device (a
    CUDA launch goes to the thread's current device). The device is
    switched only when it is not current already: the context manager
    costs microseconds per call."""
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def refuse_fake(kernel: str, *tensors) -> None:
    """Raise when an input is a ``FakeTensor`` or on the ``meta`` device:
    it has shapes but no memory (a fake's ``data_ptr()`` is 0), so the
    kernel would launch on null pointers. Checked first in every wrapper,
    before any build or launch; a trace (the dry-run) makes its fakes on
    the CPU device, where the seam takes the plain version."""
    from torch._subclasses.fake_tensor import FakeTensor
    for t in tensors:
        if isinstance(t, torch.Tensor) and (isinstance(t, FakeTensor)
                                            or t.device.type == "meta"):
            raise RuntimeError(
                f"{kernel} kernel: an input is a fake or meta tensor (no "
                f"memory behind it); trace on CPU-device fakes, whose seam "
                f"takes the plain version")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when autograd would record through ``kernel``: its wrapper
    writes into a fresh tensor that has no ``grad_fn``, so a loss through it
    would run its backward without error and give the kernel's inputs no
    gradient. Checked first in every wrapper, before the device check, so
    the refusal shows on any device; serving is unaffected, since its
    parameters do not require grad. Training attends through the plain
    ``models.layers.flash_attention`` instead."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} kernel: an input requires grad, but the kernel has no "
            f"backward; differentiate through its plain version (training "
            f"attends through models.layers.flash_attention) or call it "
            f"under torch.no_grad()")

