"""Build and load the hand-written CUDA kernels and the host C libraries.

Each `csrc/*.cu` file has a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into its own shared library, loaded with `ctypes`;
each `native/*.c` file (the host tier: batch parse, slot manager, warm
tier) is compiled by the system C compiler the same way. Libraries are
built at first use, from the sources in the checkout, into
`build/kernels/` and `build/native/` at the repository root (listed in
`.gitignore`); the file name carries a hash of the source, so an edited
source is rebuilt. `build_all` starts one compiler per source at once.
A library that cannot be built or loaded raises: nothing falls back.

A CUDA library also holds its kernel's launch count: the wrapper that
launches the kernel adds one per launch (`count_launch`, under a lock,
since the pipeline's stage threads launch concurrently), and nothing
else does. `launches_by_thread` splits the count by thread name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NATIVE_SRC_DIR = _PKG / "native"
NATIVE_BUILD_DIR = _PKG.parent / "build" / "native"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _cc() -> str:
    for name in ("cc", "gcc", "clang"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C compiler found: cc is needed to build the native host libraries")


class CudaLibrary:
    """One kernel source, its built library and its launch count."""

    src_dir = SRC_DIR
    build_dir = BUILD_DIR

    def __init__(self, name: str, source: str, functions: Dict[str, Sequence]):
        self.name = name
        self.source = self.src_dir / source
        self.functions = functions  # C function -> ctypes argtypes
        self.launches = 0
        self.launches_by_thread: Dict[str, int] = {}
        self._count_lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def count_launch(self) -> None:
        name = threading.current_thread().name
        with self._count_lock:
            self.launches += 1
            self.launches_by_thread[name] = self.launches_by_thread.get(name, 0) + 1

    def reset_launches(self) -> None:
        with self._count_lock:
            self.launches = 0
            self.launches_by_thread = {}

    @property
    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
        return self.build_dir / f"lib{self.name}-{digest}.so"

    def _command(self, out: Path) -> List[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def _bind(self, lib: ctypes.CDLL) -> None:
        for fn, argtypes in self.functions.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int

    def _start_build(self) -> Optional[subprocess.Popen]:
        out = self.path
        if out.exists():
            return None
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = self._command(tmp)
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        proc.tmp_path = tmp  # type: ignore[attr-defined]
        return proc

    def _finish_build(self, proc: subprocess.Popen) -> None:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{proc.args[0]} failed for {self.source.name}:\n{output}")
        os.replace(proc.tmp_path, self.path)  # type: ignore[attr-defined]

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            proc = self._start_build()
            if proc is not None:
                self._finish_build(proc)
            lib = ctypes.CDLL(str(self.path))
            self._bind(lib)
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        """Call a C launcher; it returns cudaGetLastError() after the launch."""
        err = getattr(self.lib(), fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}.{fn} failed: CUDA error {err}")


class HostLibrary(CudaLibrary):
    """One host C source of `native/`, built with `cc -O3 -shared -fPIC`.
    `functions` maps each C function to (restype, argtypes)."""

    src_dir = NATIVE_SRC_DIR
    build_dir = NATIVE_BUILD_DIR

    def _command(self, out: Path) -> List[str]:
        return [_cc(), "-O3", "-shared", "-fPIC", "-o", str(out), str(self.source), "-lm"]

    def _bind(self, lib: ctypes.CDLL) -> None:
        for fn, (restype, argtypes) in self.functions.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = restype


def build_all(libs: List[CudaLibrary]) -> float:
    """Build every library not yet built, one nvcc each, all at once;
    returns the wall seconds the builds took."""
    t0 = time.perf_counter()
    procs = [(lib, lib._start_build()) for lib in libs]
    failures = []
    for lib, proc in procs:
        if proc is None:
            continue
        try:
            lib._finish_build(proc)
        except RuntimeError as e:
            failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))
    for lib in libs:
        lib.lib()
    return time.perf_counter() - t0


def raw_stream(device) -> int:
    """The handle of the current CUDA stream of `device` (a torch.device
    with an index), as a launcher takes it: what
    `torch.cuda.current_stream(device).cuda_stream` gives, without building
    a Stream object, which costs a few microseconds a launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
