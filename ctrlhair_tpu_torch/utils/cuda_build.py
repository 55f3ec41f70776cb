# Build-at-first-use for the port's native code.
#
# Each hand-written CUDA kernel is one source under ctrlhair_tpu_torch/csrc/
# with a plain C interface, compiled by nvcc (CudaKernel); the host C++ of
# ctrlhair_tpu_torch/native/ is compiled by the host compiler (HostLibrary).
# Either way the result is a shared library under ctrlhair_tpu_torch/_build/,
# named by a hash of the sources and the flags, and loaded with ctypes;
# nothing includes PyTorch's headers, so a build takes seconds.  The build
# writes to a temporary name and renames, so a build cut off half-way leaves
# no library behind, and two processes that build at once both end with a
# whole one.  The compiler's output (for nvcc the `-Xptxas -v` report:
# registers, shared memory, spills) is kept beside the library as
# <library>.log.  A build or a load that fails raises: nothing gives way to
# another implementation.

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else from PATH, else the toolkit's default
    install prefix (the same search as torch.utils.cpp_extension)."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if home:
        return str(Path(home) / 'bin' / 'nvcc')
    return shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'


def host_compiler() -> Sequence[str]:
    """The command prefix that compiles C++ host code into a shared library:
    g++ or c++ from PATH, else nvcc, which hands a .cpp to its host
    compiler."""
    for name in ('g++', 'c++'):
        path = shutil.which(name)
        if path:
            return (path, '-O3', '-shared', '-fPIC')
    return (nvcc_path(), '-O3', '-shared', '-Xcompiler', '-fPIC')


class NativeLibrary:
    """A shared library built on first use from sources of this package."""

    def __init__(self, name: str, sources: Sequence[Path],
                 declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.sources = tuple(sources)
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def command(self) -> Sequence[str]:
        """Compiler and flags; `-o <library> <sources>` is appended."""
        raise NotImplementedError

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for src in self.sources:
            h.update(src.read_bytes())
        h.update(' '.join(self.command()).encode())
        return BUILD_DIR / f'lib{self.name}-{h.hexdigest()[:16]}.so'

    def build(self) -> Path:
        """Compile the library unless these sources' build exists."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [*self.command(), '-o', str(tmp), *map(str, self.sources)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f'cannot run {cmd[0]} to build {self.name}: '
                               f'{e}') from e
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f'{cmd[0]} failed for {self.name} '
                               f'(exit {proc.returncode}):\n{log}')
        Path(f'{out}.log').write_text(log)
        os.replace(tmp, out)
        return out

    def build_log(self) -> str:
        """The compiler's output for the current build."""
        return Path(f'{self.build()}.log').read_text()

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path = self.build()
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError as e:
                    raise RuntimeError(f'cannot load {path}: {e}') from e
                self._declare(lib)
                self._lib = lib
            return self._lib


class HostLibrary(NativeLibrary):
    """Host C++ sources compiled by `host_compiler()`."""

    def command(self) -> Sequence[str]:
        return host_compiler()


class CudaKernel(NativeLibrary):
    """One hand-written kernel: its library, built by nvcc on first use from
    csrc/<name>.cu, and the count of its launches.  The wrapper that
    launches it adds one to `launches` per launch (count_launch: under a
    lock, as threads may launch at once), and nothing else touches the
    count except a caller resetting it to 0."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None],
                 extra_flags: Sequence[str] = ()):
        super().__init__(name, [CSRC_DIR / f'{name}.cu'], declare)
        self.source = self.sources[0]
        self.extra_flags = tuple(extra_flags)
        self.launches = 0
        self._count_lock = threading.Lock()

    def count_launch(self) -> None:
        with self._count_lock:
            self.launches += 1

    def command(self) -> Sequence[str]:
        return (nvcc_path(), *NVCC_FLAGS, *self.extra_flags)
