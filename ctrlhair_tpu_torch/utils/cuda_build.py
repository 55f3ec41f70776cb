# Build-at-first-use for the port's hand-written CUDA kernels.
#
# Each kernel is one source under ctrlhair_tpu_torch/csrc/ with a plain C
# interface.  It is compiled by nvcc into a shared library under
# ctrlhair_tpu_torch/_build/, named by a hash of the source and the flags,
# and loaded with ctypes; nothing includes PyTorch's headers, so a build
# takes seconds.  The build writes to a temporary name and renames, so a
# build cut off half-way leaves no library behind, and two processes that
# build at once both end with a whole one.  nvcc's `-Xptxas -v` report
# (registers, shared memory, spills) is kept beside the library as
# <library>.log.

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

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


class CudaKernel:
    """One hand-written kernel: its library, built on first use, and the
    count of its launches.  The wrapper that launches it adds one to
    `launches` per launch, and nothing else touches the count except a
    caller resetting it to 0."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC_DIR / f'{name}.cu'
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.launches = 0

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(' '.join(NVCC_FLAGS).encode())
        return BUILD_DIR / f'lib{self.name}-{h.hexdigest()[:16]}.so'

    def build(self) -> Path:
        """Compile the library unless this source's build exists."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f'nvcc failed for {self.source.name} '
                               f'(exit {proc.returncode}):\n{log}')
        Path(f'{out}.log').write_text(log)
        os.replace(tmp, out)
        return out

    def build_log(self) -> str:
        """nvcc's report for the current build (registers, smem, spills)."""
        return Path(f'{self.build()}.log').read_text()

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
            return self._lib
