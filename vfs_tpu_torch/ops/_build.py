"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface; sources may include the
shared headers ``csrc/*.cuh``. The library lands in the checkout's
``build/`` directory (listed in ``.gitignore``) under a name keyed by the
hash of the source, the headers and the flags, so a changed source builds
anew and an unchanged one loads at once. Nothing here runs at import:
the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'vfs_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, 'bin', 'nvcc')):
        return os.path.join(CUDA_HOME, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found: the CUDA kernels of vfs_tpu_torch '
                       'build at first use and need the CUDA toolkit')


def _flags(defines: Sequence[str]) -> List[str]:
    return NVCC_FLAGS + [f'-D{d}' for d in defines]


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """The library's path, keyed by the source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    parts = [(CSRC_DIR / f'{name}.cu').read_bytes()]
    parts += [p.read_bytes() for p in sorted(CSRC_DIR.glob('*.cuh'))]
    digest = hashlib.sha256(
        b''.join(parts) + ' '.join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f'{name}-{digest}.so'


def build(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; ``defines``
    are extra ``-D`` macros (the package's own build has none). The
    compiler output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside the library as ``.log``."""
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_flags(defines), '-o', tmp,
           str(CSRC_DIR / f'{name}.cu')]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed for {name}.cu:\n{log}')
    out.with_suffix('.log').write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def counter_ptr(count: Optional[torch.Tensor],
                device: torch.device) -> Optional[int]:
    """The address of an optional counter a kernel adds to: a one-element
    int64 tensor on ``device``, or None (no counting)."""
    if count is None:
        return None
    if (count.device != device or count.dtype != torch.int64
            or count.numel() != 1):
        raise ValueError(f'a counter is one int64 on {device}, got '
                         f'{count.dtype} {tuple(count.shape)} on '
                         f'{count.device}')
    return count.data_ptr()
