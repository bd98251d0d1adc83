"""vfs_tpu_torch: the PyTorch and CUDA port of vfs_tpu for NVIDIA Hopper.

Imports ``torch`` and host libraries only, never ``jax`` or ``vfs_tpu``.
Kernels build with ``nvcc`` at their first CUDA call.
"""

from .device import exact_fp32, resolve_device
from .version import __version__

__all__ = ['__version__', 'exact_fp32', 'resolve_device']
