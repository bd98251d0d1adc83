"""ctypes bridge to the native C++ decoders (counterpart of
``vfs_tpu/datasets/native_loader.py``; reference: decord in
mmaction/datasets/pipelines/loading.py:801-880).

Two libraries, built with ``g++`` at first use from ``csrc/native/``:

- ``frame_loader.cpp`` (libjpeg): ``decode_jpeg_batch``, a threaded JPEG
  decode (and bilinear resize) into one uint8 RGB batch with the GIL
  released, and ``decode_jpeg_batch_yuv420``, the files' own YCbCr 4:2:0
  planes without a colour conversion;
- ``video_decoder.cpp`` (FFmpeg): ``probe_video`` and
  ``decode_video_indices``, a keyframe seek and one decode of each unique
  frame index, gathered back to the order asked for.

A library lands in the checkout's ``build/vfs_tpu_torch/native/`` under a
name keyed by the hash of its source and the compiler command, written to
a temporary file and renamed into place, so the loader's processes and
the test workers may build it at the same time. Where ``g++``, libjpeg or
FFmpeg's development files are missing the getters return None, the
callers decode with cv2 (as the JAX package does), one WARNING a library
is logged for each process with the compiler's last line, and
``build_error(name)`` gives the reason. This is host decode; nothing here
touches a device.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent.parent / 'csrc' / 'native'
BUILD_DIR = (Path(__file__).resolve().parents[2] / 'build' / 'vfs_tpu_torch'
             / 'native')
CXX_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']
LINK = dict(frame_loader=['-ljpeg', '-lpthread'],
            video_decoder=['-lavformat', '-lavcodec', '-lavutil',
                           '-lswscale'])

logger = logging.getLogger(__name__)

_libs: Dict[str, Optional[ctypes.CDLL]] = {}
_errors: Dict[str, str] = {}
_lock = threading.Lock()


def library_path(name: str) -> Path:
    """Where ``csrc/native/<name>.cpp``'s library goes, keyed by the
    source and the compiler command."""
    digest = hashlib.sha256(
        (SRC_DIR / f'{name}.cpp').read_bytes()
        + ' '.join(CXX_FLAGS + LINK[name]).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def _last_error(log: str) -> str:
    """The compiler's last line that names an error, a compiler's or the
    linker's (not collect2's closing exit status), else its last line."""
    lines = [ln.strip() for ln in log.strip().splitlines() if ln.strip()]
    named = [ln for ln in lines if ('error' in ln or 'ld:' in ln)
             and not ln.startswith('collect2')]
    return (named or lines or [''])[-1]


def _build(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = ['g++', *CXX_FLAGS, str(SRC_DIR / f'{name}.cpp'), *LINK[name],
           '-o', tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f'g++ did not run: {e}') from e
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)  # the linker may have removed it
        raise RuntimeError(_last_error(proc.stderr + proc.stdout)
                           or f'g++ exited {proc.returncode}')
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def _load(name: str, declare: Callable[[ctypes.CDLL], None]
          ) -> Optional[ctypes.CDLL]:
    with _lock:
        if name in _libs:
            return _libs[name]
        try:
            lib = ctypes.CDLL(str(_build(name)))
        except (RuntimeError, OSError) as e:
            _errors[name] = str(e)
            logger.warning('native %s unavailable, decoding with cv2: %s',
                           name, e)
            lib = None
        if lib is not None:
            declare(lib)
        _libs[name] = lib
        return lib


def build_error(name: str) -> Optional[str]:
    """Why ``name`` (``'frame_loader'`` or ``'video_decoder'``) did not
    load in this process: the compiler's last line, or None."""
    return _errors.get(name)


def _declare_jpeg(lib: ctypes.CDLL) -> None:
    batch = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    for fn in (lib.fl_decode_batch, lib.fl_decode_batch_yuv420):
        fn.restype = ctypes.c_int
        fn.argtypes = batch
    lib.fl_probe.restype = ctypes.c_int
    lib.fl_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int)]


def _declare_video(lib: ctypes.CDLL) -> None:
    lib.vd_probe.restype = ctypes.c_int
    lib.vd_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double)]
    lib.vd_decode_indices.restype = ctypes.c_int
    lib.vd_decode_indices.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]


def get_lib() -> Optional[ctypes.CDLL]:
    """The JPEG library (built if needed); None if it cannot build."""
    return _load('frame_loader', _declare_jpeg)


def get_video_lib() -> Optional[ctypes.CDLL]:
    """The FFmpeg decoder (built if needed); None if it cannot build."""
    return _load('video_decoder', _declare_video)


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def probe_jpeg(path: str) -> Optional[Tuple[int, int]]:
    """(height, width) of a JPEG, or None."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.fl_probe(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 1:
        return None
    return h.value, w.value


def decode_jpeg_batch(paths: List[str],
                      out_hw: Optional[Tuple[int, int]] = None,
                      num_threads: int = 8) -> Optional[np.ndarray]:
    """Decode JPEGs into one (N, H, W, 3) uint8 RGB array, resized to
    ``out_hw`` (default: the first frame's size). None if the library is
    unavailable or any frame fails (the caller decodes with cv2)."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    if out_hw is None:
        out_hw = probe_jpeg(paths[0])
        if out_hw is None:
            return None
    out = np.empty((len(paths), out_hw[0], out_hw[1], 3), np.uint8)
    ok = lib.fl_decode_batch(_paths(paths), len(paths), out_hw[0],
                             out_hw[1], _u8(out), num_threads)
    return out if ok == len(paths) else None


def decode_jpeg_batch_yuv420(paths: List[str], num_threads: int = 8):
    """Decode JPEGs straight to flat planar I420, a ``Yuv420Frames`` (N,
    H*W*3/2) in the full-range ``'jpeg'`` convention: the values the
    files store, with no host colour conversion (the card converts,
    ``ops.yuv.yuv420_to_rgb``). Every frame must have the first frame's
    even size. None if the library is unavailable or any frame fails (the
    caller decodes RGB with cv2 and packs it)."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    probed = probe_jpeg(paths[0])
    if probed is None or probed[0] % 2 or probed[1] % 2:
        return None
    h, w = probed
    out = np.empty((len(paths), h * w * 3 // 2), np.uint8)
    ok = lib.fl_decode_batch_yuv420(_paths(paths), len(paths), h, w,
                                    _u8(out), num_threads)
    if ok != len(paths):
        return None
    from ..ops.yuv import Yuv420Frames
    return Yuv420Frames(out, (h, w), convention='jpeg')


def probe_video(path: str) -> Optional[Tuple[int, int, int, float]]:
    """(num_frames, height, width, fps) from the container, or None."""
    lib = get_video_lib()
    if lib is None:
        return None
    nf, fps = ctypes.c_int64(), ctypes.c_double()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.vd_probe(path.encode(), ctypes.byref(nf), ctypes.byref(h),
                    ctypes.byref(w), ctypes.byref(fps)) != 0:
        return None
    return int(nf.value), h.value, w.value, fps.value


def decode_video_indices(path: str, indices,
                         out_hw: Optional[Tuple[int, int]] = None
                         ) -> Optional[np.ndarray]:
    """The frames at ``indices`` (unordered, repeats allowed) of a video
    as one (len(indices), H, W, 3) uint8 RGB array, resized to ``out_hw``
    (default: the stream's size).

    Each unique index is decoded once, in ascending order after a seek to
    the keyframe before the first (decord's unique-index map, reference
    loading.py:855-876), then gathered back to the order asked for.
    Indices past the last frame the stream holds take that last frame
    (decord's clamp), even when all of them lie past it. None if the
    library is unavailable or nothing decodes."""
    lib = get_video_lib()
    if lib is None:
        return None
    indices = np.asarray(indices, np.int64).reshape(-1)
    if indices.size == 0:
        return None
    if out_hw is None:
        probed = probe_video(path)
        if probed is None:
            return None
        out_hw = probed[1:3]
    unique, inverse = np.unique(indices, return_inverse=True)
    buf = np.empty((len(unique), out_hw[0], out_hw[1], 3), np.uint8)
    rc = lib.vd_decode_indices(
        path.encode(), unique.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(unique), _u8(buf), out_hw[0], out_hw[1])
    if rc <= 0:
        return None
    return buf[inverse.reshape(-1)]
