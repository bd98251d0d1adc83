"""The card a run measures: its checks, its name and power limit, and the
benchmark's own table of peaks.

The peaks are NVIDIA's data-sheet figures, dense, at the full power
limit. A card whose name matches no row fails the run: a share of a peak
needs the card's own peak, never an assumed one.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import NamedTuple

# (name fragment, fp32 CUDA-core TFLOP/s, device-memory TB/s); the first
# row whose fragment the card's name holds wins, so the PCIe and NVL
# parts come before the SXM part ("NVIDIA H100 80GB HBM3")
PEAKS = (('H100 PCIe', 51.0, 2.0),
         ('H100 NVL', 60.0, 3.9),
         ('H100', 67.0, 3.35))


class Peaks(NamedTuple):
    fp32_flops: float       # FLOP/s
    bytes_per_s: float      # B/s
    row: str


class UnknownCard(RuntimeError):
    pass


def peaks(card_name: str) -> Peaks:
    """The peaks of the card called ``card_name``; ``UnknownCard`` where no
    row matches."""
    for fragment, tflops, tbps in PEAKS:
        if fragment in card_name:
            return Peaks(tflops * 1e12, tbps * 1e12, fragment)
    raise UnknownCard(f'no peak for the card {card_name!r}: the table '
                      f'has {[row[0] for row in PEAKS]}')


def require_cards(chips: int) -> None:
    """Raise unless CUDA is available with at least ``chips`` devices."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the benchmark measures the card')
    if torch.cuda.device_count() < chips:
        raise RuntimeError(f'the cell needs {chips} CUDA devices, '
                           f'{torch.cuda.device_count()} are present')


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or
    ``'not read'`` where it cannot."""
    smi = shutil.which('nvidia-smi')
    if smi is None:
        return 'not read'
    try:
        out = subprocess.run(
            [smi, '--query-gpu=power.limit', '--format=csv,noheader', '-i',
             '0'], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return 'not read'
    return out.stdout.strip() or 'not read'
