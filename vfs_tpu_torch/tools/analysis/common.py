"""What the analysis CLIs share: device timing, the card's name and power
limit, and its published peaks."""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Optional

import torch

# (fp32 CUDA-core TFLOP/s, bf16 dense tensor-core TFLOP/s, memory TB/s),
# NVIDIA data sheets at the full power limit; the first matching name wins
PEAKS = [('H100 PCIe', 51.0, 756.0, 2.0), ('H100 NVL', 60.0, 835.0, 3.9),
         ('H100', 67.0, 989.0, 3.35)]


def add_device_arg(parser) -> None:
    parser.add_argument('--device', default=None,
                        help="device to run on; CUDA unless given "
                             "(e.g. 'cpu')")


def sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def time_ms(fn: Callable[[], object], device: torch.device, repeats: int = 3,
            warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``repeats`` runs after
    ``warmup``: CUDA events on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(repeats):
        if device.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def card_line(device: torch.device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them; None
    on the CPU."""
    if device.type != 'cuda':
        return None
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', f'--id={device.index or 0}'],
        capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def peak_flops(device: torch.device, dtype: str) -> Optional[float]:
    """The card's published peak FLOP/s for ``dtype`` (fp32 CUDA cores,
    bf16 dense tensor cores); None on the CPU, which has no device peak."""
    if device.type != 'cuda':
        return None
    name = torch.cuda.get_device_name(device)
    for key, fp32, bf16, _ in PEAKS:
        if key in name:
            break
    else:
        fp32, bf16 = PEAKS[-1][1:3]
    return (bf16 if dtype == 'bfloat16' else fp32) * 1e12


def device_label(device: torch.device) -> str:
    """What the numbers were measured on: the card (name, power limit) or
    the host CPU, whose times are no device metric."""
    line = card_line(device)
    return line if line is not None else 'cpu (host times, not a device)'
