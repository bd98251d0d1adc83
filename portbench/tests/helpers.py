"""Running a cell in the test process, on the CPU."""

import io
import json

from portbench.harness import runner


def run_cell(bench_dir: str, cell: str, seed: int = 11, seconds: float = 0.5,
             trace: int = 0, tamper=None):
    """(exit code, the parsed result line or None)."""
    out = io.StringIO()
    rc = runner.run(['--workload', cell, '--seed', str(seed), '--seconds',
                     str(seconds), '--trace', str(trace)], device='cpu',
                    bench_dir=bench_dir, tamper=tamper, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
