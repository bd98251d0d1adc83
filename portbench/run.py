"""Run one cell of the benchmark of ``vfs_tpu_torch`` once, on the card:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. It builds the cell's inputs and weights from
the seed, warms up, measures for ``--seconds`` seconds, compares what the
window produced with the plain reference, and prints one JSON line (the
last line of standard output). The program's kernel builds and the CUDA
and Triton caches stay in fixed directories under the checkout's
``build/``. Without a CUDA device it exits with code 2 and prints no
result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, 'build', 'portbench')
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton'),
                 ('CUDA_CACHE_PATH', 'cuda_cache')):
    os.environ[var] = os.path.join(CACHE, sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> int:
    from portbench.harness import runner
    return runner.run(sys.argv[1:], t_start=T_START)


if __name__ == '__main__':
    sys.exit(main())
