"""Readings that set the limits of ``correct``; the benchmark's runs do
not make them:

    python3 portbench/control.py --workload NAME --what control \
        --seeds S1 S2 S3 [--device cuda]

``--what`` is ``program`` (sound readings of the program, for the lower
end of a limit), ``control`` (the reference in TF32 in the program's
place, for the upper end) or a fault the cell's driver knows
(``half_batch``). Each seed prints one JSON line of the compared numbers
with their current limits and the driver's detail (a train cell's worst
leaves), at the cell's own sizes, in one process.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    from portbench.harness import spec
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--what', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    cell = spec.find_cell(spec.load_json(spec.bench_file()), args.workload)
    driver = spec.driver(cell.config)
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks, detail = driver.readings(cell, seed, args.device,
                                         args.what)
        print(json.dumps(dict(
            workload=args.workload, what=args.what, seed=seed,
            seconds=time.perf_counter() - t0,
            checks={c.name: dict(value=c.value, limit=c.limit)
                    for c in checks}, detail=detail)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
