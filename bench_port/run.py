"""The benchmark of box2d_tpu_torch: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run builds the cell's scene on the card,
warms up one episode, steps the port for --seconds seconds, checks what
the window produced against the reference of its scene and prints one
JSON line (the last line of standard output). See harness/cli.py.
"""

import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

if __name__ == "__main__":
    from harness.cli import main

    sys.exit(main(sys.argv[1:], T0))
