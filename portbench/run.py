"""Run one cell of the repro_torch benchmark on the card and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; the cells, metrics and limits are named in
``BENCHMARK.json`` (see ``portbench/harness.py``).
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import main

    sys.exit(main())
