"""Run one cell of the benchmark once:

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See servebench/README.md and harness.py.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from servebench.harness import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
