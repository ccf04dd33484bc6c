"""Run one benchmark cell once:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the numbers compared with the reference, each with
its limit, are the last lines of standard error.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
