"""One run of one benchmark cell on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints the run's result as the last line of standard output, and the
numbers its check compared, each beside its limit, as the last lines of
standard error.  Without the cards the cell asks for it exits non-zero.
"""
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark import harness

    sys.exit(harness.main(t_start=T_START))
