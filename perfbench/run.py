"""One run of one benchmark cell of gan_rl_3d_tpu_torch on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints the result as one JSON line, last on
standard output; the correctness check's numbers and limits go last on
standard error. See perfbench/harness.py.
"""

import sys
from pathlib import Path

# the checkout's root, not this directory, so that the harness's modules do
# not shadow the standard library's
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
