"""Run one benchmark cell once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result, a JSON object; the numbers
the judge compared, each with its limit, are the last lines of standard
error.  Exit 2: not enough CUDA cards; 3: JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up starts here, before the heavy imports

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of the program inside the checkout, at
# fixed paths, so that only a cell's first run in a checkout builds
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0, root=ROOT))
