"""Run one cell of BENCHMARK.json once and print its result line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up is timed from the start of this process. Exits with a code other
than 0, and prints no result, without the CUDA devices the cell asks for,
or when the run has loaded jax, jaxlib, flax or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")

# every build and kernel cache at a fixed path inside the checkout (the
# program's own kernels and native library build into its kernels/_build)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(CACHE, sub)
# one thread in each math library's pool (OpenMP, OpenBLAS, MKL; torch's
# CPU ops): the load is one process, so that runs on a shared host spread
# less (set before numpy and torch are imported)
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[0] = ROOT      # the checkout's root, not this folder

from portbench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.run(sys.argv[1:], T_START))
