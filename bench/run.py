"""One run of one benchmark cell; see bench/README.md.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The checkout's root (for ``bench``) and ``src`` (for the program) replace
# this script's folder, whose subfolders would shadow top-level modules.
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
# Every cache a run writes stays at a fixed path inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ.setdefault("OMP_NUM_THREADS", "4")

from bench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
