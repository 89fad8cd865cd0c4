"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It needs a CUDA device for each chip the
cell asks for and fails without them.  The port builds its kernels into
``build/kernels/`` of the checkout on the first run there.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # caches of any compiler torch may start, at fixed paths in the checkout
    # (the port's own kernels build into build/kernels/)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(ROOT, "build", "gpubench-cache", sub)
    sys.path.insert(0, ROOT)
    from gpubench import core
    return core.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
