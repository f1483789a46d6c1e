"""The benchmark's tests: the harness's arithmetic and discovery on the
CPU, and its kinds driven at a tiny size on the CPU (the port's plain
kernels), with the timed path broken underneath."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]
