#!/usr/bin/env bash
# Build what the port compiles at first use, once: its CUDA kernels (ops/cuda_build.py: one
# nvcc a source, in parallel, for sm_90a) and its native host core (utils/native.py, g++).
# Each later process loads the libraries from puzzlefusion_plusplus_tpu_torch/csrc/build/,
# and a source is built again only when it changes. The same work as chip_smoke.py's build
# phase; fails without nvcc or without the host core.
set -euo pipefail
cd "$(dirname "$0")/../.."
python - <<'PY'
import time

from puzzlefusion_plusplus_tpu_torch.ops import cuda_build
from puzzlefusion_plusplus_tpu_torch.utils import native

t0 = time.perf_counter()
cuda_build.build_all()
for name in cuda_build.SIGNATURES:
    cuda_build.library(name)
if not native.available():
    raise SystemExit(f"the native host core did not build: {native.build_error}")
print(f"built {len(cuda_build.SIGNATURES)} kernel libraries and the native host core "
      f"in {time.perf_counter() - t0:.1f} s -> {cuda_build.BUILD_DIR}")
PY
