#!/usr/bin/env bash
# CI entry of the PyTorch/CUDA port (counterpart of scripts/ci.sh): the port's
# CPU tests (tests/test_torch_*.py, without the slow ones and those that need
# a card), then the CLI's canned smoke replay and the benchmark at B=2 on the
# CPU.
set -euo pipefail
cd "$(dirname "$0")/.."

python -m pytest tests/test_torch_*.py -q -m 'not slow and not gpu'
python scripts/main_torch.py --test --device cpu
QTOS_BENCH_BATCHES=2 python3 bench_torch.py --device cpu
echo "CI OK"
