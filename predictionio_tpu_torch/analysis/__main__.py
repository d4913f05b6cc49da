"""``python -m predictionio_tpu_torch.analysis [--self-check] [--explain RULE]
[--changed] [paths...]`` -- the same engine ``pio check`` fronts,
importable without the CLI. Port of
``predictionio_tpu/analysis/__main__.py``."""

import sys

from predictionio_tpu_torch.analysis.engine import run_cli

if __name__ == "__main__":
    sys.exit(run_cli())
