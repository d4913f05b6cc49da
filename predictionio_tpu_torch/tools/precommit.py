"""Pre-commit hook entry point: ``pio check`` of the port over the staged
diff.

Port of ``predictionio_tpu/tools/precommit.py``.
``python -m predictionio_tpu_torch.tools.precommit`` runs the port's
``pio check --changed --format text`` -- the report scoped to the files
under ``predictionio_tpu_torch/`` that git says changed vs HEAD,
per-module rules run only on those files, the interprocedural C/R/P
analyses still see the whole package (a leak in a changed file whose
release lives two modules away, or an ack whose covering commit lives in
a callee, is exactly what the call-graph credit exists for). The run is
budgeted at < 2 s on a one-file diff (test-asserted in
``tests/test_torch_analysis.py``), so it sits comfortably inside a
commit hook. It imports neither ``torch`` nor ``jax``.

Wire it as a plain git hook (the repo's ``.pre-commit-config.yaml``
runs the JAX package's check)::

    echo 'python -m predictionio_tpu_torch.tools.precommit' >> .git/hooks/pre-commit
    chmod +x .git/hooks/pre-commit

Exit status follows ``pio check``: 0 = clean, 1 = findings/stale
baseline entries (the commit is blocked), 2 = usage error. Extra
arguments pass straight through (e.g. ``--format json``).
"""

from __future__ import annotations

import sys


def main(argv: "list[str] | None" = None) -> int:
    from predictionio_tpu_torch.analysis.engine import run_cli

    args = list(sys.argv[1:] if argv is None else argv)
    forwarded = ["--changed"]
    if not any(a.startswith("--format") for a in args):
        forwarded += ["--format", "text"]
    return run_cli(forwarded + args)


if __name__ == "__main__":
    raise SystemExit(main())
