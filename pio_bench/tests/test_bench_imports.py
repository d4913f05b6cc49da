"""A run loads nothing of JAX or of the JAX package: each loaded module's
top-level name (before the first dot) compared whole, so
``predictionio_tpu_torch`` passes and ``predictionio_tpu`` fails."""

import json
import subprocess
import sys

from pio_bench import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from pio_bench import harness
harness.execute({root!r}, {workload!r}, 3, 0.5, False, device="cpu", overrides={toy!r})
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_whole_names_are_compared(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN_MODULES:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "predictionio_tpu_torch.probe", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "predictionio_tpu.probe", sys)
    monkeypatch.setitem(sys.modules, "flax", sys)
    assert harness.forbidden_modules() == ["flax", "predictionio_tpu"]


def test_a_run_imports_neither_jax_nor_the_jax_package(root, toy, tmp_path):
    for workload in toy:
        out = subprocess.run(
            [sys.executable, "-c", PROBE.format(root=root, workload=workload,
                                                toy=toy[workload])],
            capture_output=True, text=True, timeout=600, cwd=root,
            env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
        assert out.returncode == 0, out.stderr[-3000:]
        report = json.loads(out.stdout.strip().splitlines()[-1])
        assert report["forbidden"] == []
        assert "predictionio_tpu_torch" in report["top"] and "torch" in report["top"]
