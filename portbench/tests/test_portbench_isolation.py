"""What the benchmark may load, and the frozen copies it keeps."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import synthetic
from portbench.harness.cli import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "portbench" / "reference"


@pytest.mark.parametrize("n,seed", [(1000, 0), (4321, 7), (20_000, 2 ** 40)])
def test_room_cloud_copy_is_byte_identical(n, seed):
    from gp_compressor_tpu_torch.utils import synthetic as port
    for a, b in zip(synthetic.room_cloud(n, seed=seed),
                    port.room_cloud(n, seed=seed)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    pts = synthetic.room_cloud(500, seed=seed)[0]
    for a, b in zip(synthetic.rigid_transform(pts, [0.01, -0.02, 0.3],
                                              [0.1, 0.2, -0.3]),
                    port.rigid_transform(pts, [0.01, -0.02, 0.3],
                                         [0.1, 0.2, -0.3])):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_forbidden_names_compare_whole_top_level_names():
    mods = ["gp_compressor_tpu_torch", "gp_compressor_tpu_torch.config",
            "jaxtyping", "jax_helpers", "numpy", "jax.numpy",
            "gp_compressor_tpu.config", "jaxlib", "flax.linen"]
    assert forbidden_modules(mods) == ["flax.linen", "gp_compressor_tpu.config",
                                       "jax.numpy", "jaxlib"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    files = sorted(REFERENCE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".", 1)[0]
            assert top not in ("gp_compressor_tpu_torch", "gp_compressor_tpu",
                               "jax", "jaxlib"), (f, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (f, name)
    code = ("import importlib, pkgutil, sys, json\n"
            "import portbench.reference as r\n"
            "for m in pkgutil.walk_packages(r.__path__, 'portbench.reference.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(json.dumps(sorted(k for k in sys.modules "
            "if k.split('.')[0] in ('gp_compressor_tpu_torch', "
            "'gp_compressor_tpu', 'jax'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_tiny_run_loads_no_jax():
    code = ("import json, sys\n"
            "from portbench.tests import tiny\n"
            "from portbench.harness.cli import forbidden_modules\n"
            "r = tiny.run('compress.stream')\n"
            "assert 'gp_compressor_tpu_torch' in sys.modules\n"
            "print(json.dumps([r['correct'], forbidden_modules()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]
