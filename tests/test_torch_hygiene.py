"""The port imports torch and numpy, never JAX, Flax, Optax, Orbax or any
module of the JAX package, and neither do chip_smoke.py and the card-only
tests (both run where JAX is not installed).

The test session has already imported jax (conftest.py), so the runtime
check runs in a fresh subprocess; a static scan of every import statement
backs it up.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / 'hudiff_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'hudiff_tpu')

_PROBE = r'''
import importlib, pkgutil, sys
import hudiff_tpu_torch
for m in pkgutil.walk_packages(hudiff_tpu_torch.__path__, 'hudiff_tpu_torch.'):
    importlib.import_module(m.name)
import chip_smoke  # its main() only runs as a script
bad = sorted(n for n in sys.modules if n.split('.')[0] in %r)
print(len([n for n in sys.modules if n.startswith('hudiff_tpu_torch.')]), bad)
sys.exit(1 if bad else 0)
''' % (FORBIDDEN,)


def test_import_loads_no_jax_or_reference_modules():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', _PROBE], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_loaded = int(proc.stdout.split()[0])
    assert n_loaded >= 15  # every submodule was imported


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', sorted(PORT.rglob('*.py')) + [
    REPO / 'chip_smoke.py', REPO / 'tests' / 'test_torch_kernels_cuda.py'],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statements(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f'{path} imports {bad}'
