"""The port imports torch and numpy, never JAX, Flax, Optax, Orbax,
tensorstore, zstandard or any module of the JAX package (it reads Orbax
checkpoints with its own OCDBT and zarr readers over the host's libzstd),
and neither do chip_smoke.py and the card-only tests (both run where JAX
is not installed). Its native library is its own build, never the JAX
package's committed one.

The test session has already imported jax (conftest.py), so the runtime
check runs in a fresh subprocess; a static scan of every import statement
backs it up.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / 'hudiff_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tensorstore', 'zstandard',
             'hudiff_tpu')

_PROBE = r'''
import importlib, json, pkgutil, sys
import hudiff_tpu_torch
for m in pkgutil.walk_packages(hudiff_tpu_torch.__path__, 'hudiff_tpu_torch.'):
    importlib.import_module(m.name)
import chip_smoke  # its main() only runs as a script
from hudiff_tpu_torch.numbering import align
align.align_to_aho('QVQLVESGGGLVQAGGSLRLSCAASGRTFSSYAMGWFRQAPGKEREFVAAISWSGGSTYYADSVKGRF'
                   'TISRDNAKNTVYLQMNSLKPEDTAVYYCAADRGSYYYTRNQYDYWGQGTQVTVSS')
with open('/proc/self/maps') as f:
    libs = sorted({line.split()[-1] for line in f if line.rstrip().endswith('.so')
                   and 'hudiff' in line})
bad = sorted(n for n in sys.modules if n.split('.')[0] in %r)
bad += [p for p in libs if '/hudiff_tpu/' in p]
print(json.dumps([len([n for n in sys.modules if n.startswith('hudiff_tpu_torch.')]),
                  bad, libs]))
sys.exit(1 if bad else 0)
''' % (FORBIDDEN,)


def test_import_loads_no_jax_or_reference_modules():
    """Every module of the port (``api``, ``eval.harness`` and
    ``numbering.align`` among them) imports no forbidden module, and an
    alignment loads the port's own native library, not the JAX package's
    ``hudiff_tpu/native/libhudiff_native.so``."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', _PROBE], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_loaded, _, libs = json.loads(proc.stdout.splitlines()[-1])
    assert n_loaded >= 15  # every submodule was imported
    assert any('/build/hudiff_tpu_torch/libhudiff_native-' in p for p in libs), libs


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


def test_module_walk_finds_the_parallel_and_tool_modules():
    """The runtime probe above imports what ``pkgutil.walk_packages`` finds:
    ``parallel/`` is a package of its own, and the flop counter and the
    tools are among the modules it reaches."""
    import pkgutil

    import hudiff_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(hudiff_tpu_torch.__path__,
                                                   'hudiff_tpu_torch.')}
    for name in ('parallel', 'parallel.mesh', 'parallel.megatron', 'utils.flops',
                 'tools.train_breakdown', 'tools.perf_breakdown', 'tools.parallel_check',
                 'training.ocdbt', 'training.orbax', 'tools.germline_margin',
                 'tools.pps_quality', 'tools.regen_demo_eval', 'tools.migrate_qkv_layout'):
        assert f'hudiff_tpu_torch.{name}' in names, name
