"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are compared
whole: the port's ``hudiff_tpu_torch`` begins with ``hudiff_tpu``."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'hudiff_tpu')


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, '-c', code + '\nimport sys\n'
                          'print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))'],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_harness_drivers_and_readers_load_no_jax():
    code = '\n'.join([
        'from pathlib import Path',
        'from benchmark import harness as H, calibrate, run  # noqa',
        'for p in sorted(Path("benchmark/drivers").glob("*.py")):',
        '    H.load_module(p, "d_" + p.stem)',
        'for p in sorted(Path("benchmark/metrics").glob("*.py")):',
        '    H.load_module(p, "m_" + p.stem.replace(".", "_"))'])
    loaded = _loaded(code)
    assert 'hudiff_tpu_torch' in loaded
    assert not loaded & set(BANNED)


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded('import benchmark.reference.denoiser, benchmark.reference.sampling, '
                     'benchmark.reference.train')
    assert not loaded & set(BANNED) and 'hudiff_tpu_torch' not in loaded


def test_reference_sources_name_no_program_module():
    for path in (ROOT / 'benchmark' / 'reference').glob('*.py'):
        text = path.read_text()
        assert 'hudiff_tpu' not in text and 'import jax' not in text, path
