"""The port's reader of the JAX package's Orbax checkpoints
(native/__init__.py, csrc/crc32c.cc, training/ocdbt.py, training/orbax.py,
training/checkpoints.py) against JAX, orbax, tensorstore and zstandard.

- ``native.zstd_decompress`` (the host's libzstd) against ``zstandard`` as a property (levels 1, 3, 9, 19
  and -5; with and without content size and checksum; empty input, input
  over 128 KiB, several frames), a window over 8 MiB, skippable and
  streamed frames; truncated, corrupted and dictionary frames raise.
- The OCDBT store's keys and raw values against tensorstore's on both
  demos, on JAX's full-width checkpoints with their optimizer state, and
  on stores tensorstore writes with small nodes (interior B+tree nodes,
  many versions); zarr arrays on chunk grids, absent chunks, bfloat16.
- Every leaf of both demos and of JAX ``save``'s full-width Ab and Nb
  checkpoints (with ``opt_state``) equal bit for bit to JAX's ``restore``;
  the digests ``chip_smoke.py`` holds the card's reading against.
- ``load_denoiser`` on the demos: f32 logits within 1e-4 of JAX's.
- ``api.humanize_pair`` on the Ab demo, with the sampler's invariants.
- The reader in a process where jax, orbax, tensorstore and zstandard
  cannot be imported.
- A resume that continues a JAX run: the same Adam moments, the same next
  update, and ``pretrain.run --resume`` on the Orbax directory.
- The ``.qkv_layout`` finding: JAX's ``save`` writes no marker and its
  migrate tool reads a missing marker as part-major, so it permutes a fresh
  head-major directory a second time; the port reads a missing marker as
  head-major.
"""
import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from hudiff_tpu.models.denoiser import AntiTFNet as JAnti
from hudiff_tpu.models.denoiser import DenoiserConfig as JCfg
from hudiff_tpu.models.denoiser import NanoAntiTFNet as JNano
from hudiff_tpu.models.denoiser import nano_config as j_nano_config
from hudiff_tpu.sampling import humanize as JH
from hudiff_tpu.training import checkpoints as JCK
from hudiff_tpu.training import schedules as JS
from hudiff_tpu.utils.config import load_yaml as j_load_yaml
from hudiff_tpu_torch import api, native
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.models.denoiser import AntiTFNet, DenoiserConfig
from hudiff_tpu_torch.sampling import humanize as H
from hudiff_tpu_torch.training import checkpoints as CK
from hudiff_tpu_torch.training import orbax as OB
from hudiff_tpu_torch.training import pretrain as PT
from hudiff_tpu_torch.training import schedules as S
from hudiff_tpu_torch.training.ocdbt import OcdbtStore
from hudiff_tpu_torch.utils.config import load_yaml

import chip_smoke

torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = {'ab': os.path.join(REPO, 'examples', 'demo_ab_tiny'),
         'nb': os.path.join(REPO, 'examples', 'demo_nb_tiny')}
REGION = np.concatenate([C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX])
H1 = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
      'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYWGQGTTLTVSS')
L1 = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
      'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')

zstandard = pytest.importorskip('zstandard')
ts = pytest.importorskip('tensorstore')


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_tree(want, got, path=''):
    """JAX's restored tree and the port's: the same nesting (lists for
    sequences), None where JAX has None, leaves equal bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), path
        for k in want:
            _same_tree(want[k], got[k], f'{path}/{k}')
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _same_tree(a, b, f'{path}/{i}')
    elif want is None:
        assert got is None, path
    else:
        a = np.asarray(want)
        assert (a.dtype, a.shape) == (got.dtype, got.shape), path
        assert a.tobytes() == got.tobytes(), path


# -- zstd ---------------------------------------------------------------------------

def _content(kind, n, seed):
    rs = np.random.RandomState(seed)
    if kind == 'random':
        return rs.randint(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 'protein':
        return bytes(rs.choice(np.frombuffer(b'ACDEFGHIKLMNPQRSTVWY', np.uint8), n))
    if kind == 'floats':
        return rs.standard_normal((n + 3) // 4).astype('<f4').tobytes()[:n]
    if kind == 'repeat':
        return (b'{"chunks":[23,64],"dtype":"<f4"}' * (n // 32 + 1))[:n]
    return bytes(n)


@settings(max_examples=40, deadline=None)
@given(level=st.sampled_from([1, 3, 9, 19, -5]),
       size=st.sampled_from([0, 1, 37, 4096, 70000, 200_000]),
       kind=st.sampled_from(['random', 'protein', 'floats', 'repeat', 'zeros']),
       content_size=st.booleans(), checksum=st.booleans(),
       frames=st.integers(1, 3), seed=st.integers(0, 2 ** 16))
def test_zstd_matches_zstandard(level, size, kind, content_size, checksum, frames, seed):
    cctx = zstandard.ZstdCompressor(level=level, write_content_size=content_size,
                                    write_checksum=checksum)
    parts = [_content(kind, size // (i + 1), seed + i) for i in range(frames)]
    data = b''.join(cctx.compress(p) for p in parts)
    assert native.zstd_decompress(data) == b''.join(parts)


def test_zstd_streamed_skippable_and_large_window_frames():
    a = _content('protein', 3000, 1)
    b = _content('repeat', 150_000, 2)
    streamed = zstandard.ZstdCompressor(level=9, write_checksum=True).compressobj()
    fb = streamed.compress(b) + streamed.flush()   # no content size in its header
    assert not fb[4] & 0xC0
    skip = (0x184D2A53).to_bytes(4, 'little') + (5).to_bytes(4, 'little') + b'hello'
    fa = zstandard.ZstdCompressor(level=3).compress(a)
    assert native.zstd_decompress(fa + skip + fb + fa) == a + b + a
    # a 12 MiB input whose second half repeats its first: matches 6 MiB back
    half = np.random.RandomState(3).randint(0, 20, 6 << 20, dtype=np.uint8).tobytes()
    params = zstandard.ZstdCompressionParameters.from_level(3, window_log=24,
                                                           enable_ldm=True)
    big = zstandard.ZstdCompressor(compression_params=params).compress(half + half)
    assert len(big) < len(half)   # the long match was taken
    assert native.zstd_decompress(big) == half + half


def test_zstd_rejects_truncated_corrupted_and_dictionary_frames():
    data = _content('protein', 20_000, 4)
    good = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    for bad in (good[:-7], good[:len(good) // 2], good[:-1] + bytes([good[-1] ^ 1]), b'',
                b'\x00' * 16):
        with pytest.raises(ValueError, match='zstd'):
            native.zstd_decompress(bad)
    # a flipped bit under a checksum: the frame raises or decodes exactly
    rs = np.random.RandomState(5)
    for _ in range(300):
        c = bytearray(good)
        c[rs.randint(len(c))] ^= 1 << rs.randint(8)
        try:
            assert native.zstd_decompress(bytes(c)) == data
        except ValueError:
            pass
    samples = [b'antibody %d heavy chain ' % i + _content('protein', 40, i)
               for i in range(500)]
    dictionary = zstandard.train_dictionary(2048, samples)
    framed = zstandard.ZstdCompressor(dict_data=dictionary).compress(samples[7])
    with pytest.raises(ValueError, match='Dictionary mismatch'):
        native.zstd_decompress(framed)


def test_crc32c_known_values():
    assert native.crc32c(b'123456789') == 0xE3069283
    assert native.crc32c(b'') == 0
    assert native.crc32c(bytes(32)) == 0x8A9136AA


# -- OCDBT ---------------------------------------------------------------------------

def _tensorstore_kv(root):
    return ts.KvStore.open({'driver': 'ocdbt',
                            'base': 'file://' + os.path.abspath(root) + '/'}).result()


def _holds_tensorstores(root):
    store = OcdbtStore(root)
    kv = _tensorstore_kv(root)
    keys = sorted(k.decode() for k in kv.list().result())
    assert store.list() == keys
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    return store


@pytest.fixture(scope='module')
def jax_full_ckpts(tmp_path_factory):
    """JAX ``save`` of full-width Ab (configs/antibody_train.yml) and Nb
    (``nano_config()``) parameters with an optax state (clip + injected
    Adam), all leaves random; {name: run dir}."""
    out = {}
    rs = np.random.RandomState(0)
    ab_cfg = j_load_yaml(os.path.join(REPO, 'configs', 'antibody_train.yml'))
    for name, net, args in (
            ('ab', JAnti(JCfg.from_dict(dict(ab_cfg.model))),
             (jnp.zeros((1, C.PAIR_LEN), jnp.int32), jnp.asarray(REGION[None]),
              jnp.zeros((1, 2), jnp.int32))),
            ('nb', JNano(j_nano_config()),
             (jnp.zeros((1, C.HEAVY_LEN), jnp.int32),
              jnp.asarray(C.HEAVY_REGION_INDEX[None])))):
        shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), *args)
        params = jax.tree_util.tree_map(
            lambda s: rs.standard_normal(s.shape).astype(np.float32), shapes)
        tx = JS.make_optimizer(ab_cfg.train.optimizer, clip_norm=10)
        opt = jax.tree_util.tree_map(
            lambda a: (rs.standard_normal(a.shape).astype(a.dtype) if a.ndim else a),
            tx.init(params))
        run = str(tmp_path_factory.mktemp(f'jax_full_{name}'))
        JCK.save(run, 7, params, opt, config={'model': dataclasses_asdict(net.cfg)},
                 extra={'opt_steps': 14})
        out[name] = run
    return out


def dataclasses_asdict(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize('name', ['ab', 'nb'])
def test_ocdbt_matches_tensorstore_on_the_demos(name):
    step = OB.step_dir(DEMOS[name], CK.latest_step(DEMOS[name]))
    store = _holds_tensorstores(step)
    assert len(store.list()) == {'ab': 222, 'nb': 136}[name]
    _holds_tensorstores(os.path.join(step, 'ocdbt.process_0'))  # the per-process store


@pytest.mark.parametrize('name', ['ab', 'nb'])
def test_ocdbt_matches_tensorstore_on_jax_full_width_checkpoints(jax_full_ckpts, name):
    store = _holds_tensorstores(OB.step_dir(jax_full_ckpts[name], 7))
    # params, mu, nu and the scalars: one leaf node, one chunk an array
    assert store.height == 0
    assert len(store.list()) > 2 * 3 * 100


def test_ocdbt_interior_nodes_and_many_versions(tmp_path):
    root = str(tmp_path / 'kv')
    kv = ts.KvStore.open({'driver': 'ocdbt', 'base': 'file://' + root + '/',
                          'config': {'max_decoded_node_bytes': 512,
                                     'compression': {'id': 'zstd', 'level': 5}}}).result()
    for i in range(120):
        value = (b'v%d' % i) * (700 if i % 7 == 0 else 1 + i % 5)  # indirect and inline
        kv.write(b'key/%04d/abc' % i, value).result()
    kv.delete_range(ts.KvStore.KeyRange(b'key/0003/abc', b'key/0003/abd')).result()
    store = _holds_tensorstores(root)
    assert store.height > 0 and len(store.list()) == 119


def test_ocdbt_footer_is_checked(tmp_path):
    step = str(tmp_path / 'step')
    shutil.copytree(OB.step_dir(DEMOS['nb'], 900), step)
    node = glob.glob(os.path.join(step, 'd', '*'))[0]
    data = bytearray(open(node, 'rb').read())
    data[100] ^= 4
    open(node, 'wb').write(bytes(data))
    with pytest.raises(ValueError, match='CRC-32C'):
        OcdbtStore(step)


def test_zarr_chunk_grids_absent_chunks_and_dtypes(tmp_path):
    base = {'driver': 'ocdbt', 'base': 'file://' + str(tmp_path) + '/'}
    rs = np.random.RandomState(6)
    arrays = {}
    for name, dtype, shape, chunks, comp in (
            ('f4.grid', '<f4', [10, 12], [3, 5], {'id': 'zstd', 'level': 3}),
            ('f2.raw', '<f2', [7], [3], None),
            ('i8.grid', '<i8', [4, 5, 6], [2, 5, 4], {'id': 'zstd', 'level': 1}),
            ('i4.scalar', '<i4', [], [], {'id': 'zstd', 'level': 1}),
            ('b1', '|b1', [9], [4], {'id': 'zstd', 'level': 1}),
            ('bf16.grid', 'bfloat16', [6, 4], [4, 4], {'id': 'zstd', 'level': 1})):
        spec = {'driver': 'zarr', 'kvstore': base, 'path': name,
                'metadata': {'shape': shape, 'chunks': chunks, 'dtype': dtype,
                             'compressor': comp,
                             'fill_value': 0 if name == 'f4.grid' else None}}
        arr = ts.open(spec, create=True).result()
        if dtype == 'bfloat16':
            value = rs.standard_normal(shape).astype(np.float32)
            arr.write(value.astype(arr.dtype.numpy_dtype)).result()
            value = np.asarray(arr.read().result()).astype(np.float32)
        elif dtype == '|b1':
            value = rs.rand(*shape) > 0.5
            arr.write(value).result()
        else:
            value = (rs.standard_normal(shape) * 100).astype(dtype)
            if name == 'f4.grid':
                value[3:6, :5] = 0   # tensorstore leaves an all-fill chunk absent
            arr.write(value).result()
        arrays[name] = value
    store = OcdbtStore(str(tmp_path))
    assert 'f4.grid/1.0' not in store
    for name, value in arrays.items():
        got = OB.read_array(store, name)
        assert got.shape == value.shape
        if name.startswith('bf16'):
            assert got.dtype == np.float32
        np.testing.assert_array_equal(got, value, err_msg=name)


# -- the tree ------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['ab', 'nb'])
def test_demo_leaves_equal_jax_restore(name):
    want, got = JCK.restore(DEMOS[name]), OB.restore_orbax(DEMOS[name])
    _same_tree(want['payload'], got['payload'])
    assert (got['meta'], got['step']) == (want['meta'], want['step'])
    # the digests chip_smoke.py holds the card's reading against
    digest, n, nbytes = OB.leaves_digest(jax.tree_util.tree_map(np.asarray, want['payload']))
    assert chip_smoke.ORBAX_DEMO_DIGESTS[name] == (digest, n, nbytes)
    assert OB.leaves_digest(got['payload']) == (digest, n, nbytes)


@pytest.mark.parametrize('name', ['ab', 'nb'])
def test_full_width_leaves_and_optimizer_state_equal_jax_restore(jax_full_ckpts, name):
    want = JCK.restore(jax_full_ckpts[name])
    got = CK.restore(jax_full_ckpts[name])
    assert got['format'] == 'orbax' and got['kind'] == ('pair' if name == 'ab' else 'heavy')
    _same_tree(want['payload'], OB.restore_orbax(jax_full_ckpts[name])['payload'])
    (want_adam,), (got_adam,) = (CK._adam_states(want['payload']['opt_state']),
                                 CK._adam_states(got['payload']['opt_state']))
    assert int(want_adam['count']) == int(got_adam['count'])
    assert got['meta']['opt_steps'] == 14 and CK.latest_step(jax_full_ckpts[name]) == 7


def test_layout_marker(tmp_path):
    run = str(tmp_path / 'run')
    shutil.copytree(DEMOS['nb'], run)
    os.remove(os.path.join(run, '.qkv_layout'))
    OB.restore_orbax(run)           # no marker: head-major, as JAX's save leaves it
    with open(os.path.join(run, '.qkv_layout'), 'w') as f:
        f.write('part-major\n')
    with pytest.raises(ValueError, match='hudiff_tpu_torch.tools.migrate_qkv_layout'):
        OB.restore_orbax(run)
    with pytest.raises(ValueError, match='migrate_qkv_layout'):
        H.load_denoiser(run, 'heavy', device='cpu', use_bf16=False)


# -- the model -----------------------------------------------------------------------

def _demo_logits_jax(name, rs, B=3):
    kind = 'pair' if name == 'ab' else 'heavy'
    model, variables, finetuned = JH.load_denoiser(DEMOS[name], kind, use_bf16=False)
    if name == 'ab':
        inputs = (rs.randint(0, C.N_TOKENS, (B, C.PAIR_LEN)), np.tile(REGION, (B, 1)),
                  np.asarray([[0, 1], [0, 2], [0, 1]]))
    else:
        inputs = (rs.randint(0, C.N_TOKENS, (B, C.HEAVY_LEN)),
                  np.tile(C.HEAVY_REGION_INDEX, (B, 1)))
    return inputs, np.asarray(model.apply(variables, *map(jnp.asarray, inputs))), finetuned


@pytest.mark.parametrize('name', ['ab', 'nb'])
def test_load_denoiser_on_the_demos_gives_jax_logits(name):
    inputs, ref, finetuned = _demo_logits_jax(name, np.random.RandomState(8))
    kind = 'pair' if name == 'ab' else 'heavy'
    model, found = H.load_denoiser(DEMOS[name], kind, device='cpu', use_bf16=False)
    assert found is finetuned
    with torch.no_grad():
        out = model(*(torch.from_numpy(np.asarray(a)).long() for a in inputs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match='holds a'):
        H.load_denoiser(DEMOS[name], 'heavy' if name == 'ab' else 'pair', device='cpu')


def test_api_humanize_pair_on_the_demo():
    cands = api.humanize_pair(H1, L1, DEMOS['ab'], n=2, batch_size=2, use_bf16=False,
                              device='cpu')
    assert 1 <= len(cands) <= 2 and len(set(cands)) == len(cands)
    grid = H.pair_input(H1, L1)['clean']
    ids = np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX])
    for h, l in cands:
        # only frameworks are sampled: each parental CDR is there, in order
        for seq, sl in ((h, slice(0, C.HEAVY_LEN)), (l, slice(C.HEAVY_LEN, None))):
            rest = seq
            for k in np.unique(ids[sl][ids[sl] != 0]):
                cdr = ''.join(C.TOKENS[t] for t in grid[sl][ids[sl] == k] if t != C.IDX_PAD)
                assert cdr in rest, cdr
                rest = rest[rest.index(cdr) + len(cdr):]
            assert set(seq) <= set(C.TOKENS[:20])


_BLOCKED = r'''
import json, sys
for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tensorstore', 'zstandard'):
    sys.modules[name] = None          # any import of these raises ImportError
import hudiff_tpu_torch
from hudiff_tpu_torch.training import orbax as OB
out = {}
for name in ('ab', 'nb'):
    r = OB.restore_orbax('examples/demo_%s_tiny' % name)
    out[name] = list(OB.leaves_digest(r['payload']))
from hudiff_tpu_torch.sampling import humanize as H
H.load_denoiser('examples/demo_nb_tiny', 'heavy', device='cpu', use_bf16=False)
print(json.dumps(out))
'''


def test_reader_runs_with_jax_orbax_tensorstore_and_zstandard_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _BLOCKED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(proc.stdout.splitlines()[-1])
    for name in ('ab', 'nb'):
        assert tuple(got[name]) == chip_smoke.ORBAX_DEMO_DIGESTS[name]


# -- resume --------------------------------------------------------------------------

def _jax_run(tmp_path):
    """A test-size JAX pretraining state one Adam step in, saved by JAX's
    ``save`` with pretraining's metadata; (run dir, cfg, params, opt_state,
    tx)."""
    cfg = j_load_yaml(os.path.join(REPO, 'configs', 'antibody_test.yml'))
    jcfg = JCfg.from_dict(dict(cfg.model))
    params = JAnti(jcfg).init(jax.random.PRNGKey(3), jnp.zeros((1, C.PAIR_LEN), jnp.int32),
                              jnp.asarray(REGION[None]), jnp.zeros((1, 2), jnp.int32))
    tx = JS.make_optimizer(cfg.train.optimizer, clip_norm=cfg.train.clip_norm)
    opt_state = tx.init(params)
    rs = np.random.RandomState(9)
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(rs.standard_normal(p.shape),
                                                         p.dtype), params)
    updates, opt_state = tx.update(grads, opt_state, params)
    params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    run = str(tmp_path / 'jax_run')
    plateau = JS.make_host_scheduler(cfg.train.scheduler, init_lr=cfg.train.optimizer.lr)
    plateau.update(5.0)
    plateau.lr = 6e-5
    scheduler = plateau.state_dict()
    JCK.save(run, 1, params, opt_state, config={'model': dict(cfg.model),
                                                'train': cfg.train.to_dict(), 'kind': 'pair'},
             extra={'val_loss': 5.0, 'opt_steps': 2, 'scheduler': scheduler})
    return run, cfg, params, opt_state, tx


def test_resume_continues_a_jax_run_with_its_adam_moments(tmp_path):
    run, jcfg, params, opt_state, tx = _jax_run(tmp_path)
    cfg = load_yaml(os.path.join(REPO, 'configs', 'antibody_test.yml'))
    model = AntiTFNet(DenoiserConfig.from_dict(dict(cfg.model)), device='cpu')
    optimizer = S.make_optimizer(cfg.train.optimizer, model.parameters())
    restored = CK.restore(run)
    model.load_state_dict(restored['payload']['model'])
    optimizer.load_state_dict(CK.optimizer_state(restored['payload'], model, optimizer))
    adam = opt_state[1].inner_state[0]
    mu = CK.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, adam.mu), model.cfg)
    for name, p in model.named_parameters():
        st_ = optimizer.state[p]
        assert float(st_['step']) == int(adam.count) == 1
        np.testing.assert_array_equal(st_['exp_avg'].numpy(), mu[name].numpy(), err_msg=name)

    # the next update: the same gradient through optax and the port's Adam
    rs = np.random.RandomState(10)
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(rs.standard_normal(p.shape),
                                                         p.dtype), params)
    updates, _ = tx.update(grads, opt_state, params)
    want = CK.flax_to_state_dict(jax.tree_util.tree_map(
        lambda p, u: np.asarray(p + u), params, updates), model.cfg)
    g = CK.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads), model.cfg)
    for name, p in model.named_parameters():
        p.grad = g[name].clone()
    S.clip_gradients(list(model.parameters()), cfg.train.clip_norm)
    optimizer.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)

    # the CLI's resume: opt_steps, the scheduler and the best val loss
    logdir = str(tmp_path / 'logs')
    run_dir = PT.run(cfg, kind='pair', logdir=logdir, synthetic=16, max_iter=2,
                     valid_step=2, resume=run, device='cpu', use_bf16=False)
    log = open(os.path.join(run_dir, 'log.txt')).read()
    assert 'resumed from' in log and 'at step 1 (lr 6e-05, best val 5.00000)' in log
    rows = [json.loads(x) for x in open(os.path.join(run_dir, 'metrics.jsonl'))]
    assert {r['step'] for r in rows} == {2}    # one iteration after the JAX run's first


# -- the .qkv_layout finding in the reference -----------------------------------------

def test_reference_migrate_tool_permutes_a_fresh_head_major_dir_again(tmp_path):
    """JAX's ``save`` writes no ``.qkv_layout`` marker and its migrate tool
    reads a missing marker as legacy, so a fresh head-major run directory is
    permuted a second time and its logits change. The port reads a missing
    marker as head-major: its logits stay the demo's."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    import migrate_qkv_layout as JMIG
    run = str(tmp_path / 'fresh')
    shutil.copytree(DEMOS['ab'], run)
    os.remove(os.path.join(run, '.qkv_layout'))   # as JAX's save leaves a run dir
    rs = np.random.RandomState(11)
    inputs, before, _ = _demo_logits_jax('ab', rs)
    model, found = H.load_denoiser(run, 'pair', device='cpu', use_bf16=False)
    with torch.no_grad():
        port = model(*(torch.from_numpy(np.asarray(a)).long() for a in inputs)).numpy()
    np.testing.assert_allclose(port, before, rtol=0, atol=1e-4)
    JMIG.migrate_ckpt_dir(run)
    jm, variables, _ = JH.load_denoiser(run, 'pair', use_bf16=False)
    after = np.asarray(jm.apply(variables, *map(jnp.asarray, inputs)))
    assert np.abs(after - before).max() > 1e-2
