"""The port's HuDiff-Nb path (``NanoAntiTFNet``, ``NanoSideEmbedder``, the
heavy train and eval steps, ``nano_input``, ``NanoHumanizer``, the ``nano``
CLI and ``pretrain --kind heavy``) against the JAX package, on the CPU.

Weights are drawn with numpy from a seed into the Flax parameter tree's
shapes (or restored from the in-repo demo checkpoint
examples/demo_nb_tiny) and carried across by
``checkpoints.from_flax_params``; inputs are drawn with numpy likewise.
Both packages run f32, the port through the plain versions of its kernels.
Tolerances: logits atol 1e-5 at test size, 1e-4 at full width (6 + 6
ByteNet blocks and 10 attentions at 512, summed in other orders), and on
the demo checkpoint 3e-5: its trained weights carry the logits to 8.6,
and f32 rounding in other orders grows with them, stage by stage (1.5e-6
after the aa tower, 4.5e-6 after nano_conv, 1.27e-5 on the logits);
NanoSideEmbedder 1e-6; the heavy train step's loss 1e-5
relative and every gradient max |err| <= 1e-5 max |ref|; Adam against
optax 1e-6 (atol); the eval step's metrics 1e-5. ``nano_input`` must give
the JAX package's arrays exactly. Sampled tokens come from other random
numbers than JAX's, so humanization is held to invariants only.
"""
import csv
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hudiff_tpu.models import embedders as JE
from hudiff_tpu.models.denoiser import NanoAntiTFNet as JNano
from hudiff_tpu.models.denoiser import nano_config as j_nano_config
from hudiff_tpu.ops import losses as JL
from hudiff_tpu.sampling import humanize as JH
from hudiff_tpu.training import schedules as JS
from hudiff_tpu.utils.config import load_yaml as j_load_yaml
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.models import embedders as E
from hudiff_tpu_torch.models.denoiser import DenoiserConfig, NanoAntiTFNet, nano_config
from hudiff_tpu_torch.numbering import align as AL
from hudiff_tpu_torch.ops import masking as M
from hudiff_tpu_torch.sampling import humanize as H
from hudiff_tpu_torch.training import checkpoints as CK
from hudiff_tpu_torch.training import pretrain as PT
from hudiff_tpu_torch.training import schedules as S
from hudiff_tpu_torch.training import train_step as T
from hudiff_tpu_torch.utils.config import load_yaml

# f32 is compared: no TF32 in matmuls or convolutions (a card would use it)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAVY_TEST = os.path.join(REPO, 'configs', 'heavy_test.yml')
# the VHHs of tests/test_cli.py and tests/test_numbering.py
VHH1 = ('QVQLVESGGGLVQAGGSLRLSCAASGRTFSSYAMGWFRQAPGKEREFVAAISWSGGSTYYADSVKGRF'
        'TISRDNAKNTVYLQMNSLKPEDTAVYYCAADRGSYYYTRNQYDYWGQGTQVTVSS')
VHH2 = ('QVQLVESGGGSVQAGGSLVLSCAASGYTYTAGCMGWFRQTPGKEREGVAAIDSDGSTAYADSVKGRF'
        'TISRDNDKNMVYLQMNSLKPEDTAMYYCAAASRCGLGTVREYRFWGQGTQVTVSS')
LIGHT = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
         'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')
CDR = C.HEAVY_CDR_INDEX != 0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several xdist workers
    at once, and torch's default of a thread per core oversubscribes the
    cores, which slows these many small ops several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, seed):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, C.N_TOKENS, (B, C.HEAVY_LEN)).astype(np.int32)
    region = np.tile(C.HEAVY_REGION_INDEX, (B, 1)).astype(np.int32)
    return tokens, region


def _leaf(rs):
    def leaf(path, s):
        name = path[-1].key
        if name == 'scale':
            v = 1 + 0.1 * rs.randn(*s.shape)
        elif name == 'bias':
            v = 0.1 * rs.randn(*s.shape)
        elif name == 'embedding':
            v = rs.randn(*s.shape)
        else:  # kernel: [in, out] or [K, in, out]
            v = rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return v.astype(np.float32)
    return leaf


def _random_tree(jcfg, seed):
    """Numpy weights in the shapes of ``NanoAntiTFNet(jcfg).init``'s tree."""
    shapes = jax.eval_shape(JNano(jcfg).init, jax.random.PRNGKey(0), *_inputs(1, 0))
    return jax.tree_util.tree_map_with_path(_leaf(np.random.RandomState(seed)), shapes)


def _port_cfg(jcfg):
    return DenoiserConfig(**dataclasses.asdict(jcfg))


def _logits(model, tokens, region):
    with torch.no_grad():
        return model(torch.from_numpy(tokens).long(), torch.from_numpy(region).long()).numpy()


def _check_parity(jcfg, tree, B, seed, atol):
    tokens, region = _inputs(B, seed)
    ref = np.asarray(JNano(jcfg).apply(tree, tokens, region))
    model = CK.from_flax_params(tree, _port_cfg(jcfg), device='cpu')
    assert isinstance(model, NanoAntiTFNet)
    out = _logits(model, tokens, region)
    assert out.shape == (B, C.HEAVY_LEN, C.N_TOKENS) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)


@pytest.fixture(scope='module')
def small():
    jcfg = j_nano_config().test_size()
    return jcfg, _random_tree(jcfg, 1)


# -- the model -------------------------------------------------------------------

def test_nano_config_matches_jax():
    assert dataclasses.asdict(nano_config()) == dataclasses.asdict(j_nano_config())
    assert dataclasses.asdict(nano_config().test_size()) == dataclasses.asdict(
        j_nano_config().test_size())
    assert nano_config(dropout=0.1).dropout == 0.1


def test_nano_antitfnet_matches_test_size(small):
    jcfg, tree = small
    _check_parity(jcfg, tree, B=3, seed=7, atol=1e-5)


def test_nano_antitfnet_matches_full_width():
    """configs/heavy_train.yml: an aa tower 256/128 GELU, nano_conv 512/256
    GELU, 5 attention blocks of 8 x 64 at d_model 512, L = 152."""
    jcfg = j_nano_config()
    _check_parity(jcfg, _random_tree(jcfg, 2), B=1, seed=8, atol=1e-4)


def _demo_tree():
    from hudiff_tpu.training.checkpoints import restore
    restored = restore(os.path.join(REPO, 'examples', 'demo_nb_tiny'))
    assert restored['meta']['config']['kind'] == 'heavy'
    jcfg = j_nano_config().from_dict(restored['meta']['config']['model'])
    tree = jax.tree_util.tree_map(np.asarray, restored['payload']['params'])
    return jcfg, tree if 'params' in tree else {'params': tree}


def test_nano_antitfnet_matches_demo_checkpoint():
    jcfg, tree = _demo_tree()
    _check_parity(jcfg, tree, B=2, seed=9, atol=3e-5)


def test_nano_side_embedder_matches():
    mod = JE.NanoSideEmbedder(3, 4, 64, C.HEAVY_LEN)
    chain = np.array([0, 2, 1], np.int32)
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), chain)
    tree = jax.tree_util.tree_map_with_path(_leaf(np.random.RandomState(3)), shapes)
    ref = np.asarray(mod.apply(tree, chain))
    port = E.NanoSideEmbedder(3, 4, 64, C.HEAVY_LEN)
    sd = {}
    CK._named('', tree['params'], CK._SIDE, sd)
    port.load_state_dict({k[1:]: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(chain).long()).numpy()
    assert out.shape == ref.shape == (3, C.HEAVY_LEN, 64)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_port_checkpoint_keeps_the_kind(small, tmp_path):
    jcfg, tree = small
    model = CK.from_flax_params(tree, _port_cfg(jcfg), device='cpu')
    path = CK.save(str(tmp_path / 'nb.pt'), model, _port_cfg(jcfg))
    loaded, config = CK.load(path, device='cpu')
    assert config['kind'] == 'heavy' and isinstance(loaded, NanoAntiTFNet)
    args = _inputs(2, 10)
    np.testing.assert_array_equal(_logits(loaded, *args), _logits(model, *args))
    # a file written before the kind existed is a pair checkpoint
    payload = torch.load(path, weights_only=True)
    del payload['config']['kind']
    torch.save(payload, path)
    with pytest.raises(RuntimeError, match='state_dict'):
        CK.load(path, device='cpu')
    with pytest.raises(ValueError, match="'heavy' model, not a 'pair'"):
        H.load_denoiser(CK.save(str(tmp_path / 'nb2.pt'), model, _port_cfg(jcfg)),
                        device='cpu', kind='pair')


# -- the heavy train and eval steps ------------------------------------------------

class _Capture(torch.optim.Optimizer):
    """Keeps the gradients it is stepped with and changes nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = None

    def step(self, closure=None):
        self.grads = [p.grad.clone() for g in self.param_groups for p in g['params']]


def _heavy_batch(B, seed):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, C.N_AA, (B, C.HEAVY_LEN))
    cdr = np.broadcast_to(CDR, tokens.shape)
    mask = (rs.rand(B, C.HEAVY_LEN) < np.linspace(0.2, 0.9, B)[:, None]) & ~cdr
    return tokens, mask, np.where(mask, C.IDX_MSK, tokens), cdr


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_heavy_train_step_matches_jax():
    cfg = load_yaml(HEAVY_TEST)
    jcfg = j_nano_config().from_dict(cfg.model)
    tree = _random_tree(jcfg, 4)
    tokens, mask, src, cdr = _heavy_batch(2, 5)
    region = np.broadcast_to(C.HEAVY_REGION_INDEX, tokens.shape)

    def loss_fn(params):   # hudiff_tpu/training/train_step.py:120-125, dropout off
        m = JL.heavy_oardm_loss(JNano(jcfg).apply(params, src, region), tokens, mask, cdr)
        return m['ce'] + m['cdr_ce']

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    model = CK.from_flax_params(tree, _port_cfg(jcfg), device='cpu')   # eval(): no dropout
    state = T.TrainState(model, _Capture(model.parameters()))
    m = T.make_heavy_train_step(model)(state, _t(tokens), 0,
                                       M.Corrupted(_t(src), _t(mask), _t(mask.sum(-1))))
    assert state.step == 1
    np.testing.assert_allclose(m['loss'].item(), float(ref_loss), rtol=1e-5)
    ref = CK.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_grads), _port_cfg(jcfg))
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, got in zip(names, state.optimizer.grads):
        r = ref[name].numpy()
        err = np.abs(got.numpy() - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= 1e-5, f'{name}: {err}'


def test_heavy_adam_steps_match_optax(small):
    """configs/heavy_train.yml's optimizer (Adam, beta1 0.95, clip 10) over
    the nano tree: the same gradients, two steps, both packages."""
    jcfg, tree = small
    opt_cfg = load_yaml(os.path.join(REPO, 'configs', 'heavy_train.yml')).train
    tx = JS.make_optimizer(j_load_yaml(os.path.join(REPO, 'configs', 'heavy_train.yml'))
                           .train.optimizer, clip_norm=opt_cfg.clip_norm)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(params)
    model = CK.from_flax_params(tree, _port_cfg(jcfg), device='cpu')
    state = T.TrainState(model, S.make_optimizer(opt_cfg.optimizer, model.parameters()),
                         clip_norm=opt_cfg.clip_norm)
    rs = np.random.RandomState(6)
    for _ in range(2):
        grads = jax.tree_util.tree_map(lambda x: (3 * rs.randn(*x.shape)).astype(np.float32),
                                       tree)
        upd, opt_state = jax.jit(tx.update)(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
        g = CK.flax_to_state_dict(grads, _port_cfg(jcfg))
        for n, p in model.named_parameters():
            p.grad = g[n].clone()
        state.apply_gradients()
    ref = CK.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params), _port_cfg(jcfg))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)


def test_heavy_eval_step_matches_jax(small, monkeypatch):
    """The eval step's draws come from torch; the mask the JAX side is
    given is the one the port's step drew."""
    jcfg, tree = small
    tokens, _, _, cdr = _heavy_batch(3, 11)
    model = CK.from_flax_params(tree, _port_cfg(jcfg), device='cpu')
    drawn, draw = [], M.corrupt

    def corrupt(gen, tok, protected):
        drawn.append(draw(gen, tok, protected))
        return drawn[-1]

    monkeypatch.setattr(T.masking, 'corrupt', corrupt)
    model.train()
    got = T.make_eval_step(model, pair=False)(_t(tokens), None, T.generator('cpu', 1, 2))
    assert model.training   # the mode is restored
    cor = drawn[0]
    region = np.broadcast_to(C.HEAVY_REGION_INDEX, tokens.shape)
    logits = JNano(jcfg).apply(tree, cor.src.numpy(), region)
    ref = JL.heavy_oardm_loss(logits, tokens, cor.mask.numpy(), cdr)
    ref['loss'] = ref['ce'] + ref['cdr_ce']
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5, err_msg=k)


# -- host prep ----------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['FR', 'finetune', 'inpaint'])
@pytest.mark.parametrize('vhh', [VHH1, VHH2])
def test_nano_input_matches(vhh, mode):
    kw = dict(finetune=mode == 'finetune', inpaint=mode == 'inpaint')
    got, ref = H.nano_input(vhh, **kw), JH.nano_input(vhh, **kw)
    assert got is not None and set(got) == set(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key
    assert len(got['positions']) == {'FR': 93, 'inpaint': 87}.get(mode, len(got['positions']))


def test_nano_input_rejects_like_jax():
    for seq in (LIGHT, 123, VHH1[:30], ''):
        assert H.nano_input(seq) is None and JH.nano_input(seq) is None
    for seq in (VHH1, LIGHT, 123, ''):
        assert H._is_heavy_type(seq) == JH._is_heavy_type(seq)


# -- humanization on the CPU ------------------------------------------------------------

@pytest.fixture(scope='module')
def demo_ckpt(tmp_path_factory):
    """examples/demo_nb_tiny restored through the JAX package and exported
    as a port checkpoint."""
    jcfg, tree = _demo_tree()
    path = str(tmp_path_factory.mktemp('port_nb_ckpt') / 'demo_nb_tiny.pt')
    return CK.save(path, CK.from_flax_params(tree, _port_cfg(jcfg), device='cpu'),
                   _port_cfg(jcfg))


def test_nano_entry_points_raise_without_a_card(demo_ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        H.load_denoiser(demo_ckpt, kind='heavy')
    model, _ = H.load_denoiser(demo_ckpt, device='cpu', use_bf16=False, kind='heavy')
    with pytest.raises(RuntimeError, match='CUDA'):
        H.NanoHumanizer(model)
    with pytest.raises(RuntimeError, match='CUDA'):
        H.main(['nano', '--ckpt', demo_ckpt, '--vhh-seq', VHH1,
                '--logdir', str(tmp_path)])
    with pytest.raises(RuntimeError, match='CUDA'):
        CK.from_flax_params(_demo_tree()[1], nano_config().test_size())
    with pytest.raises(RuntimeError, match='CUDA'):
        PT.run(load_yaml(HEAVY_TEST), kind='heavy', synthetic=32, logdir=str(tmp_path))


def _check_rows(inp, grids):
    """Only the ordered slots change: CDRs and unmasked slots keep the
    input's residues, and no masked slot is left."""
    keep = inp['tokens'] != C.IDX_MSK
    assert (grids != C.IDX_MSK).all() and (grids < C.N_TOKENS - 1).all()
    np.testing.assert_array_equal(grids[:, CDR], np.broadcast_to(inp['clean'][CDR],
                                                                 (len(grids), CDR.sum())))
    np.testing.assert_array_equal(grids[:, keep], np.broadcast_to(inp['tokens'][keep],
                                                                  (len(grids), keep.sum())))


def test_nano_humanize_many_invariants(demo_ckpt):
    """An FR row (93 slots) and an inpainting row (87) share rounds of width
    93: the inpainting rows' -1 pads are no-ops. Every returned sequence
    aligns as a heavy chain."""
    model, finetuned = H.load_denoiser(demo_ckpt, device='cpu', use_bf16=False, kind='heavy')
    assert not finetuned and isinstance(model, NanoAntiTFNet)
    hum = H.NanoHumanizer(model, batch_size=2, seed=7, device='cpu', device_batch=4)
    inputs = [H.nano_input(VHH1), H.nano_input(VHH2, inpaint=True), None]
    assert H._packed_pad_to(inputs) == 93
    results = hum.humanize_many(inputs, rows_per_input=2)
    assert results[2] is None and hum.filter_s > 0
    for inp, res in zip(inputs[:2], results[:2]):
        assert res is not None and 1 <= len(res['seqs']) <= 2
        _check_rows(inp, res['grids'])
        for seq in res['seqs']:
            assert AL.align_to_aho(seq, 'H') is not None
        assert res['best'] == res['seqs'][res['best_idx']]


def test_nano_humanizer_call(demo_ckpt):
    model, _ = H.load_denoiser(demo_ckpt, device='cpu', use_bf16=False, kind='heavy')
    hum = H.NanoHumanizer(model, batch_size=3, seed=1, device='cpu')
    res = hum(VHH2, finetune=True)
    inp = H.nano_input(VHH2, finetune=True)
    assert res is not None and len(res['grids']) <= 3
    _check_rows(inp, res['grids'])
    assert hum(LIGHT) is None


def _cdr_strings(grid_row):
    ids = C.HEAVY_CDR_INDEX
    return [''.join(C.TOKENS[t] for t in grid_row[ids == k] if t != C.IDX_PAD)
            for k in np.unique(ids[ids != 0])]


def _csv_rows(path):
    with open(path, newline='') as f:
        return list(csv.DictReader(f))


def _nano_cli(demo_ckpt, tmp_path, *extra):
    return H.main(['nano', '--ckpt', demo_ckpt, '--device', 'cpu', '--fp32',
                   '--batch-size', '2', '--pack-size', '4', '--max-retry', '2',
                   '--logdir', str(tmp_path / 'logs'), *extra])


def _assert_humanized(rows, names_seqs):
    assert [r['Specific'] for r in rows] == ['camel', 'humanization'] * len(names_seqs)
    for (name, seq), parent, hum in zip(names_seqs, rows[0::2], rows[1::2]):
        assert parent['name'] == name and parent['vhh_seq'] == seq
        assert hum['name'] == f'{name}human_sample'
        for cdr in _cdr_strings(H.nano_input(seq)['clean']):
            assert cdr in hum['vhh_seq']


def test_cli_nano_vhh_seq(demo_ckpt, tmp_path):
    out = _nano_cli(demo_ckpt, tmp_path, '--vhh-seq', VHH1, '--sample-method', 'inpaint')
    _assert_humanized(_csv_rows(out), [('input', VHH1)])


def test_cli_nano_fasta_skips_a_light_first_record(demo_ckpt, tmp_path):
    fasta = tmp_path / 'complex.fasta'
    fasta.write_text(f'>chainL light\n{LIGHT}\n>nb1 VHH\n{VHH2}\n')
    out = _nano_cli(demo_ckpt, tmp_path, '--fasta', str(fasta))
    _assert_humanized(_csv_rows(out), [('nb1', VHH2)])
    fasta.write_text(f'>chainL light\n{LIGHT}\n')
    with pytest.raises(SystemExit, match='no heavy-type record'):
        _nano_cli(demo_ckpt, tmp_path, '--fasta', str(fasta))


def test_cli_nano_data_fpath_packed(demo_ckpt, tmp_path):
    data = tmp_path / 'vhh.csv'
    with open(data, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['id', 'vhhseq'])
        w.writerows([['a', VHH1], ['b', ''], ['c', VHH2]])
    rows = _csv_rows(_nano_cli(demo_ckpt, tmp_path, '--data-fpath', str(data)))
    _assert_humanized(rows, [('0', VHH1), ('2', VHH2)])


# -- pretrain --kind heavy -----------------------------------------------------------------

def test_pretrain_cli_heavy(tmp_path):
    """configs/heavy_test.yml (the kind from its name) at batch 4: two
    iterations of two steps, validations at both, a best-val checkpoint
    whose kind is heavy and that ``load`` restores as NanoAntiTFNet."""
    cfg = load_yaml(HEAVY_TEST).to_dict()
    cfg['train']['batch_size'] = 4
    path = tmp_path / 'heavy_test_b4.yml'
    path.write_text(json.dumps(cfg))   # JSON is YAML
    PT.main(['--config', str(path), '--synthetic', '8', '--device', 'cpu', '--fp32',
             '--max-iter', '2', '--logdir', str(tmp_path)])
    run_dir, = glob.glob(str(tmp_path / 'heavy_pretrain*'))
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if 'train/loss' in r]
    assert [int(r['train/opt_steps']) for r in train] == [2, 4]
    assert all(np.isfinite(r['train/loss']) for r in train)
    assert [r['step'] for r in rows if 'val/loss' in r] == [2]
    ckpt = os.path.join(run_dir, 'checkpoints')
    restored = CK.restore(ckpt)
    assert restored['kind'] == 'heavy' and restored['meta']['config']['kind'] == 'heavy'
    model, config = CK.load(os.path.join(ckpt, f"step_{restored['step']}.pt"), device='cpu')
    assert isinstance(model, NanoAntiTFNet) and config['kind'] == 'heavy'
    assert DenoiserConfig.from_dict(config['model']) == DenoiserConfig.from_dict(cfg['model'])
    fresh = NanoAntiTFNet(model.cfg)
    fresh.load_state_dict(restored['payload']['model'])
    args = _inputs(2, 12)
    np.testing.assert_array_equal(_logits(fresh.eval(), *args), _logits(model, *args))
    # resuming into the other kind is refused
    pair_cfg = load_yaml(os.path.join(REPO, 'configs', 'antibody_test.yml'))
    with pytest.raises(ValueError, match="'heavy' model, not 'pair'"):
        PT.run(pair_cfg, kind='pair', synthetic=8, max_iter=1, logdir=str(tmp_path / 'p'),
               resume=ckpt, device='cpu', use_bf16=False)
