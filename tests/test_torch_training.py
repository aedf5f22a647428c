"""Port pretraining (hudiff_tpu_torch/training/, data/pipeline.py,
utils/config.py) against the JAX package.

- The optimizer: the same numpy gradients fed for three steps to the JAX
  ``make_optimizer`` (optax, clip 10) and the port's (torch.optim, clip
  first); parameters agree to 1e-6 (atol; Adam's update is sign-like, so
  the error is the f32 rounding of the few ops per step).
- The host schedulers: the same lr sequences from the same val losses.
- One test-size pair train step (configs/antibody_test.yml widths, dropout
  off, the same fixed mask fed to both) against the JAX step's loss
  function under ``jax.value_and_grad``: the loss to 1e-5 relative and
  every gradient, carried across by ``flax_to_state_dict``, to max |err|
  <= 1e-5 max |ref| (f32 through 6 ByteNet blocks, 2 attentions and the
  decoder, summed in other orders; the largest reading is 1.1e-6).
- The port's ``pretrain`` CLI at test size on the CPU: the iteration
  semantics, best-val checkpoint selection and resume, as
  tests/test_training_discipline.py checks them for the JAX CLI.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hudiff_tpu.models.denoiser import AntiTFNet as JNet
from hudiff_tpu.models.denoiser import DenoiserConfig as JCfg
from hudiff_tpu.ops import losses as JL
from hudiff_tpu.training import schedules as JS
from hudiff_tpu.utils.config import Namespace as JNamespace
from hudiff_tpu.utils.config import load_yaml as j_load_yaml
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.data import pipeline
from hudiff_tpu_torch.models.denoiser import AntiTFNet, DenoiserConfig
from hudiff_tpu_torch.ops import masking as M
from hudiff_tpu_torch.training import checkpoints as CK
from hudiff_tpu_torch.training import pretrain as PT
from hudiff_tpu_torch.training import schedules as S
from hudiff_tpu_torch.training import train_step as T
from hudiff_tpu_torch.utils.config import Namespace, load_yaml

# f32 is compared: no TF32 in matmuls or convolutions (a card would use it)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_CFG = os.path.join(REPO, 'configs', 'antibody_test.yml')


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several xdist workers
    at once, and torch's default of a thread per core oversubscribes the
    cores, which slows these many small ops several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- config -------------------------------------------------------------------

def test_load_yaml_matches_jax():
    for name in ('antibody_test.yml', 'antibody_train.yml'):
        path = os.path.join(REPO, 'configs', name)
        port, ref = load_yaml(path), j_load_yaml(path)
        assert port.to_dict() == ref.to_dict()
        assert port.train.optimizer.lr == ref.train.optimizer.lr


# -- optimizer and schedulers ---------------------------------------------------

@pytest.mark.parametrize('kind,wd', [('Adam', 1e-4), ('Adam', 0.0), ('AdamW', 1e-2)])
def test_optimizer_matches_optax(kind, wd):
    rs = np.random.RandomState(7)
    shapes = [(5, 3), (3,), (2, 4, 2)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(4 * rs.randn(*s)).astype(np.float32) for s in shapes] for _ in range(3)]
    opt_cfg = dict(type=kind, lr=1e-2, weight_decay=wd, beta1=0.95, beta2=0.999)
    tx = JS.make_optimizer(JNamespace.wrap(opt_cfg), clip_norm=10)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = S.make_optimizer(Namespace.wrap(opt_cfg), tp)
    for i, g in enumerate(grads):
        if i == 2:   # the host scheduler's hand-off, mid-run
            JS.set_learning_rate(state, 5e-3)
            S.set_learning_rate(opt, 5e-3)
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        S.clip_gradients(tp, 10)
        opt.step()
    assert S.get_learning_rate(opt) == pytest.approx(JS.get_learning_rate(state))
    for p, r in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=0, atol=1e-6)


def test_schedulers_match():
    vals = [1.0, 0.9, 0.95, 0.97, 0.99, 0.8, 0.85, 0.86, 0.87, 0.88, 0.7, 0.75, 0.76, 0.77]
    sched_cfg = dict(type='plateau', factor=0.5, patience=2, min_lr=1e-6, multiplier=10,
                     total_epoch=3)
    a = S.make_host_scheduler(Namespace.wrap(sched_cfg), 1e-4)
    b = JS.make_host_scheduler(JNamespace.wrap(sched_cfg), 1e-4)
    c = S.CosineAnnealing(init_lr=1e-3, t_max=7, eta_min=1e-5)
    d = JS.CosineAnnealing(init_lr=1e-3, t_max=7, eta_min=1e-5)
    for v in vals:
        assert a.update(v) == b.update(v)
        assert c.update(v) == d.update(v)
    assert a.state_dict() == b.state_dict() and c.state_dict() == d.state_dict()
    poly, jpoly = (m.warmup_poly_schedule(1e-5, 1e-3, 2e-5, 10, 50) for m in (S, JS))
    for step in (0, 3, 9, 10, 11, 30, 49, 50, 80):
        assert poly(step) == pytest.approx(float(jpoly(step)), rel=1e-6)


# -- one train step against the JAX step ---------------------------------------

def _random_tree(jcfg, seed):
    """Numpy weights in the shapes of ``AntiTFNet(jcfg).init``'s tree."""
    region = np.tile(np.concatenate([C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]), (1, 1))
    shapes = jax.eval_shape(JNet(jcfg).init, jax.random.PRNGKey(0),
                            np.zeros((1, C.PAIR_LEN), np.int32), region.astype(np.int32),
                            np.zeros((1, 2), np.int32))
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'scale':
            v = 1 + 0.1 * rs.randn(*s.shape)
        elif name == 'bias':
            v = 0.1 * rs.randn(*s.shape)
        elif name == 'embedding':
            v = rs.randn(*s.shape)
        else:
            v = rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


class _Capture(torch.optim.Optimizer):
    """Keeps the gradients it is stepped with and changes nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = None

    def step(self, closure=None):
        self.grads = [p.grad.clone() for g in self.param_groups for p in g['params']]


@pytest.mark.parametrize('loss_type', ['merge', 'split'])
def test_pair_train_step_matches_jax(loss_type):
    cfg = load_yaml(TEST_CFG)
    jcfg, pcfg = JCfg.from_dict(cfg.model), DenoiserConfig.from_dict(cfg.model)
    tree = _random_tree(jcfg, 1)
    B, l_weight = 2, float(cfg.train.l_loss_weight)
    rs = np.random.RandomState(2)
    tokens = rs.randint(0, C.N_AA, (B, C.PAIR_LEN))
    chain = np.array([[0, 1], [0, 2]])
    cdr = np.broadcast_to(np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX]) != 0,
                          tokens.shape)
    mask = (rs.rand(B, C.PAIR_LEN) < np.array([[0.3], [0.8]])) & ~cdr
    src = np.where(mask, C.IDX_MSK, tokens)
    region = np.broadcast_to(np.concatenate([C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]),
                             tokens.shape)

    def loss_fn(params):   # hudiff_tpu/training/train_step.py:84-96, dropout off
        logits = JNet(jcfg).apply(params, src, region, chain)
        if loss_type == 'split':
            m = JL.pair_oardm_split_loss(logits, tokens, mask, cdr, l_weight=l_weight)
            return m['h_ce'] + m['l_ce'] + m['h_cdr_ce'] + m['l_cdr_ce']
        m = JL.pair_oardm_loss(logits, tokens, mask, cdr)
        return m['ce'] + m['cdr_ce']

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    model = CK.from_flax_params(tree, pcfg, device='cpu')   # eval(): dropout off
    state = T.TrainState(model, _Capture(model.parameters()))
    step = T.make_pair_train_step(model, loss_type=loss_type, l_weight=l_weight)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    m = step(state, t(tokens), t(chain), 0,
             M.Corrupted(t(src), t(mask), t(mask.sum(-1))))
    assert state.step == 1
    np.testing.assert_allclose(m['loss'].item(), float(ref_loss), rtol=1e-5)
    ref = CK.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_grads), pcfg)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, got in zip(names, state.optimizer.grads):
        r = ref[name].numpy()
        err = np.abs(got.numpy() - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= 1e-5, f'{name}: {err}'


def test_train_step_draws_from_seed_and_step():
    """Without a fixed mask the step corrupts with a generator seeded from
    (seed, step): the same seed and step give the same draws, the next step
    others."""
    torch.manual_seed(0)
    model = AntiTFNet(DenoiserConfig().test_size()).eval()
    opt = _Capture(model.parameters())
    state = T.TrainState(model, opt)
    step = T.make_pair_train_step(model)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, C.N_AA, (2, C.PAIR_LEN)))
    chain = torch.tensor([[0, 1], [0, 2]])
    losses = []
    for s in (0, 0, 1):
        state.step = s
        losses.append(step(state, tokens, chain, 5)['loss'].item())
    assert losses[0] == losses[1] != losses[2]
    a = torch.rand(3, generator=T.generator('cpu', 5, 0))
    assert torch.equal(a, torch.rand(3, generator=T.generator('cpu', 5, 0)))
    assert not torch.equal(a, torch.rand(3, generator=T.generator('cpu', 5, 1)))


# -- data pipeline ---------------------------------------------------------------

def test_device_feed_and_prefetch():
    batches = PT.synthetic_batches('pair', 4, seed=1)
    ref = PT.synthetic_batches('pair', 4, seed=1)
    feed = pipeline.device_feed(batches, 'cpu')
    for _ in range(3):
        got, want = next(feed), next(ref)
        assert got['tokens'].dtype == torch.int64 and got['chain_type'].shape == (4, 2)
        np.testing.assert_array_equal(got['tokens'].numpy(), want['tokens'])

    def broken():
        yield {'tokens': np.zeros((1, 2), np.int32)}
        raise ValueError('producer failed')

    feed = pipeline.prefetch(broken())
    next(feed)
    with pytest.raises(ValueError, match='producer failed'):
        next(feed)


# -- checkpoints -----------------------------------------------------------------

def test_entry_points_default_to_the_card(tmp_path):
    """Without a ``device`` the port's entry points ask for CUDA; on a
    machine without a card they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a card: the default is usable here')
    cfg = DenoiserConfig().test_size()
    model = AntiTFNet(cfg)
    tree = {'params': {}}
    with pytest.raises(RuntimeError, match='CUDA'):
        CK.from_flax_params(tree, cfg)
    path = CK.save(str(tmp_path / 'm.pt'), model, cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        CK.load(path)
    with pytest.raises(RuntimeError, match='CUDA'):
        PT.run(load_yaml(TEST_CFG), synthetic=32, logdir=str(tmp_path))
    with pytest.raises(RuntimeError, match='CUDA'):
        PT.main(['--config', TEST_CFG, '--synthetic', '32', '--logdir', str(tmp_path)])


def test_training_checkpoint_roundtrip(tmp_path):
    torch.manual_seed(3)
    cfg = DenoiserConfig().test_size()
    model = AntiTFNet(cfg)
    opt = S.make_optimizer(Namespace.wrap({'lr': 1e-3}), model.parameters())
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    config = {'model': {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}, 'kind': 'pair'}
    path = CK.save_training(str(tmp_path), 7, model, opt, config=config,
                            extra={'val_loss': 1.5, 'opt_steps': 14, 'scheduler': {'lr': 1e-3}})
    assert CK.latest_step(str(tmp_path)) == 7
    os.remove(tmp_path / 'LATEST')
    assert CK.latest_step(str(tmp_path)) == 7
    r = CK.restore(str(tmp_path))
    assert r['step'] == 7 and r['meta']['opt_steps'] == 14 and r['meta']['val_loss'] == 1.5
    assert r['meta']['config'] == json.loads(json.dumps(config))
    for k, v in model.state_dict().items():
        assert torch.equal(r['payload']['model'][k], v), k
    opt2 = S.make_optimizer(Namespace.wrap({'lr': 1e-3}), AntiTFNet(cfg).parameters())
    opt2.load_state_dict(r['payload']['optimizer'])
    assert opt2.state_dict()['state'][0]['step'] == 1
    loaded, lcfg = CK.load(path, device='cpu')   # the sampling loader reads it too
    assert DenoiserConfig.from_dict(lcfg['model']) == cfg
    tokens = torch.zeros(1, C.PAIR_LEN, dtype=torch.long)
    region = torch.from_numpy(T.pair_region_batch(1))
    chain = torch.tensor([[0, 1]])
    with torch.no_grad():
        assert torch.equal(loaded(tokens, region, chain), model.eval()(tokens, region, chain))
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path / 'empty'))


# -- the pretrain CLI --------------------------------------------------------------

def _cli(logdir, *extra):
    """The CLI on configs/antibody_test.yml with batch_size 4 (from 16: the
    same iteration semantics at a quarter of the work; batch_acc stays 2)
    and two validation batches."""
    cfg = load_yaml(TEST_CFG).to_dict()
    cfg['train']['batch_size'] = 4
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, 'antibody_test_b4.yml')
    with open(path, 'w') as f:
        json.dump(cfg, f)   # JSON is YAML
    PT.main(['--config', path, '--synthetic', '8', '--device', 'cpu', '--fp32',
             '--logdir', logdir, *extra])
    return sorted(glob.glob(os.path.join(logdir, '*_pretrain*')))[-1]


def _rows(run_dir, key):
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        return [r for r in map(json.loads, f) if key in r]


def test_pretrain_cli_iterations_and_best_val(tmp_path):
    """antibody_test.yml has batch_acc 2: max-iter 3 runs six optimizer
    steps and logs three train rows, each the window mean; every
    validation that improves on the best so far, and only such a one,
    saves a checkpoint."""
    run_dir = _cli(str(tmp_path), '--max-iter', '3', '--valid-step', '1')
    train = _rows(run_dir, 'train/loss')
    assert [r['step'] for r in train] == [1, 2, 3]
    assert [int(r['train/opt_steps']) for r in train] == [2, 4, 6]
    assert all(np.isfinite(r['train/loss']) and r['train/steps_per_sec'] > 0 for r in train)
    vals = [(r['step'], r['val/loss']) for r in _rows(run_dir, 'val/loss')]
    assert [s for s, _ in vals] == [1, 2, 3]
    saved = {int(os.path.basename(p)[5:-5])
             for p in glob.glob(os.path.join(run_dir, 'checkpoints', 'step_*.json'))}
    best = float('inf')
    for step, loss in vals:
        assert (step in saved) == (loss < best), (step, loss, best)
        best = min(best, loss)
    assert os.path.isdir(os.path.join(run_dir, 'src_snapshot', 'hudiff_tpu_torch'))


def test_pretrain_cli_resume(tmp_path):
    """A 2-iteration run (4 optimizer steps) resumed to max-iter 3 logs
    exactly iteration 3 with opt_steps 6, at the persisted scheduler lr."""
    run1 = _cli(str(tmp_path / 'l1'), '--max-iter', '2', '--valid-step', '2')
    ckpt = os.path.join(run1, 'checkpoints')
    meta_path = os.path.join(ckpt, 'step_2.json')
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta['step'] == 2 and meta['opt_steps'] == 4 and meta['scheduler']
    meta['scheduler']['lr'] = 5.5e-6   # poisoned so that its restoration shows
    with open(meta_path, 'w') as f:
        json.dump(meta, f)
    run2 = _cli(str(tmp_path / 'l2'), '--max-iter', '3', '--valid-step', '3',
                '--resume', ckpt)
    train = [(r['step'], int(r['train/opt_steps']), r['train/lr'])
             for r in _rows(run2, 'train/loss')]
    assert train == [(3, 6, pytest.approx(5.5e-6))]


@pytest.mark.parametrize('args,match', [
    (['--tp', '2'], 'parallelism'),
    (['--multihost'], 'parallelism'),
])
def test_pretrain_cli_refuses_what_is_not_ported(args, match, capsys):
    with pytest.raises(SystemExit):
        PT.main(['--config', TEST_CFG, '--synthetic', '32', '--device', 'cpu', *args])
    assert match in capsys.readouterr().err


def test_chip_smoke_pretrain_config_is_antibody_train_yml():
    """chip_smoke.py trains from a literal of configs/antibody_train.yml (the
    card machine may lack PyYAML) with batch_acc lowered from 300 to 2."""
    import importlib.util
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  os.path.join(REPO, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    literal = json.loads(json.dumps(smoke.PRETRAIN_CONFIG))
    ref = load_yaml(os.path.join(REPO, 'configs', 'antibody_train.yml')).to_dict()
    assert (literal['train'].pop('batch_acc'), ref['train'].pop('batch_acc')) == (2, 300)
    assert literal == ref


def test_chip_smoke_nano_pretrain_config_is_heavy_train_yml():
    """chip_smoke.py trains the nano model from a literal of
    configs/heavy_train.yml, batch_acc lowered from 300 to 2 as above."""
    import importlib.util
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  os.path.join(REPO, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    literal = json.loads(json.dumps(smoke.NANO_PRETRAIN_CONFIG))
    ref = load_yaml(os.path.join(REPO, 'configs', 'heavy_train.yml')).to_dict()
    assert (literal['train'].pop('batch_acc'), ref['train'].pop('batch_acc')) == (2, 300)
    assert literal == ref
    assert smoke.NANO_TRAIN_B == ref['train']['batch_size'] == 512
