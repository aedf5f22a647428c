"""The port's fine-tuning (hudiff_tpu_torch/ops/scheme_transfer.py,
models/finetune.py, training/finetune.py) against the JAX package's, on
the CPU.

- The scheme transfer on the synthetic batches of both packages (equal),
  on rows with <msk> slots and on a row whose candidate counts differ
  (what the port returns there); the Gumbel straight-through forward and
  gradient on the uniforms JAX draws.
- One Nb step (vhh_nativeness, equal_weight, reconstruct on and off) and
  one Ab step (smooth_loss, mse_loss, the mutation hinge) against JAX's own
  ``make_*_finetune_fns`` step: the port is handed the corruption and the
  ``jax.random.uniform`` draws that step makes from the same key. Loss and
  metrics to 1e-5 (relative), every parameter gradient to 1e-5 of max
  |ref|, at dropout 0 (the JAX loss runs the denoiser with
  ``deterministic=False``; the test hands it the model deterministic, since
  the positional GatedMLP's p = 0.5 is not a config field).
- The ``nano`` and ``ab`` CLIs at test size with ``--synthetic``, two
  iterations, ``--resume``, chained into ``humanize --ckpt``.
"""
import dataclasses
import glob
import json
import os

import numpy as np
import optax
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from hudiff_tpu.models import abnativ as JA
from hudiff_tpu.models import finetune as JF
from hudiff_tpu.models.denoiser import AntiTFNet as JNet
from hudiff_tpu.models.denoiser import DenoiserConfig as JCfg
from hudiff_tpu.models.denoiser import NanoAntiTFNet as JNano
from hudiff_tpu.models.denoiser import nano_config as j_nano_config
from hudiff_tpu.ops import masking as JM
from hudiff_tpu.ops import scheme_transfer as JST
from hudiff_tpu.training import finetune as JTF
from hudiff_tpu.training import train_step as JT
from hudiff_tpu.utils.config import load_yaml as j_load_yaml
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.models import abnativ as A
from hudiff_tpu_torch.models import finetune as F
from hudiff_tpu_torch.models.denoiser import DenoiserConfig
from hudiff_tpu_torch.ops import masking as M
from hudiff_tpu_torch.ops import scheme_transfer as ST
from hudiff_tpu_torch.sampling import humanize as H
from hudiff_tpu_torch.training import checkpoints as CK
from hudiff_tpu_torch.training import finetune as FT
from hudiff_tpu_torch.training import train_step as T
from hudiff_tpu_torch.utils.config import load_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NANO_FT = os.path.join(REPO, 'configs', 'nano_finetune.yml')
AB_FT = os.path.join(REPO, 'configs', 'antibody_finetune.yml')
SMOKE = dict(d_embedding=32, kernel=4, stride=2, num_heads=2, num_mha_layers=1, d_ff=64,
             num_embeddings=16, embedding_dim_code_book=8)
VHH = ('QVQLVESGGGLVQAGGSLRLSCAASGRTFSSYAMGWFRQAPGKEREFVAAISWSGGSTYYADSVKGRF'
       'TISRDNAKNTVYLQMNSLKPEDTAVYYCAADRGSYYYTRNQYDYWGQGTQVTVSS')
H1 = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
      'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYYFDYWGQGTTLTVSS')
L1 = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
      'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (several xdist workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the scheme transfer ----------------------------------------------------------

def test_synthetic_batches_match_jax():
    for port, ref in ((FT.synthetic_nano_batches(3, 4), JTF.synthetic_nano_batches(3, 4)),
                      (FT.synthetic_pair_batches(3, 4), JTF.synthetic_pair_batches(3, 4))):
        for _ in range(2):
            a, b = next(port), next(ref)
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _matched(batch):
    """A synthetic pair batch with its counts made to match: the synthetic
    light grid is a nano grid cut to 139 slots, so its AHo row holds more
    residues; the last ones become gaps."""
    tokens, aho = batch['tokens'], batch['aho'].copy()
    light_aho = ST.PAIR_AHO_CAND[147:]
    for b in range(len(tokens)):
        extra = ((tokens[b, 152:290] < C.IDX_PAD).sum()
                 - (aho[b, light_aho].argmax(-1) != C.ABNATIV_GAP_IDX).sum())
        valid = light_aho[aho[b, light_aho].argmax(-1) != C.ABNATIV_GAP_IDX]
        assert extra <= 0
        for j in valid[len(valid) + extra:]:
            aho[b, j] = 0
            aho[b, j, C.ABNATIV_GAP_IDX] = 1
    return dict(batch, aho=aho)


@pytest.mark.parametrize('pair', [False, True])
def test_transfer_matches_jax_where_counts_match(pair):
    """The map, the one-hot transfer (with <msk> slots in the grid) and the
    mask transfer: equal on every row; every row's counts match."""
    batch = (_matched(next(FT.synthetic_pair_batches(4, 8))) if pair
             else next(FT.synthetic_nano_batches(4, 8)))
    tokens, aho = batch['tokens'], batch['aho']
    icand, acand, vmax = ((ST.PAIR_IMGT_CAND, ST.PAIR_AHO_CAND, C.IDX_PAD) if pair else
                          (ST.NANO_IMGT_CAND, ST.NANO_AHO_CAND, C.IDX_X))
    assert ST.counts_match(_t(tokens), _t(aho), pair).all()
    assert np.asarray(JST.counts_match(tokens, aho, pair)).all()
    tm = ST.build_transfer_map(_t(tokens), _t(aho), icand, acand, vmax)
    jtm = JST.build_transfer_map(tokens, aho, icand, acand, vmax)
    for a, b in zip(tm, jtm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rs = np.random.RandomState(1)
    mask = (rs.rand(*tokens.shape) < 0.3) & (tokens < C.IDX_X)
    grid = np.where(mask & (rs.rand(*tokens.shape) < 0.5), C.IDX_MSK, tokens)
    onehot = ST.imgt_grid_onehot(_t(grid))
    np.testing.assert_array_equal(onehot.numpy(), np.asarray(JST.imgt_grid_onehot(grid)))
    assert (onehot[_t(grid == C.IDX_MSK)] == 0).all()
    assert (onehot[_t(grid == C.IDX_PAD)][:, C.ABNATIV_GAP_IDX] == 1).all()
    np.testing.assert_array_equal(ST.apply_transfer(onehot, _t(aho), tm).numpy(),
                                  np.asarray(JST.apply_transfer(
                                      JST.imgt_grid_onehot(grid), aho, jtm)))
    np.testing.assert_array_equal(ST.transfer_mask(_t(mask), tm).numpy(),
                                  np.asarray(JST.transfer_mask(mask, jtm)))


def test_transfer_on_a_row_whose_counts_differ():
    """A pair row with 20 IMGT residues and 295 valid AHo slots: the port
    maps the k-th residue to the k-th AHo slot, as JAX does, and every AHo
    slot past the 20th keeps its original one-hot (source -1), including
    ranks at or past the 288 IMGT candidates, where JAX reads a slot
    whose value depends on scatter order."""
    tokens = np.full((1, C.PAIR_LEN), C.IDX_PAD)
    tokens[0, ST.PAIR_IMGT_CAND[5:25]] = np.arange(20)
    aho = np.zeros((1, 2 * C.AHO_LEN, 21), np.float32)
    aho[0, :, 3] = 1
    tm = ST.build_transfer_map(_t(tokens), _t(aho), ST.PAIR_IMGT_CAND, ST.PAIR_AHO_CAND,
                               C.IDX_PAD)
    assert not ST.counts_match(_t(tokens), _t(aho), pair=True).item()
    src = tm.src[0].numpy()
    acand = ST.PAIR_AHO_CAND
    np.testing.assert_array_equal(src[acand[:20]], ST.PAIR_IMGT_CAND[5:25])
    assert (src[acand[20:]] == -1).all()
    jsrc = np.asarray(JST.build_transfer_map(tokens, aho, ST.PAIR_IMGT_CAND, acand,
                                             C.IDX_PAD).src[0])
    np.testing.assert_array_equal(jsrc[acand[:288]], src[acand[:288]])
    moved = ST.apply_transfer(ST.imgt_grid_onehot(_t(tokens)), _t(aho), tm)[0]
    np.testing.assert_array_equal(moved[acand[20:]].numpy(), aho[0, acand[20:]])
    # the synthetic pair batches of both packages have ~10 more AHo light
    # residues than IMGT ones; no AHo rank reaches 288, so the maps agree
    batch = next(FT.synthetic_pair_batches(4, 8))
    assert not ST.counts_match(_t(batch['tokens']), _t(batch['aho']), pair=True).any()
    np.testing.assert_array_equal(
        ST.build_transfer_map(_t(batch['tokens']), _t(batch['aho']), ST.PAIR_IMGT_CAND,
                              acand, C.IDX_PAD).src.numpy(),
        np.asarray(JST.build_transfer_map(batch['tokens'], batch['aho'], ST.PAIR_IMGT_CAND,
                                          acand, C.IDX_PAD).src))


def test_gumbel_straight_through_matches_jax():
    rs = np.random.RandomState(2)
    logits = (3 * rs.randn(2, 11, 20)).astype(np.float32)
    w = rs.randn(2, 11, 20).astype(np.float32)
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, logits.shape))
    for temperature in (1.0, 0.5):
        ref, ref_grad = jax.value_and_grad(
            lambda x: (JST.gumbel_straight_through(key, x, temperature) * w).sum())(
            jnp.asarray(logits))
        lt = _t(logits).requires_grad_()
        st = ST.gumbel_straight_through(lt, temperature, u=_t(u))
        (st * _t(w)).sum().backward()
        hard = np.asarray(JST.gumbel_straight_through(key, jnp.asarray(logits), temperature))
        np.testing.assert_array_equal(st.detach().round().numpy(), np.round(hard))
        np.testing.assert_allclose(st.detach().numpy(), hard, rtol=0, atol=1e-6)
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(ref_grad), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(ref_grad)).max())
    gen = torch.Generator().manual_seed(0)
    drawn = ST.gumbel_straight_through(_t(logits), generator=gen)
    assert torch.equal(drawn.sum(-1), torch.ones(2, 11))


def test_mask_low_score_residues_matches_jax():
    batch = next(FT.synthetic_nano_batches(3, 9))
    tokens, aho = batch['tokens'], batch['aho']
    scores = np.random.RandomState(3).uniform(0.97, 1.0, (3, C.AHO_LEN)).astype(np.float32)
    cdr = np.broadcast_to(C.HEAVY_CDR_INDEX != 0, tokens.shape)
    tm = ST.build_transfer_map(_t(tokens), _t(aho), ST.NANO_IMGT_CAND, ST.NANO_AHO_CAND,
                               C.IDX_X)
    jtm = JST.build_transfer_map(tokens, aho, ST.NANO_IMGT_CAND, ST.NANO_AHO_CAND, C.IDX_X)
    got = F.mask_low_score_residues(_t(tokens), _t(scores), tm, _t(cdr))
    ref = JF.mask_low_score_residues(tokens, scores, jtm, cdr)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[1].any()


# -- one step against the JAX step -------------------------------------------------

class _Deterministic:
    """The JAX denoiser without dropout: the fine-tune loss applies it with
    ``deterministic=False``, which would draw the GatedMLP's p = 0.5."""

    def __init__(self, model):
        self.model = model

    def apply(self, params, *args, deterministic=True, rngs=None):
        return self.model.apply(params, *args)


def _capture_tx():
    """An optax transformation that keeps the gradients as its state and
    changes no parameter."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


class _Capture(torch.optim.Optimizer):
    """Keeps the gradients it is stepped with and changes nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = None

    def step(self, closure=None):
        self.grads = [p.grad.clone() for g in self.param_groups for p in g['params']]


def _leaf(rs):
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
    return leaf


def _tree(jmodel, seed, *inputs):
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *inputs)
    return jax.tree_util.tree_map_with_path(_leaf(np.random.RandomState(seed)), shapes)


def _scorers(straight_through, n):
    """n (JAX model, its variables, port scorer) at the smoke hparams."""
    out = []
    for i in range(n):
        jm = JA.AbNatiVModel(JA.AbNatiVParams(**SMOKE), straight_through=straight_through)
        v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(10 + i),
                                                        jnp.zeros((1, C.AHO_LEN, 21))))
        model = A.AbNatiVModel(A.AbNatiVParams(**SMOKE), straight_through)
        model.load_state_dict(A.flax_to_state_dict(v, model.hp))
        out.append((jm, jax.tree_util.tree_map(jnp.asarray, v), A.frozen(model)))
    return out


def _check(metrics, ref_metrics, model, ref_grads, cfg):
    ref_metrics = {k: float(v) for k, v in ref_metrics.items()}
    assert sorted(metrics) == sorted(ref_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), ref_metrics[k], rtol=1e-5, atol=1e-7, err_msg=k)
    ref = CK.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_grads), cfg)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, got in zip(names, model.grads):
        r = ref[name].numpy()
        err = np.abs(got.numpy() - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= 1e-5, f'{name}: {err}'


def _draws(key, tokens, protected, window):
    """The corruption and Gumbel uniforms the JAX step draws from ``key``
    at step 0 (hudiff_tpu/training/finetune.py:86-90, models/finetune.py:87-90)."""
    rng_mask, rng_loss = jax.random.split(jax.random.fold_in(key, 0))
    cor = JM.corrupt(rng_mask, jnp.asarray(tokens), jnp.asarray(protected), window=window)
    u = jax.random.uniform(jax.random.split(rng_loss)[1], (*tokens.shape, C.N_AA))
    mask = np.asarray(cor.mask)
    return M.Corrupted(_t(np.asarray(cor.src)), _t(mask), _t(np.asarray(cor.num_masked))), \
        _t(np.asarray(u))


@pytest.mark.parametrize('vhh,equal_weight,reconstruct,empty_row', [
    (False, False, False, False), (True, False, True, False), (True, True, False, False),
    (True, False, False, True)])
def test_nano_step_matches_jax(vhh, equal_weight, reconstruct, empty_row):
    """``empty_row``: the second row's framework is all pads, so its
    corruption masks nothing and its nativeness selection is empty. The
    JAX score's gradient there is NaN (test_torch_abnativ.py), but both
    steps stop it at their masked ``where``: the JAX step's gradients are
    finite and the port's match them."""
    jcfg = dataclasses.replace(j_nano_config().test_size(), dropout=0.0)
    pcfg = DenoiserConfig(**dataclasses.asdict(jcfg))
    B = 2
    batch = next(FT.synthetic_nano_batches(B, 3))
    tokens, aho = batch['tokens'], batch['aho']
    if empty_row:
        tokens[1, :150][C.HEAVY_CDR_INDEX[:150] == 0] = C.IDX_PAD
    region = np.broadcast_to(C.HEAVY_REGION_INDEX, tokens.shape).astype(np.int32)
    tree = _tree(JNano(jcfg), 4, tokens[:1], region[:1])
    ft_cfg = dict(vhh_nativeness=vhh, equal_weight=equal_weight, temperature=0.8)
    (jvh, vh_v, vh), (jvhh, vhh_v, vhh_m) = _scorers(False, 2)
    shim = _Deterministic(JNano(jcfg))
    jloss = JF.make_nano_finetune_loss(shim, jvh, vh_v, JF.NanoFinetuneConfig(**ft_cfg),
                                       jvhh, vhh_v)
    jstep, _ = JTF.make_nano_finetune_fns(shim, jloss, jnp.asarray(C.HEAVY_CDR_INDEX),
                                          reconstruct, 1e-3)
    key = jax.random.PRNGKey(11)
    new_state, ref_metrics = jstep(JT.TrainState.create(tree, _capture_tx()), tokens, aho, key)
    protected = (C.HEAVY_CDR_INDEX != 0)[None] | (tokens == C.IDX_PAD)
    cor, u = _draws(key, tokens, protected, 150)
    assert cor.mask.any(1).tolist() == [True, not empty_row]
    assert all(np.isfinite(np.asarray(g)).all()
               for g in jax.tree_util.tree_leaves(new_state.opt_state))

    model = CK.from_flax_params(tree, pcfg, device='cpu')   # eval(): no dropout
    loss = F.make_nano_finetune_loss(model, vh, F.NanoFinetuneConfig(**ft_cfg), vhh_m)
    step, eval_step = FT.make_nano_finetune_fns(loss, reconstruct, 1e-3)
    state = T.TrainState(model, _Capture(model.parameters()))
    before = eval_step(_t(tokens).long(), _t(aho), T.generator('cpu', 7, 0))
    m = step(state, _t(tokens).long(), _t(aho), 0, corrupted=cor, u=u)
    assert state.step == 1 and ('delta_vhh' in m) == vhh and ('reconstruct_ce' in m) == \
        reconstruct
    model.grads = state.optimizer.grads
    _check(m, ref_metrics, model, new_state.opt_state, pcfg)
    # the eval step is the step's loss on the same draws, without an update
    drawn = step(T.TrainState(model, _Capture(model.parameters())), _t(tokens).long(),
                 _t(aho), 7)
    assert {k: v.item() for k, v in drawn.items()} == {k: v.item() for k, v in before.items()}


@pytest.mark.parametrize('loss_type,mutation,ratios', [
    ('smooth_loss', False, (0.0, 0.0)), ('mse_loss', False, (0.0, 0.0)),
    ('smooth_loss', True, (0.5, 0.25))])
def test_ab_step_matches_jax(loss_type, mutation, ratios):
    jcfg = dataclasses.replace(JCfg.from_dict(load_yaml(
        os.path.join(REPO, 'configs', 'antibody_test.yml')).model), dropout=0.0)
    pcfg = DenoiserConfig(**dataclasses.asdict(jcfg))
    B = 3
    batch = _matched(next(FT.synthetic_pair_batches(B, 5)))
    tokens, chain, aho = batch['tokens'], batch['chain_type'], batch['aho']
    assert set(chain[:, 1]) == {1, 2}   # both light scorers carry weight
    region = np.broadcast_to(np.concatenate([C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]),
                             tokens.shape).astype(np.int32)
    tree = _tree(JNet(jcfg), 6, tokens[:1], region[:1], chain[:1])
    ft_cfg = dict(loss_type=loss_type, mutation=mutation, heavy_mutation_threshold=3,
                  light_mutation_threshold=40)
    scorers = _scorers(True, 3)
    shim = _Deterministic(JNet(jcfg))
    jloss = JF.make_ab_finetune_loss(shim, *(x for s in scorers for x in s[:2]),
                                     JF.AbFinetuneConfig(**ft_cfg))
    jstep, _ = JTF.make_ab_finetune_fns(jloss, *ratios)
    key = jax.random.PRNGKey(13)
    new_state, ref_metrics = jstep(JT.TrainState.create(tree, _capture_tx()), tokens, chain,
                                   aho, key)
    cdr = np.concatenate([C.HEAVY_CDR_KABAT_NO_VERNIER, C.LIGHT_CDR_KABAT_NO_VERNIER]) != 0
    cor, u = _draws(key, tokens, cdr[None] | (tokens == C.IDX_PAD), None)
    assert cor.mask.any(1).all()

    model = CK.from_flax_params(tree, pcfg, device='cpu')
    loss = F.make_ab_finetune_loss(model, *(s[2] for s in scorers), F.AbFinetuneConfig(**ft_cfg))
    step, _ = FT.make_ab_finetune_fns(loss, *ratios)
    state = T.TrainState(model, _Capture(model.parameters()))
    m = step(state, _t(tokens).long(), _t(chain).long(), _t(aho), 0, corrupted=cor, u=u)
    if mutation:
        assert m['h_mutation_loss'].item() > 0 and m['l_mutation_loss'].item() > 0
    model.grads = state.optimizer.grads
    _check(m, ref_metrics, model, new_state.opt_state, pcfg)


# -- the CLIs ------------------------------------------------------------------------

def _pretrained(tmp_path, kind):
    """A random test-size port checkpoint of ``kind``."""
    torch.manual_seed(0)
    if kind == 'heavy':
        cfg = DenoiserConfig.from_dict(load_yaml(os.path.join(REPO, 'configs',
                                                              'heavy_test.yml')).model)
    else:
        cfg = DenoiserConfig.from_dict(load_yaml(os.path.join(REPO, 'configs',
                                                              'antibody_test.yml')).model)
    return CK.save(str(tmp_path / f'{kind}.pt'), CK.model_class(kind)(cfg), cfg)


def _config(tmp_path, src, **finetune):
    """``src`` with ``finetune`` overrides (batch size 4)."""
    cfg = load_yaml(src).to_dict()
    cfg['finetune'].update(batch_size=4, **finetune)
    path = str(tmp_path / os.path.basename(src))
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


def _run(cmd, config, ckpt, logdir, *extra):
    FT.main([cmd, '--config', config, '--pretrain-ckpt', ckpt, '--synthetic', '--device',
             'cpu', '--fp32', '--logdir', logdir, *extra])
    return sorted(glob.glob(os.path.join(logdir, f'{cmd}_finetune_*')))[-1]


def _rows(run_dir):
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


def _chain(run_dir, cmd, cfg_path, ckpt, tmp_path, kind, extra=()):
    """Check the 2-iteration run, resume it to 3, and return the best
    checkpoint's file."""
    rows = _rows(run_dir)
    train = [r for r in rows if 'finetune/loss' in r]
    assert [r['step'] for r in train] == [1, 2]
    assert all(np.isfinite(r['finetune/loss']) for r in train)
    val = [r for r in rows if 'val/loss' in r]
    assert [r['step'] for r in val] == [2] and np.isfinite(val[0]['val/loss'])
    ckpt_dir = os.path.join(run_dir, 'checkpoints')
    meta = CK.restore(ckpt_dir)
    assert meta['step'] == 2 and meta['kind'] == kind
    assert meta['meta']['config']['finetuned'] is True
    assert meta['payload']['config']['finetuned'] is True
    run2 = _run(cmd, cfg_path, ckpt, str(tmp_path / 'resumed'), '--max-iter', '3',
                '--valid-step', '3', '--resume', ckpt_dir, *extra)
    assert [r['step'] for r in _rows(run2) if 'finetune/loss' in r] == [3]
    return os.path.join(ckpt_dir, 'step_2.pt'), rows


def test_nano_cli_resume_and_humanize(tmp_path):
    """configs/nano_finetune.yml at batch 4 with cross_interval 2: iteration
    2 takes a heavy cross-training step, validation reads the heavy split
    too; the best checkpoint (finetuned, heavy) humanizes a VHH."""
    ckpt = _pretrained(tmp_path, 'heavy')
    cfg = _config(tmp_path, NANO_FT, cross_interval=2)
    run = _run('nano', cfg, ckpt, str(tmp_path / 'ft'), '--max-iter', '2', '--valid-step',
               '2', '--cross-training')
    best, rows = _chain(run, 'nano', cfg, ckpt, tmp_path, 'heavy', ('--cross-training',))
    assert [r['step'] for r in rows if 'cross/loss' in r] == [2]
    assert any('val/heavy_loss' in r for r in rows)
    assert H.load_denoiser(best, 'heavy', device='cpu')[1] is True
    out = str(tmp_path / 'hum')
    H.main(['nano', '--ckpt', best, '--vhh-seq', VHH, '--batch-size', '2',
            '--sample-number', '1', '--logdir', out, '--device', 'cpu', '--fp32'])
    csvs = glob.glob(os.path.join(out, '*', 'sample_humanization_result.csv'))
    assert csvs
    with open(csvs[0]) as f:
        assert any(line.startswith('humanization,') for line in f)


def test_ab_cli_resume_and_humanize(tmp_path):
    ckpt = _pretrained(tmp_path, 'pair')
    cfg = _config(tmp_path, AB_FT)
    run = _run('ab', cfg, ckpt, str(tmp_path / 'ft'), '--max-iter', '2', '--valid-step', '2')
    best, _ = _chain(run, 'ab', cfg, ckpt, tmp_path, 'pair')
    out = str(tmp_path / 'hum')
    H.main(['ab', '--ckpt', best, '--hseq', H1, '--lseq', L1, '--batch-size', '2',
            '--sample-number', '1', '--logdir', out, '--device', 'cpu', '--fp32'])
    csvs = glob.glob(os.path.join(out, '*', 'sample_humanization_result.csv'))
    assert csvs
    with open(csvs[0]) as f:
        assert any(line.startswith('humanization,') for line in f)


def test_finetune_cli_refusals(tmp_path, capsys):
    """The CLI runs on the card unless ``--device cpu``; without a card it
    raises. Real data needs its path; the config must be the kind's."""
    ckpt = _pretrained(tmp_path, 'heavy')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            FT.main(['nano', '--config', NANO_FT, '--pretrain-ckpt', ckpt, '--synthetic',
                     '--logdir', str(tmp_path)])
    with pytest.raises(SystemExit):
        FT.main(['nano', '--config', NANO_FT, '--pretrain-ckpt', ckpt, '--device', 'cpu'])
    assert '--vhh-data' in capsys.readouterr().err
    with pytest.raises(ValueError, match="'heavy' model, not a 'pair'"):
        FT.main(['ab', '--config', _config(tmp_path, AB_FT), '--pretrain-ckpt', ckpt,
                 '--synthetic', '--device', 'cpu', '--logdir', str(tmp_path)])


def test_finetune_configs_load_like_jax():
    for path in (NANO_FT, AB_FT):
        assert load_yaml(path).to_dict() == j_load_yaml(path).to_dict()

