"""The port's parallelism (hudiff_tpu_torch/parallel/, the tensor-parallel
model, ``pretrain --tp/--multihost``, ``humanize --shard``) against the JAX
package and against one process.

- (a) The sharding rules: for every leaf of a test-size ``AntiTFNet`` and
  ``NanoAntiTFNet``, the port's rank-r shard of the converted parameter is
  the block JAX's ``param_shardings`` places on model index r of the
  conftest's 8 CPU devices, except the FFN ``Dense_0`` bias, which JAX
  replicates and the port splits with its columns.
- (b) ``rope_attention_qkv_tp`` against JAX's on a dp 4 x tp 2 CPU mesh
  (tests/test_pallas_attention.py's setup, the Pallas kernel in interpret
  mode), f32, to 1e-5; and where both fall back to the unsharded call.
- (c, d) Two gloo processes (``tools/parallel_check.py``, a ``file://``
  rendezvous under tmp_path) take one f32 train step at tp = 2 and at dp =
  2, dropout 0, clipping on: the loss and the global gradient norm to 1e-5
  relative, every gathered gradient to max |err| <= 1e-5 max |ref| per
  tensor, and the updated parameters to ||err|| <= 1e-5 ||ref|| of the one
  process step (Adam's first update is ~lr sign(g), so an element whose
  gradient is within rounding of 0 may move by ~lr apart; the global norm
  allows that, the gradients are held per tensor); against the one-process
  witness in the step's own order (``in_parallel_order``) every tensor to
  1e-5. With dropout on at tp = 2 the replicated activations are equal on
  both ranks.
- (e) ``pretrain.run`` on two processes at tp = 2: the validation losses
  are bit-identical on both ranks, the checkpoint has the tp = 1 layout,
  loads at tp = 1 and resumes at tp = 2.
- (f) A sharded sampling round (24 framework slots, 8 rows) gives the
  one-process rows.
- (g) The CLIs' refusals; ``parallel_check`` runs on the card unless
  asked for the CPU.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from hudiff_tpu.models.denoiser import AntiTFNet as JNet
from hudiff_tpu.models.denoiser import DenoiserConfig as JCfg
from hudiff_tpu.models.denoiser import NanoAntiTFNet as JNano
from hudiff_tpu.models.denoiser import nano_config as j_nano_config
from hudiff_tpu.ops.pallas_attention import rope_attention_qkv_tp as j_qkv_tp
from hudiff_tpu.ops.rope import rope_tables as j_rope_tables
from hudiff_tpu.parallel.mesh import make_mesh as j_make_mesh
from hudiff_tpu.parallel.mesh import param_shardings
from hudiff_tpu.training import train_step as JT
from hudiff_tpu_torch.models.denoiser import AntiTFNet, DenoiserConfig
from hudiff_tpu_torch.ops.fused_attention import rope_attention_qkv_tp
from hudiff_tpu_torch.ops.rope import rope_tables
from hudiff_tpu_torch.parallel import mesh as M
from hudiff_tpu_torch.sampling import humanize as H
from hudiff_tpu_torch.tools import parallel_check as PC
from hudiff_tpu_torch.training import checkpoints as CK
from hudiff_tpu_torch.training import pretrain as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_CFG = os.path.join(REPO, 'configs', 'antibody_test.yml')
H1 = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
      'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYYFDYWGQGTTLTVSS')
L1 = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
      'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')
TIMEOUT = 240   # seconds for a launch of two ranks (each takes ~10 s here)
TOL = 1e-5
STEP = dict(test_size=True, batch=4, seed=7, clip_norm=0.5,   # the norm is ~11: clipped
            device='cpu')


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several xdist workers
    at once (the ranks of a launch set their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the sharding rules ------------------------------------------------------

def _jax_tree(kind):
    if kind == 'pair':
        cfg = JCfg().test_size()
        args = (np.zeros((1, 291), np.int32), JT.pair_region_batch(1), np.zeros((1, 2), np.int32))
        return cfg, JNet(cfg).init(jax.random.PRNGKey(3), *args)['params']
    cfg = j_nano_config().test_size()
    args = (np.zeros((1, 152), np.int32), JT.heavy_region_batch(1))
    return cfg, JNano(cfg).init(jax.random.PRNGKey(3), *args)['params']


@pytest.mark.parametrize('tp', [2, 4])
@pytest.mark.parametrize('kind', ['pair', 'heavy'])
def test_shards_are_jax_param_shardings_blocks(kind, tp):
    jcfg, params = _jax_tree(kind)
    pcfg = DenoiserConfig.from_dict(jcfg.__dict__)
    mesh = j_make_mesh(jax.devices()[:8], model_axis=tp)
    shardings = param_shardings(mesh, params)
    full = CK.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params), pcfg)
    split = sorted(k for k in full if M.param_pspec(k))
    # eight leaves a block where JAX's rules match, and the FFN's first bias
    assert len(split) == 9 * pcfg.cs_layers
    assert all(k.startswith('self_att.blocks.') for k in split)
    for r in range(tp):
        device = mesh.devices[0, r]
        blocks = jax.tree_util.tree_map(
            lambda leaf, sh: np.asarray(leaf)[sh.devices_indices_map(leaf.shape)[device]],
            params, shardings)
        want = CK.flax_to_state_dict(blocks, pcfg)
        got = M.shard_state_dict(full, M.Mesh(dp=8 // tp, tp=tp, tp_rank=r))
        assert sorted(got) == sorted(want)
        for name in got:
            if name.endswith('ff1.bias'):   # replicated in JAX, split here
                assert torch.equal(want[name], full[name])
                n = full[name].shape[0] // tp
                assert torch.equal(got[name], full[name][r * n:(r + 1) * n])
            else:
                assert torch.equal(got[name], want[name]), name


def test_gather_undoes_shard_and_specs():
    sd = {'self_att.blocks.0.attn.qkv.weight': torch.arange(24.).reshape(12, 2),
          'self_att.blocks.0.attn.out.weight': torch.arange(8.).reshape(2, 4),
          'self_att.blocks.0.ff1.bias': torch.arange(4.), 'last_norm.bias': torch.ones(3)}
    assert M.param_pspec('self_att.blocks.0.attn_c.qkv.bias') == ('model',)
    assert M.param_pspec('self_att.blocks.3.ff2.weight') == (None, 'model')
    assert M.param_pspec('dual_conv.h_tower.blocks.0.fc1.weight') == ()
    assert M.shard_dim('self_att.blocks.0.attn.out.weight') == 1
    shards = [M.shard_state_dict(sd, M.Mesh(tp=2, tp_rank=r)) for r in range(2)]
    assert shards[1]['self_att.blocks.0.attn.qkv.weight'].shape == (6, 2)
    assert torch.equal(torch.cat([s['self_att.blocks.0.attn.out.weight'] for s in shards], 1),
                       sd['self_att.blocks.0.attn.out.weight'])
    assert shards[0]['last_norm.bias'] is sd['last_norm.bias']
    assert M.batch_slice(M.Mesh(dp=4, tp=2, dp_rank=3, nodes=2), 8) == slice(4, 8)
    with pytest.raises(ValueError, match='does not split'):
        M.batch_slice(M.Mesh(dp=2, dp_rank=1), 3)


# -- (b) tensor-parallel attention against JAX's -----------------------------------

@pytest.mark.parametrize('H,D', [(4, 64), (3, 16)])
def test_rope_attention_qkv_tp_matches_jax(H, D):
    """dp 4 x tp 2: the port's call on each (dp, tp) block of the rows and
    the head-major columns assembles JAX's output; H = 3 does not split
    over tp = 2, and both take the unsharded call."""
    mesh = j_make_mesh(jax.devices()[:8], model_axis=2)
    B, L = 8, 23
    qkv = np.asarray(jax.random.normal(jax.random.PRNGKey(17), (B, L, 3 * H * D)))
    cos, sin = j_rope_tables(D, L)
    scale = 1.0 / np.sqrt(D)
    ref = np.asarray(jax.jit(lambda t: j_qkv_tp(t, cos, sin, scale, H, mesh,
                                                use_pallas='always'))(qkv))
    tcos, tsin = rope_tables(D, L)
    splits = not H % 2
    out = np.zeros(ref.shape, np.float32)
    b, a, a3 = B // 4, H * D // 2, 3 * H * D // 2
    for d in range(4):
        for r in range(2):
            pm = M.Mesh(dp=4, tp=2, dp_rank=d, tp_rank=r)
            cols = slice(r * a3, (r + 1) * a3) if splits else slice(None)
            got = rope_attention_qkv_tp(torch.from_numpy(qkv[d * b:(d + 1) * b, :, cols]),
                                        tcos, tsin, scale, H, pm, 3 * H * D).numpy()
            if splits:
                out[d * b:(d + 1) * b, :, r * a:(r + 1) * a] = got
            else:
                out[d * b:(d + 1) * b] = got
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


# -- (c, d) one step on two processes --------------------------------------------

def _launch(tmp_path, argv, name):
    out = str(tmp_path / name)
    PC.launch([*argv, '--device', 'cpu', '--out', out], 2, out, TIMEOUT)
    return [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False) for r in range(2)]


@pytest.mark.parametrize('kind,tp', [('pair', 2), ('pair', 1), ('heavy', 2)])
def test_parallel_step_matches_one_process(tmp_path, kind, tp):
    """tp = 2 (world 2: dp 1) and dp = 2 (tp 1), f32, dropout 0, clipped."""
    ranks = _launch(tmp_path, ['step', '--tp', str(tp), '--kind', kind, '--test-size', '--fp32',
                               '--batch', str(STEP['batch']), '--seed', str(STEP['seed']),
                               '--clip-norm', str(STEP['clip_norm'])], f'{kind}{tp}')
    ref = PC.step_result(kind, dtype=torch.float32, **STEP)
    assert ref['grad_norm'] > 2 * STEP['clip_norm']
    cmp = PC.compare_steps(ranks[0], ref)
    assert cmp['same_keys']
    assert cmp['loss_rel_err'] <= TOL and cmp['grad_norm_rel_err'] <= TOL, cmp
    assert cmp['grads_max_rel_err'] <= TOL, cmp
    assert cmp['params_global_rel_err'] <= TOL, cmp
    # the one-process witness in the parallel step's order: the same sums in
    # the same order (the CPU reads 0.0 for each)
    wit = PC.compare_steps(ranks[0], PC.step_result(kind, dtype=torch.float32,
                                                    order=(2 // tp, tp), **STEP))
    assert all(wit[k] <= TOL for k in ('loss_rel_err', 'grad_norm_rel_err', 'grads_max_rel_err',
                                       'params_max_rel_err')), wit
    assert [r['mesh']['tp_rank'] for r in ranks] == ([0, 1] if tp == 2 else [0, 0])
    if tp == 2:   # one TP group: the replicated activations are the same bits
        for name, act in ranks[0]['activations'].items():
            assert torch.equal(act, ranks[1]['activations'][name]), name


def test_dropout_draws_one_mask_per_tp_group(tmp_path):
    """Dropout on (0.5 in the towers and the positional MLP) at tp = 2: the
    towers, the embedders and the attention stack give the same bits on
    both ranks, and dropout did act (the output differs from dropout 0)."""
    ranks = _launch(tmp_path, ['step', '--tp', '2', '--test-size', '--fp32', '--batch', '4',
                               '--dropout', '0.5'], 'drop')
    for name, act in ranks[0]['activations'].items():
        assert torch.equal(act, ranks[1]['activations'][name]), name
    plain = PC.step_result('pair', dtype=torch.float32, test_size=True, batch=4, seed=7,
                           device='cpu')
    assert not torch.equal(plain['activations']['towers'], ranks[0]['activations']['towers'])


# -- (e) pretrain.run on two processes ---------------------------------------------

def _val_losses(run_dir):
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        return [json.loads(line)['val/loss'] for line in f if 'val/loss' in line]


def test_pretrain_run_tp2_checkpoint_loads_at_tp1_and_resumes(tmp_path):
    run_args = {'synthetic': 16, 'max_iter': 1, 'valid_step': 1, 'use_bf16': False, 'seed': 7}
    ranks = _launch(tmp_path, ['pretrain', '--tp', '2', '--config', TEST_CFG,
                               '--run-args', json.dumps(run_args)], 'run1')
    run = ranks[0]['log_dir']
    assert ranks[1]['log_dir'] == run
    val = _val_losses(run)
    assert val and val == _val_losses(os.path.join(run, 'rank_1'))   # the same bits
    ckpt_dir = os.path.join(run, 'checkpoints')
    assert sorted(os.listdir(ckpt_dir)) == ['LATEST', 'step_1.json', 'step_1.pt']
    model, config = CK.load(os.path.join(ckpt_dir, 'step_1.pt'), device='cpu')
    cfg = DenoiserConfig.from_dict(config['model'])
    assert model.self_att.blocks[0].attn.qkv.weight.shape == (3 * cfg.att_model,
                                                              cfg.sum_d_model)
    names = [n for n, _ in model.named_parameters()]
    state = CK.restore(ckpt_dir)['payload']['optimizer']['state'][names.index(
        'self_att.blocks.0.attn.qkv.weight')]
    assert state['exp_avg'].shape == (3 * cfg.att_model, cfg.sum_d_model)
    tokens = torch.zeros(2, 291, dtype=torch.long)
    region = torch.from_numpy(JT.pair_region_batch(2)).long()
    with torch.no_grad():
        logits = model(tokens, region, torch.tensor([[0, 1], [0, 2]]))
    assert logits.shape == (2, 291, 23) and torch.isfinite(logits).all()
    resumed = _launch(tmp_path, ['pretrain', '--tp', '2', '--config', TEST_CFG, '--run-args',
                                 json.dumps({**run_args, 'max_iter': 2, 'resume': ckpt_dir})],
                      'run2')[0]['log_dir']
    with open(os.path.join(resumed, 'metrics.jsonl')) as f:
        train = [json.loads(line) for line in f if 'train/loss' in line]
    acc = 2   # configs/antibody_test.yml's batch_acc
    assert [(r['step'], r['train/opt_steps']) for r in train] == [(2, 2 * acc)]
    assert os.path.exists(os.path.join(resumed, 'checkpoints', 'step_2.pt'))


# -- (f) sharded sampling -----------------------------------------------------------

def test_shard_sampling_rows_equal_one_process(tmp_path):
    pairs = tmp_path / 'pairs.json'
    pairs.write_text(json.dumps([[H1, L1]]))
    ranks = _launch(tmp_path, ['sample', '--pairs', str(pairs), '--test-size', '--fp32',
                               '--batch', '8', '--rows', '8', '--positions', '24'], 'sample')
    ref = PC.sample_result([[H1, L1]], None, True, 8, 8, 7, True, torch.device('cpu'), None,
                           positions=24)
    assert ref.shape == (8, 291)
    np.testing.assert_array_equal(ranks[0]['grids'], ref)
    np.testing.assert_array_equal(ranks[1]['grids'], ref)


# -- (g) the CLIs' refusals ------------------------------------------------------------

@pytest.mark.parametrize('args,match', [
    (['--multihost'], 'needs a launcher environment'),
    (['--tp', '2'], 'world divisible by 2, not 1'),
    (['--tp', '0'], 'at least 1'),
])
def test_pretrain_cli_refuses(args, match, capsys, monkeypatch):
    for key in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit):
        PT.main(['--config', TEST_CFG, '--synthetic', '32', '--device', 'cpu', *args])
    assert match in capsys.readouterr().err


def test_parallel_check_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA device requested'):
        PC.main(['step', '--out', str(tmp_path)])
    with pytest.raises(RuntimeError, match='CUDA device requested'):
        PC.step_result()
    assert not os.listdir(tmp_path)   # no rank was started


def test_init_without_launcher_raises_and_shard_alone_is_a_no_op(monkeypatch):
    for key in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match='no launcher environment'):
        M.init_distributed(device='cpu')
    assert M.make_mesh() == M.Mesh()

    class Args:
        shard, device, logdir = True, 'cpu', 'logs'
    assert H._maybe_mesh(Args()) == (None, False)
    with pytest.raises(ValueError, match='tp = 1'):
        H.PairHumanizer(torch.nn.Linear(1, 1), device='cpu', mesh=M.Mesh(dp=1, tp=2))
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setenv('LOCAL_WORLD_SIZE', '2')
    with pytest.raises(RuntimeError, match='NCCL refuses two ranks on one card'):
        M.init_distributed('nccl', 'cpu', 'file:///nonexistent/rendezvous', rank=0, world=2)
    with pytest.raises(ValueError, match='3 heads'):
        AntiTFNet(dataclasses.replace(DenoiserConfig().test_size(), nhead=3, att_model=192),
                  device='cpu', tp_mesh=M.Mesh(tp=2))
