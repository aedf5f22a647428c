"""Weight bridge and the port's own checkpoints.

``from_flax_params`` loads the JAX package's ``AntiTFNet`` or
``NanoAntiTFNet`` parameter tree (as numpy arrays; the tree's
``nano_conv`` says which) into the port's model of the same name: Flax
``Dense`` kernels are [in, out] and become ``nn.Linear`` weights [out, in];
``Conv`` kernels [K, in, out] become ``DilatedConv`` weights [out, K, in].
The merged head-major qkv projection ([q_h | k_h | v_h] per head,
rotate-half RoPE order) keeps its column order.

``save``/``load`` handle the port's checkpoint: a ``torch.save`` of
``{'config': {'model': <DenoiserConfig fields>, 'finetuned': bool, 'kind':
'pair' | 'heavy'}, 'model': state_dict}``. ``kind`` names the model, as the
JAX pretrain's metadata does: ``'heavy'`` is ``NanoAntiTFNet``; a file
without it is ``'pair'`` (``AntiTFNet``).

``save_training``/``restore``/``latest_step`` handle pretraining's
best-val checkpoints, with the JAX package's layout
(hudiff_tpu/training/checkpoints.py:18-85) in ``torch.save`` form instead
of Orbax: ``<dir>/step_<it>.pt`` holds the same ``config`` and ``model``
entries plus ``'optimizer'`` (the optimizer's ``state_dict``), so ``load``
reads its model part too; beside it ``step_<it>.json`` holds ``step``,
``config``, ``val_loss``, ``opt_steps`` and ``scheduler``, and ``LATEST``
names the newest step. ``restore`` returns the kind beside the payload;
``model_class(kind)`` is the class to load it into.

``from_flax_params`` and ``load`` run on ``cuda`` unless the caller passes
``device='cpu'``; without a card they raise.

Released reference checkpoints (hudiffab.pt / hudiffnb.pt, the reference's
torch ``state_dict`` names, interleaved RoPE pairs and separate q/k/v
projections) are converted on load, as the JAX package converts them
(hudiff_tpu/training/checkpoints.py:93-331): ``convert_torch_denoiser``
gives the same Flax-shaped numpy tree the JAX converter gives, which
``from_flax_params`` then loads. Their configs are pickled
``easydict.EasyDict`` objects, so ``load_torch_checkpoint`` reads them with
``torch.load(weights_only=False)``: it can run code a file carries, and is
used only where ``load_payload`` finds a file that is not plain data.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.denoiser import AntiTFNet, DenoiserConfig, NanoAntiTFNet
from ..utils.device import resolve_device

_BLOCK = (('LayerNorm_0', 'ln1'), ('Dense_0', 'fc1'), ('LayerNorm_1', 'ln2'),
          ('LayerNorm_2', 'ln3'), ('Dense_1', 'fc2'))
_SIDE = (('Embed_0', 'embed'), ('Dense_0', 'fc1'), ('LayerNorm_0', 'ln'),
         ('Dense_1', 'fc2'))
_REGION = (('Embed_0', 'embed'), ('LayerNorm_0', 'ln1'), ('Dense_0', 'fc'),
           ('LayerNorm_1', 'ln2'))
_ATT_BLOCK = (('norm1', 'norm1'), ('norm2', 'norm2'), ('Dense_0', 'ff1'),
              ('Dense_1', 'ff2'))


def _leaf_params(dst: str, node: Mapping[str, Any], out: Dict[str, np.ndarray]) -> None:
    """One Flax Dense / Conv / LayerNorm / Embed node -> torch entries."""
    if 'embedding' in node:
        out[f'{dst}.weight'] = np.asarray(node['embedding'])
        return
    if 'scale' in node:
        out[f'{dst}.weight'] = np.asarray(node['scale'])
    else:
        k = np.asarray(node['kernel'])
        out[f'{dst}.weight'] = k.T if k.ndim == 2 else k.transpose(2, 0, 1)
    out[f'{dst}.bias'] = np.asarray(node['bias'])


def _named(dst: str, node: Mapping[str, Any], names, out) -> None:
    for src, name in names:
        _leaf_params(f'{dst}.{name}', node[src], out)


def _tower(dst: str, node: Mapping[str, Any], out) -> None:
    for i in range(len(node)):
        blk = node[f'ByteNetBlock_{i}']
        _named(f'{dst}.blocks.{i}', blk, _BLOCK, out)
        _leaf_params(f'{dst}.blocks.{i}.conv', blk['DilatedConv1d_0']['Conv_0'], out)


def model_class(kind: str):
    """The model a checkpoint of ``kind`` holds: ``'pair'`` -> ``AntiTFNet``,
    ``'heavy'`` -> ``NanoAntiTFNet``."""
    if kind not in ('pair', 'heavy'):
        raise ValueError(f"unknown model kind {kind!r}: expected 'pair' or 'heavy'")
    return AntiTFNet if kind == 'pair' else NanoAntiTFNet


def model_kind(model: torch.nn.Module) -> str:
    return 'heavy' if isinstance(model, NanoAntiTFNet) else 'pair'


def tree_kind(tree: Mapping[str, Any]) -> str:
    """``'heavy'`` for a Flax ``NanoAntiTFNet`` tree, else ``'pair'``."""
    return 'heavy' if 'nano_conv' in tree.get('params', tree) else 'pair'


def flax_to_state_dict(tree: Mapping[str, Any], cfg: DenoiserConfig) -> Dict[str, torch.Tensor]:
    """The state_dict (f32, CPU) of the port's ``AntiTFNet`` or
    ``NanoAntiTFNet`` (``tree_kind``) from a Flax param tree
    (``{'params': ...}`` or the bare params)."""
    p = tree.get('params', tree)
    out: Dict[str, np.ndarray] = {}
    _leaf_params('aa_embed', p['aa_embed'], out)
    if tree_kind(p) == 'heavy':
        _tower('aa_encoder', p['aa_encoder'], out)
        _tower('nano_conv', p['nano_conv'], out)
    else:
        for name in ('aa_encoder', 'dual_conv'):
            _tower(f'{name}.h_tower', p[name]['h_tower'], out)
            _tower(f'{name}.l_tower', p[name]['l_tower'], out)
        _named('side_encoder', p['side_encoder'], _SIDE, out)
    _named('region_encoder', p['region_encoder'], _REGION, out)
    _named('pos_encoder.mlp', p['pos_encoder']['GatedMLP_0'],
           (('Dense_0', 'fc1'), ('Dense_1', 'fc2')), out)
    for i in range(cfg.cs_layers):
        blk = p['self_att'][f'block_{i}']
        dst = f'self_att.blocks.{i}'
        for att in ('attn', 'attn_c'):
            _named(f'{dst}.{att}', blk[att], (('qkv', 'qkv'), ('out', 'out')), out)
        _named(dst, blk, _ATT_BLOCK, out)
    _leaf_params('last_norm', p['last_norm'], out)
    _leaf_params('decoder', p['decoder'], out)
    return {k: torch.tensor(np.asarray(v, dtype=np.float32))
            for k, v in out.items()}


def from_flax_params(tree: Mapping[str, Any], cfg: DenoiserConfig,
                     dtype: torch.dtype = torch.float32, device='cuda'):
    """A loaded ``AntiTFNet`` or ``NanoAntiTFNet`` (eval mode) computing in
    ``dtype`` on ``device``."""
    device = resolve_device(device)
    model = model_class(tree_kind(tree))(cfg, dtype=dtype, device='cpu')
    model.load_state_dict(flax_to_state_dict(tree, cfg), strict=True)
    return model.to(device).eval()


def _host_state(module) -> Dict[str, Any]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def save(path: str, model: torch.nn.Module, cfg: DenoiserConfig,
         finetuned: bool = False) -> str:
    torch.save({'config': {'model': dataclasses.asdict(cfg), 'finetuned': finetuned,
                           'kind': model_kind(model)},
                'model': _host_state(model)}, path)
    return path


def load(path: str, dtype: torch.dtype = torch.float32,
         device='cuda') -> Tuple[torch.nn.Module, dict]:
    """(model in eval mode on ``device``, the checkpoint's config dict), from
    a ``save`` or a ``save_training`` file; the config's ``kind`` (default
    ``'pair'``) names the model."""
    return from_payload(torch.load(path, map_location='cpu', weights_only=True), dtype,
                        device)


def from_payload(payload: Mapping[str, Any], dtype: torch.dtype = torch.float32,
                 device='cuda') -> Tuple[torch.nn.Module, dict]:
    """``load`` of a payload already read."""
    device = resolve_device(device)
    cfg = DenoiserConfig.from_dict(payload['config']['model'])
    model = model_class(payload['config'].get('kind', 'pair'))(cfg, dtype=dtype,
                                                                device='cpu')
    model.load_state_dict({k: v.float() for k, v in payload['model'].items()},
                          strict=True)
    return model.to(device).eval(), payload['config']


def save_training(ckpt_dir: str, step: int, model: torch.nn.Module,
                  optimizer: torch.optim.Optimizer, config: Optional[dict] = None,
                  extra: Optional[dict] = None) -> str:
    """Write ``step_<step>.pt`` (model and optimizer state), its
    ``step_<step>.json`` metadata and the ``LATEST`` marker; returns the
    ``.pt`` path. ``config`` is plain data: ``{'model': ..., 'train': ...,
    'kind': ...}`` (a fine-tune's also ``'finetuned': True``, which the
    ``.pt`` file's config keeps for ``load``); the kind saved is the
    model's."""
    config = dict(config or {}, kind=model_kind(model))
    path = os.path.abspath(os.path.join(ckpt_dir, f'step_{step}.pt'))
    torch.save({'config': {'model': dict(config.get('model', {})),
                           'finetuned': bool(config.get('finetuned', False)),
                           'kind': config['kind']},
                'model': _host_state(model),
                'optimizer': optimizer.state_dict()}, path)
    meta = {'step': step, 'config': config, **(extra or {})}
    with open(os.path.join(ckpt_dir, f'step_{step}.json'), 'w') as f:
        json.dump(meta, f, indent=2, default=float)
    with open(os.path.join(ckpt_dir, 'LATEST'), 'w') as f:
        f.write(str(step))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step named by ``LATEST``, else the largest ``step_<n>.pt``."""
    marker = os.path.join(ckpt_dir, 'LATEST')
    if os.path.exists(marker):
        with open(marker) as f:
            return int(f.read().strip())
    steps = []
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            stem, ext = os.path.splitext(name)
            if stem.startswith('step_') and ext == '.pt' and stem[5:].isdigit():
                steps.append(int(stem[5:]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """``{'payload': {'config', 'model', 'optimizer'}, 'meta': ..., 'step':
    ..., 'kind': ...}`` of ``step`` (default: the latest), tensors on the
    CPU; ``model_class(kind)`` takes ``payload['model']``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f'no checkpoints under {ckpt_dir}')
    payload = torch.load(os.path.join(ckpt_dir, f'step_{step}.pt'), map_location='cpu',
                         weights_only=True)
    meta_path = os.path.join(ckpt_dir, f'step_{step}.json')
    meta = {'step': step}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return {'payload': payload, 'meta': meta, 'step': step,
            'kind': payload['config'].get('kind', 'pair')}


# ---------------------------------------------------------------------------
# Released reference checkpoints (copied from
# hudiff_tpu/training/checkpoints.py:93-331, numpy only)
# ---------------------------------------------------------------------------

def _strip_module_prefix(state_dict: dict) -> dict:
    """Drop DataParallel 'module.' prefixes (reference antibody_train.py:23-30)."""
    return {(k[7:] if k.startswith('module.') else k): v
            for k, v in state_dict.items()}


class TorchParamConverter:
    """Reference torch state_dict -> Flax param tree (numpy) helpers."""

    def __init__(self, state_dict: dict, nhead: int = 8):
        self.sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, 'detach') else v)
                   for k, v in _strip_module_prefix(state_dict).items()}
        self.nhead = nhead
        self.out: dict = {}

    def put(self, path: str, value: np.ndarray):
        node = self.out
        parts = path.split('/')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def dense(self, dst: str, src: str):
        self.put(dst + '/kernel', self.sd[src + '.weight'].T)
        if src + '.bias' in self.sd:
            self.put(dst + '/bias', self.sd[src + '.bias'])

    def _rope_permute(self, cols: int) -> np.ndarray:
        """Column permutation mapping the reference's interleaved RoPE pairs
        (2i, 2i+1) onto the rotate-half layout (i, D/2+i), per head. Scores
        are invariant to a consistent (q, k) pair permutation, so this
        preserves the model exactly."""
        d = cols // self.nhead
        per_head = np.concatenate([np.arange(0, d, 2), np.arange(1, d, 2)])
        return np.concatenate([h * d + per_head for h in range(self.nhead)])

    def qkv_dense(self, dst: str, src: str):
        """Merge the reference's query/key/value projections into one qkv
        Dense, head-major (per head [q_h | k_h | v_h]), q/k columns permuted
        into rotate-half order."""
        sd = self.sd
        ws, bs = [], []
        for part, permute in (('query', True), ('key', True), ('value', False)):
            w = sd[f'{src}.{part}.weight'].T         # [in, out]
            b = sd.get(f'{src}.{part}.bias')
            if permute:
                perm = self._rope_permute(w.shape[1])
                w = w[:, perm]
                b = None if b is None else b[perm]
            ws.append(w)
            bs.append(b if b is not None else np.zeros(w.shape[1], w.dtype))
        d_in, A = ws[0].shape
        hd = A // self.nhead
        # [in, A] x3 -> [in, H, 3, hd] -> [in, 3A] head-major
        wm = np.stack([w.reshape(d_in, self.nhead, hd) for w in ws], axis=2)
        bm = np.stack([b.reshape(self.nhead, hd) for b in bs], axis=1)
        self.put(dst + '/kernel', wm.reshape(d_in, 3 * A))
        self.put(dst + '/bias', bm.reshape(3 * A))

    def layernorm(self, dst: str, src: str):
        self.put(dst + '/scale', self.sd[src + '.weight'])
        self.put(dst + '/bias', self.sd[src + '.bias'])

    def conv1d(self, dst: str, src: str):
        # torch [out, in, k] -> flax [k, in, out]
        self.put(dst + '/kernel', self.sd[src + '.weight'].transpose(2, 1, 0))
        self.put(dst + '/bias', self.sd[src + '.bias'])

    def pff_conv(self, dst: str, src: str):
        # sequence_models PositionFeedForward = Conv1d(k=1): [out, in, 1]
        sd = self.sd
        w = sd[src + '.conv.weight'] if src + '.conv.weight' in sd else sd[src + '.weight']
        if w.ndim == 3:
            w = w[:, :, 0]
        self.put(dst + '/kernel', w.T)
        bias_key = src + '.conv.bias' if src + '.conv.bias' in sd else src + '.bias'
        if bias_key in sd:
            self.put(dst + '/bias', sd[bias_key])

    def bytenet_block(self, dst: str, src: str):
        # reference sequence1 = [LN, act, PFF, LN, act]; conv;
        # sequence2 = [LN, act, PFF]
        self.layernorm(dst + '/LayerNorm_0', src + '.sequence1.0')
        self.pff_conv(dst + '/Dense_0', src + '.sequence1.2')
        self.layernorm(dst + '/LayerNorm_1', src + '.sequence1.3')
        self.conv1d(dst + '/DilatedConv1d_0/Conv_0', src + '.conv')
        self.layernorm(dst + '/LayerNorm_2', src + '.sequence2.0')
        self.pff_conv(dst + '/Dense_1', src + '.sequence2.2')

    def att_layer(self, dst: str, src: str):
        self.qkv_dense(dst + '/qkv', src)
        self.dense(dst + '/out', src + '.out_put')

    def self_att(self, dst: str, src: str, n_layers: int):
        for i in range(n_layers):
            blk_src = f'{src}.layers.{i}'
            blk_dst = f'{dst}/block_{i}'
            self.att_layer(blk_dst + '/attn', blk_src + '.attn_hl')
            self.att_layer(blk_dst + '/attn_c', blk_src + '.attn_hl_c')
            self.layernorm(blk_dst + '/norm1', blk_src + '.norm_hl1')
            self.layernorm(blk_dst + '/norm2', blk_src + '.norm_hl2')
            self.dense(blk_dst + '/Dense_0', blk_src + '.ff_hl.0')
            self.dense(blk_dst + '/Dense_1', blk_src + '.ff_hl.2')

    def tower(self, dst: str, src_fmt: str, n_layers: int):
        for i in range(n_layers):
            self.bytenet_block(f'{dst}/ByteNetBlock_{i}', src_fmt.format(i))

    def count_layers(self, prefix: str) -> int:
        n = 0
        while any(k.startswith(f'{prefix}.{n}.') for k in self.sd):
            n += 1
        return n


def convert_torch_denoiser(state_dict: dict, pair: bool = True, nhead: int = 8) -> dict:
    """A reference AntiTFNet (``pair``) or NanoAntiTFNet torch state_dict as
    the JAX package's Flax param tree, ``{'params': ...}`` of numpy arrays;
    ``nhead`` permutes the query/key columns into the rotate-half layout."""
    c = TorchParamConverter(state_dict, nhead=nhead)
    sd = c.sd
    put, dense, layernorm = c.put, c.dense, c.layernorm
    pff_conv, self_att, tower, count_layers = c.pff_conv, c.self_att, c.tower, c.count_layers

    put('aa_embed/embedding', sd['aa_encoder.embedder.weight'])
    if pair:
        n_enc = count_layers('aa_encoder.h_layers')
        tower('aa_encoder/h_tower', 'aa_encoder.h_layers.{}', n_enc)
        tower('aa_encoder/l_tower', 'aa_encoder.l_layers.{}', n_enc)
        put('side_encoder/Embed_0/embedding', sd['side_encoder.side_embeddinng.weight'])
        dense('side_encoder/Dense_0', 'side_encoder.side_mlp.0')
        layernorm('side_encoder/LayerNorm_0', 'side_encoder.side_mlp.1')
        dense('side_encoder/Dense_1', 'side_encoder.side_mlp.3')
        n_dual = count_layers('dual_conv_block.h_layers')
        tower('dual_conv/h_tower', 'dual_conv_block.h_layers.{}', n_dual)
        tower('dual_conv/l_tower', 'dual_conv_block.l_layers.{}', n_dual)
    else:
        n_enc = count_layers('aa_encoder.layers')
        tower('aa_encoder', 'aa_encoder.layers.{}', n_enc)
        n_dual = count_layers('nano_conv_block.layers')
        tower('nano_conv', 'nano_conv_block.layers.{}', n_dual)

    put('region_encoder/Embed_0/embedding', sd['region_encoder.region_embedding.weight'])
    layernorm('region_encoder/LayerNorm_0', 'region_encoder.region_layer1.0')
    pff_conv('region_encoder/Dense_0', 'region_encoder.region_layer1.2')
    layernorm('region_encoder/LayerNorm_1', 'region_encoder.region_layer1.3')

    dense('pos_encoder/GatedMLP_0/Dense_0', 'pos_encoder.pos_lin.ln1')
    dense('pos_encoder/GatedMLP_0/Dense_1', 'pos_encoder.pos_lin.ln2')

    self_att('self_att', 'self_at', count_layers('self_at.layers'))
    layernorm('last_norm', 'last_norm')
    dense('decoder', 'decoder')
    return {'params': c.out}


def _ensure_unpickle_shims() -> None:
    """Released reference checkpoints carry pickled ``easydict.EasyDict``
    configs (reference antibody_train.py:4, :342), so unpickling needs that
    class importable. When the easydict package is absent, register a
    pickle-compatible shim: a dict subclass with attribute access under the
    same module path and class name."""
    import sys
    import types
    try:
        import easydict  # noqa: F401 - the real package wins when present
        return
    except ImportError:
        pass
    if 'easydict' in sys.modules:
        return

    class EasyDict(dict):
        """Pickle-compatible stand-in for easydict.EasyDict."""

        def __getattr__(self, key):
            try:
                return self[key]
            except KeyError as e:
                raise AttributeError(key) from e

        def __setattr__(self, key, value):
            self[key] = value

    EasyDict.__module__ = 'easydict'
    EasyDict.__qualname__ = 'EasyDict'  # pickle resolves module + qualname
    mod = types.ModuleType('easydict')
    mod.EasyDict = EasyDict
    sys.modules['easydict'] = mod


def load_torch_checkpoint(path: str) -> dict:
    """A released reference checkpoint (pickled EasyDict configs included),
    on the CPU. ``weights_only=False``: read only files you trust."""
    _ensure_unpickle_shims()
    return torch.load(path, map_location='cpu', weights_only=False)


def load_payload(path: str) -> dict:
    """A ``.pt``/``.ckpt`` payload on the CPU: read as plain data
    (``weights_only=True``, the port's own files and plain released ones),
    else, when it holds pickled objects, by ``load_torch_checkpoint``."""
    try:
        return torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError:
        return load_torch_checkpoint(path)


def is_port_payload(payload: Mapping[str, Any]) -> bool:
    """True for a file ``save``/``save_training`` wrote (its state_dict has
    the port's names), False for a released reference payload."""
    return 'aa_embed.weight' in payload.get('model', {})
