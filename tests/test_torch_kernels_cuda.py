"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda`` and skips
without a card. The file imports neither JAX nor ``hudiff_tpu``, so on a
machine with a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: f32 runs the same arithmetic in another summation order
(errors ~1e-6), held to an absolute limit. bf16 is held elementwise to
|out - ref| <= 2**-7 |ref| + atol: both sides round the output to bf16 and
may round it one spacing apart (the 2**-7 |ref| term); atol bounds the
rest, which comes from P (K1, K3), the intermediates p, q (K2) or dq, dp
(K4) rounded to bf16 at nearby points. K4's parameter gradients (f32 sums
over B*L rows) are held by max |err| <= rtol max |ref|. K5, K6 and K7 run
K1's and K3's arithmetic in other layouts and take their limits; K8 adds
the projections' rounding of qkv and o. chip_smoke.py holds the main
path's shapes to the same limits.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.models.denoiser import AntiTFNet, DenoiserConfig, NanoAntiTFNet, nano_config
from hudiff_tpu_torch.ops import _build
from hudiff_tpu_torch.ops import fused_attention as FA
from hudiff_tpu_torch.ops import fused_bytenet as FB
from hudiff_tpu_torch.ops.bytenet import ByteNetBlock
from hudiff_tpu_torch.ops import masking as M
from hudiff_tpu_torch.ops.rope import apply_rope, rope_tables
from hudiff_tpu_torch.sampling import humanize as HZ
from hudiff_tpu_torch.tools import fused_layer_probe as FL
from hudiff_tpu_torch.training import train_step as T

pytestmark = pytest.mark.cuda

BF16_RTOL = 2.0 ** -7


def excess(out, ref, rtol):
    """max(|out - ref| - rtol |ref|): 0 where the output is within rtol."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() - rtol * ref.abs()).max().item()


H1 = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
      'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYYFDYWGQGTTLTVSS')
L1 = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
      'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU mode)')
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield torch.device('cuda')


@pytest.mark.parametrize('dtype,rtol,atol', [(torch.float32, 0.0, 1e-5),
                                             (torch.bfloat16, BF16_RTOL, 5e-3)])
@pytest.mark.parametrize('L', [17, 291])
def test_k1_matches_plain(dev, dtype, rtol, atol, L):
    gen = torch.Generator().manual_seed(L)
    qkv = torch.randn(3, L, 8 * 3 * 64, generator=gen).to(dev, dtype)
    cos, sin = rope_tables(64, L, device=dev)
    before = FA.launches
    out = FA.rope_attention_qkv(qkv, cos, sin, 0.125, 8)
    ref = FA.rope_attention_qkv_reference(qkv, cos, sin, 0.125, 8)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    assert torch.isfinite(out).all()
    err = excess(out, ref, rtol)
    assert err <= atol, f'excess {err} over rtol {rtol}'


def _block(d, h, k, dil, act, gen):
    torch.manual_seed(int(torch.randint(2 ** 31, (1,), generator=gen)))
    blk = ByteNetBlock(d, h, k, dilation=dil, activation=act)
    with torch.no_grad():
        for ln in (blk.ln1, blk.ln2, blk.ln3):
            ln.weight.add_(0.1 * torch.randn(ln.weight.shape, generator=gen))
            ln.bias.add_(0.1 * torch.randn(ln.bias.shape, generator=gen))
    return blk


@pytest.mark.parametrize('dtype,rtol,atol', [(torch.float32, 0.0, 2e-5),
                                             (torch.bfloat16, BF16_RTOL, 2.5e-2)])
@pytest.mark.parametrize('d,h,k,act,L,dil', [(768, 384, 7, 'relu', 152, 1),
                                             (768, 384, 7, 'relu', 139, 32),
                                             (256, 128, 7, 'gelu', 152, 16),
                                             (512, 256, 7, 'gelu', 152, 8),
                                             (192, 96, 13, 'relu', 139, 2),
                                             (64, 32, 13, 'gelu', 152, 1)])
def test_k2_matches_plain(dev, dtype, rtol, atol, d, h, k, act, L, dil):
    gen = torch.Generator().manual_seed(d + L + dil)
    blk = _block(d, h, k, dil, act, gen).to(dev)
    args = [t.detach().to(dtype) if t.dim() >= 2 else t.detach()
            for t in (blk.ln1.weight, blk.ln1.bias, blk.fc1.weight, blk.fc1.bias,
                      blk.ln2.weight, blk.ln2.bias, blk.conv.weight, blk.conv.bias,
                      blk.ln3.weight, blk.ln3.bias, blk.fc2.weight, blk.fc2.bias)]
    x = torch.randn(3, L, d, generator=gen).to(dev, dtype)
    before = FB.launches
    out = FB.bytenet_block(x, *args, dilation=dil, activation_name=act)
    ref = FB.bytenet_block_reference(x, *args, dilation=dil, activation_name=act)
    torch.cuda.synchronize()
    assert FB.launches == before + 3   # three GEMMs, the LayerNorms folded in
    assert torch.isfinite(out).all()
    err = excess(out, ref, rtol)
    assert err <= atol, f'excess {err} over rtol {rtol}'


def _block_args(blk, dtype):
    """The block's parameters as K2's callers pass them: weights in x's type."""
    return [t.detach().to(dtype) if t.dim() >= 2 else t.detach()
            for t in (blk.ln1.weight, blk.ln1.bias, blk.fc1.weight, blk.fc1.bias,
                      blk.ln2.weight, blk.ln2.bias, blk.conv.weight, blk.conv.bias,
                      blk.ln3.weight, blk.ln3.bias, blk.fc2.weight, blk.fc2.bias)]


K4_GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}

# the humanization forward's dual-tower shape; L = 17 with dilation 32 (every
# tap but the centre outside the chain); 185 rows, which no tile size
# divides; the narrowest hidden width (32) and the widest block (D = 1024,
# H = 512)
EDGE_SHAPES = [(16, 152, 768, 384, 7, 'relu', 4), (3, 17, 64, 32, 7, 'gelu', 32),
               (5, 37, 96, 64, 13, 'relu', 3), (2, 41, 64, 32, 7, 'relu', 1),
               (2, 41, 1024, 512, 7, 'gelu', 2)]


@pytest.mark.parametrize('dtype,rtol,atol', [(torch.float32, 0.0, 2e-5),
                                             (torch.bfloat16, BF16_RTOL, 2.5e-2)])
@pytest.mark.parametrize('B,L,d,h,k,act,dil', EDGE_SHAPES)
def test_k2_repeats_and_edge_shapes(dev, dtype, rtol, atol, B, L, d, h, k, act, dil):
    """K2 at the edge shapes against its plain version, and the same bits on
    a repeat (fixed-order statistics, no atomics)."""
    gen = torch.Generator().manual_seed(B * L + d + dil)
    args = _block_args(_block(d, h, k, dil, act, gen).to(dev), dtype)
    x = torch.randn(B, L, d, generator=gen).to(dev, dtype)
    kw = dict(dilation=dil, activation_name=act)
    before = FB.launches
    out = FB.bytenet_block(x, *args, **kw)
    again = FB.bytenet_block(x, *args, **kw)
    ref = FB.bytenet_block_reference(x, *args, **kw)
    torch.cuda.synchronize()
    assert FB.launches == before + 6
    assert torch.isfinite(out).all() and torch.equal(out, again)
    err = excess(out, ref, rtol)
    assert err <= atol, f'excess {err} over rtol {rtol}'


@pytest.mark.parametrize('dtype,rtol,atol', [(torch.float32, 0.0, 2e-5),
                                             (torch.bfloat16, BF16_RTOL, 1.5e-2)])
@pytest.mark.parametrize('B,L,d,h,k,act,dil', EDGE_SHAPES[1:])
def test_k4_edge_shapes(dev, dtype, rtol, atol, B, L, d, h, k, act, dil):
    """K4 at the edge shapes against its plain version; the weights in x's
    type (the forward's copies, as ByteNetBlockFn passes them) give the
    same bits as the f32 weights, which the wrapper rounds."""
    gen = torch.Generator().manual_seed(B * L + d + dil + 1)
    blk = _block(d, h, k, dil, act, gen).to(dev)
    params = _block_args(blk, torch.float32)
    x = torch.randn(B, L, d, generator=gen).to(dev, dtype)
    dy = torch.randn(B, L, d, generator=gen).to(dev, dtype)
    kw = dict(dilation=dil, activation_name=act)
    _, p, q, _ = FB._forward(x, params, dil, act, keep=True)
    before = FB.bwd_launches
    grads = FB.bytenet_block_backward(x, p, q, *params, dy, **kw)
    cast = FB.bytenet_block_backward(x, p, q, *_block_args(blk, dtype), dy, **kw)
    ref = FB.bytenet_block_backward_reference(x, p, q, *params, dy, **kw)
    torch.cuda.synchronize()
    assert FB.bwd_launches == before + 10
    assert all(torch.equal(a, b) for a, b in zip(grads, cast))
    assert all(torch.isfinite(g).all() for g in grads)
    err = excess(grads[0], ref[0], rtol)
    assert err <= atol, f'dx excess {err} over rtol {rtol}'
    for i, (got, want) in enumerate(zip(grads[1:], ref[1:])):
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel <= K4_GRAD_RTOL[dtype], f'parameter {i}: {rel}'


@pytest.mark.parametrize('dtype,rtol,atol', [(torch.float32, 0.0, 2e-5),
                                             (torch.bfloat16, BF16_RTOL, 1.5e-2)])
@pytest.mark.parametrize('B,L,d,h,k,act,dil', [(4, 152, 768, 384, 7, 'relu', 1),
                                               (3, 37, 256, 128, 7, 'gelu', 4)])
def test_k2_statistics_and_k4_given_them(dev, dtype, rtol, atol, B, L, d, h, k, act, dil):
    """K2 keeping p and q also writes the LayerNorm statistics of x, p and q
    rows (against the same rows' in f32: 1e-5 of the mean's scale, 1e-5
    relative for 1/sigma) without changing y; K4 given them against the
    plain backward given them, the same limits as without, and the same
    bits on a repeat."""
    gen = torch.Generator().manual_seed(B * L + d)
    params = _block_args(_block(d, h, k, dil, act, gen).to(dev), torch.float32)
    x = torch.randn(B, L, d, generator=gen).to(dev, dtype)
    dy = torch.randn(B, L, d, generator=gen).to(dev, dtype)
    kw = dict(dilation=dil, activation_name=act)
    y, p, q, st = FB._forward(x, params, dil, act, keep=True)
    assert st.shape == (3, B, L, 2) and st.dtype == torch.float32
    assert torch.equal(y, FB.bytenet_block(x, *params, **kw))
    for i, z in enumerate((x, p, q)):
        zf = z.float()
        mu = zf.mean(-1)
        inv = torch.rsqrt(((zf * zf).mean(-1) - mu * mu).clamp_min(0.0) + FB.LN_EPS)
        assert (st[i, ..., 0] - mu).abs().max().item() <= 1e-5 * max(1.0, mu.abs().max().item())
        assert ((st[i, ..., 1] - inv).abs() / inv).max().item() <= 1e-5
    before = FB.bwd_launches
    got = FB.bytenet_block_backward(x, p, q, *params, dy, **kw, stats=st)
    again = FB.bytenet_block_backward(x, p, q, *params, dy, **kw, stats=st)
    ref = FB.bytenet_block_backward_reference(x, p, q, *params, dy, **kw, stats=st)
    torch.cuda.synchronize()
    assert FB.bwd_launches == before + 10
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    err = excess(got[0], ref[0], rtol)
    assert err <= atol, f'dx excess {err} over rtol {rtol}'
    for i, (a, b) in enumerate(zip(got[1:], ref[1:])):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        assert rel <= K4_GRAD_RTOL[dtype], f'parameter {i}: {rel}'


@pytest.mark.parametrize('dtype,rtol,atol', [(torch.float32, 0.0, 1e-5),
                                             (torch.bfloat16, BF16_RTOL, 5e-3)])
@pytest.mark.parametrize('B,L', [(3, 17), (2, 291)])
def test_k3_matches_plain(dev, dtype, rtol, atol, B, L):
    gen = torch.Generator().manual_seed(B * L)
    qkv = torch.randn(B, L, 8 * 3 * 64, generator=gen).to(dev, dtype)
    do = torch.randn(B, L, 8 * 64, generator=gen).to(dev, dtype)
    cos, sin = rope_tables(64, L, device=dev)
    before = FA.bwd_launches
    out = FA.rope_attention_qkv_backward(qkv, cos, sin, do, 0.125, 8)
    again = FA.rope_attention_qkv_backward(qkv, cos, sin, do, 0.125, 8)
    ref = FA.rope_attention_qkv_backward_reference(qkv, cos, sin, do, 0.125, 8)
    torch.cuda.synchronize()
    assert FA.bwd_launches == before + 6   # three launches per call: prologue, dq, dk and dv
    assert torch.isfinite(out).all() and torch.equal(out, again)   # no atomics
    err = excess(out, ref, rtol)
    assert err <= atol, f'excess {err} over rtol {rtol}'


@pytest.mark.parametrize('dtype,rtol,atol', [(torch.float32, 0.0, 2e-5),
                                             (torch.bfloat16, BF16_RTOL, 1.5e-2)])
@pytest.mark.parametrize('d,h,k,act,B,L,dil', [(64, 32, 7, 'gelu', 3, 17, 2),
                                               (96, 64, 13, 'relu', 3, 17, 1),
                                               (768, 384, 7, 'relu', 4, 139, 32),
                                               (256, 128, 7, 'gelu', 4, 152, 4),
                                               (512, 256, 7, 'gelu', 4, 152, 2)])
def test_k4_matches_plain(dev, dtype, rtol, atol, d, h, k, act, B, L, dil):
    gen = torch.Generator().manual_seed(d + L + dil)
    blk = _block(d, h, k, dil, act, gen).to(dev)
    params = [t.detach() for t in (blk.ln1.weight, blk.ln1.bias, blk.fc1.weight,
                                   blk.fc1.bias, blk.ln2.weight, blk.ln2.bias,
                                   blk.conv.weight, blk.conv.bias, blk.ln3.weight,
                                   blk.ln3.bias, blk.fc2.weight, blk.fc2.bias)]
    x = torch.randn(B, L, d, generator=gen).to(dev, dtype)
    dy = torch.randn(B, L, d, generator=gen).to(dev, dtype)
    kw = dict(dilation=dil, activation_name=act)
    before = FB.launches, FB.bwd_launches
    y, p, q, _ = FB._forward(x, params, dil, act, keep=True)
    grads = FB.bytenet_block_backward(x, p, q, *params, dy, **kw)
    again = FB.bytenet_block_backward(x, p, q, *params, dy, **kw)
    ref = FB.bytenet_block_backward_reference(x, p, q, *params, dy, **kw)
    torch.cuda.synchronize()
    assert (FB.launches, FB.bwd_launches) == (before[0] + 3, before[1] + 10)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))   # fixed-order sums
    assert all(torch.isfinite(g).all() for g in grads)
    err = excess(grads[0], ref[0], rtol)
    assert err <= atol, f'dx excess {err} over rtol {rtol}'
    for i, (got, want) in enumerate(zip(grads[1:], ref[1:])):
        assert got.shape == params[i].shape and got.dtype == torch.float32
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel <= K4_GRAD_RTOL[dtype], f'parameter {i}: {rel}'


def test_counters_match_the_kernels_the_profiler_sees(dev):
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 33, 8 * 3 * 64, generator=gen).to(dev, torch.bfloat16)
    cos, sin = rope_tables(64, 33, device=dev)
    blk = _block(64, 32, 7, 2, 'gelu', gen).to(dev)
    x = torch.randn(2, 33, 64, generator=gen).to(dev, torch.bfloat16)
    leaf = qkv.clone().requires_grad_()
    k1, k2, k3 = FA.launches, FB.launches, FA.bwd_launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            FA.rope_attention_qkv(qkv, cos, sin, 0.125, 8)
            blk(x)
        # under autograd: K1 writing the residuals, then K3's three kernels
        FA.rope_attention_qkv(leaf, cos, sin, 0.125, 8).float().sum().backward()
        torch.cuda.synchronize()
    seen = {'K1': 0, 'K2': 0, 'K3': 0}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if 'rope_attention_qkv_kernel' in e.key:
                seen['K1'] += e.count
            elif 'bytenet_fwd_gemm_kernel' in e.key:
                seen['K2'] += e.count
            elif 'rope_attention_bwd_' in e.key:
                seen['K3'] += e.count
    counted = {'K1': FA.launches - k1, 'K2': FB.launches - k2, 'K3': FA.bwd_launches - k3}
    assert seen == counted == {'K1': 2, 'K2': 3, 'K3': 3}


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    qkv = torch.randn(1, 5, 8 * 3 * 32, device=dev)
    cos, sin = rope_tables(32, 5, device=dev)
    with pytest.raises(ValueError, match='head dim'):
        FA.rope_attention_qkv(qkv, cos, sin, 0.125, 8)
    qkv = torch.randn(1, 5, 1536, device=dev)
    with pytest.raises(ValueError, match='do must be'):
        FA.rope_attention_qkv_backward(qkv, *rope_tables(64, 5, device=dev),
                                       torch.randn(1, 5, 256, device=dev), 0.125, 8)
    with pytest.raises(ValueError, match='lse must be'):
        FA.rope_attention_qkv_backward(qkv, *rope_tables(64, 5, device=dev),
                                       torch.randn(1, 5, 512, device=dev), 0.125, 8,
                                       out=torch.zeros(1, 5, 512, device=dev),
                                       lse=torch.zeros(1, 5, 8, device=dev))
    with pytest.raises(ValueError, match="forward's f32 output"):
        FA.rope_attention_qkv_backward(qkv.bfloat16(), *rope_tables(64, 5, device=dev),
                                       torch.randn(1, 5, 512, device=dev), 0.125, 8,
                                       out=torch.zeros(1, 5, 512, device=dev).bfloat16(),
                                       lse=torch.zeros(1, 8, 5, device=dev))
    blk = _block(48, 24, 7, 1, 'relu', torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad(), pytest.raises(ValueError, match='multiples of 32'):
        blk(torch.randn(1, 10, 48, device=dev))
    with pytest.raises(ValueError, match='multiples of 32'):   # the backward too
        blk(torch.randn(1, 10, 48, device=dev, requires_grad=True))


def test_test_size_forward_matches_cpu(dev):
    """f32 logits of the test-size model (aa_kernel_size 13) on the card
    against the CPU's plain path; atol 1e-4."""
    torch.manual_seed(0)
    model = AntiTFNet(DenoiserConfig().test_size()).eval()
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, C.N_TOKENS, (2, C.PAIR_LEN))).long()
    region = torch.from_numpy(np.tile(np.concatenate(
        [C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]), (2, 1))).long()
    chain = torch.tensor([[0, 1], [0, 2]])
    with torch.inference_mode():
        ref = model(tokens, region, chain)
        out = model.to(dev)(tokens.to(dev), region.to(dev), chain.to(dev)).cpu()
    assert (out - ref).abs().max().item() <= 1e-4


def test_humanize_on_card_keeps_cdrs_and_runs_the_kernels(dev):
    torch.manual_seed(1)
    hum = HZ.PairHumanizer(AntiTFNet(DenoiserConfig().test_size(), dtype=torch.bfloat16),
                           batch_size=4, seed=3, device='cuda')
    inp = HZ.pair_input(H1, L1)
    k1, k2 = FA.launches, FB.launches
    res = hum(H1, L1)
    steps = HZ._bucket_order_width(len(inp['positions']), inp['pad_to'])
    assert FA.launches - k1 == 2 * steps          # cs_layers = 1: two attentions
    # two chains x (1 aa + 2 dual) blocks, three kernels each
    assert FB.launches - k2 == 2 * (1 + 2) * 3 * steps
    cdr = np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX]) != 0
    assert (res['grids'] != C.IDX_MSK).all()
    assert (res['grids'][:, cdr] == inp['clean'][cdr]).all()


def test_k2_sampler_on_card_matches_cpu_when_logits_are_peaked(dev):
    """Two positions per forward (ceil(K / 2) forwards of the test-size f32
    model through K1 and K2) on the card against the same sampler on the
    CPU: the model's logits plus 1e4 at a token that depends on the whole
    current grid, so both draw the same tokens whatever their random
    numbers. Rows with other mask counts, an all -1 row, K odd."""
    from hudiff_tpu_torch.sampling import sampler as S
    torch.manual_seed(0)
    model = AntiTFNet(DenoiserConfig().test_size()).eval()
    rs = np.random.RandomState(2)
    B = 4
    tokens = torch.from_numpy(rs.randint(0, 22, (B, C.PAIR_LEN))).long()
    region = torch.from_numpy(np.tile(np.concatenate(
        [C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]), (B, 1))).long()
    chain = torch.tensor([[0, 1], [0, 2]] * (B // 2))
    order = torch.from_numpy(S.build_order_rows(
        [rs.choice(C.PAIR_LEN, n, replace=False) for n in (15, 9, 0, 4)],
        rng=3, pad_to=15)).long()

    def peaked(t, region, chain):
        tgt = (t.sum(dim=1, keepdim=True) + torch.arange(t.shape[1], device=t.device)) % 22
        return model(t, region, chain) + 1e4 * F.one_hot(tgt, C.N_TOKENS).float()

    sample = S.make_scan_sampler(peaked, positions_per_step=2)
    ref = sample(tokens, order, torch.Generator().manual_seed(0), region, chain)
    model.to(dev)
    k1, k2 = FA.launches, FB.launches
    out = sample(tokens.to(dev), order.to(dev), torch.Generator(device=dev).manual_seed(1),
                 region.to(dev), chain.to(dev)).cpu()
    assert FA.launches - k1 == 2 * 8               # 8 forwards, two attentions each
    assert FB.launches - k2 == 2 * (1 + 2) * 3 * 8
    assert torch.equal(out, ref)
    assert torch.equal(out[2], tokens[2]) and not torch.equal(out, tokens)


def test_test_size_train_step_matches_cpu(dev):
    """One f32 train step of the test-size model (dropout off, a fixed
    mask, TF32 off) on the card against the CPU: the loss to 1e-5 relative
    and every parameter's gradient to max |err| <= 1e-4 max |ref| (the
    same arithmetic through K1-K4 and cuBLAS in other summation orders)."""
    torch.manual_seed(0)
    cpu = AntiTFNet(DenoiserConfig().test_size()).eval()
    card = AntiTFNet(DenoiserConfig().test_size()).eval()
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, C.N_AA, (2, C.PAIR_LEN)))
    mask = torch.from_numpy(rs.rand(2, C.PAIR_LEN) < 0.5)
    mask &= ~torch.from_numpy(np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX]) != 0)
    cor = M.Corrupted(torch.where(mask, C.IDX_MSK, tokens), mask, mask.sum(-1))
    chain = torch.tensor([[0, 1], [0, 2]])
    grads = []
    for model, d in ((cpu, 'cpu'), (card, dev)):
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        state = T.TrainState(model, opt)
        keep = {}
        for n, prm in model.named_parameters():
            prm.register_post_accumulate_grad_hook(
                lambda t, n=n: keep.__setitem__(n, t.grad.detach().cpu().clone()))
        k = (FA.launches, FA.bwd_launches, FB.launches, FB.bwd_launches)
        m = T.make_pair_train_step(model)(state, tokens.to(d), chain.to(d), 0,
                                          M.Corrupted(*(t.to(d) for t in cor)))
        if d == dev:
            assert (FA.launches - k[0], FA.bwd_launches - k[1]) == (2, 6)
            assert (FB.launches - k[2], FB.bwd_launches - k[3]) == (6 * 3, 6 * 5)
        grads.append((m['loss'].item(), keep))
    (loss_c, g_c), (loss_g, g_g) = grads
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    assert sorted(g_c) == sorted(g_g)
    for n in g_c:
        rel = ((g_g[n] - g_c[n]).abs().max() / g_c[n].abs().max().clamp_min(1e-30)).item()
        assert rel <= 1e-4, f'{n}: {rel}'


VHH = ('QVQLVESGGGLVQAGGSLRLSCAASGRTFSSYAMGWFRQAPGKEREFVAAISWSGGSTYYADSVKGRF'
       'TISRDNAKNTVYLQMNSLKPEDTAVYYCAADRGSYYYTRNQYDYWGQGTQVTVSS')


def test_test_size_nano_forward_matches_cpu(dev):
    """f32 logits of the test-size NanoAntiTFNet on the card against the
    CPU's plain path; atol 1e-4."""
    torch.manual_seed(0)
    model = NanoAntiTFNet(nano_config().test_size()).eval()
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, C.N_TOKENS,
                                                               (2, C.HEAVY_LEN))).long()
    region = torch.from_numpy(np.tile(C.HEAVY_REGION_INDEX, (2, 1))).long()
    with torch.inference_mode():
        ref = model(tokens, region)
        out = model.to(dev)(tokens.to(dev), region.to(dev)).cpu()
    assert (out - ref).abs().max().item() <= 1e-4


def test_nano_humanize_on_card_keeps_cdrs_and_runs_the_kernels(dev):
    torch.manual_seed(1)
    hum = HZ.NanoHumanizer(NanoAntiTFNet(nano_config().test_size(), dtype=torch.bfloat16),
                           batch_size=4, seed=3, device='cuda')
    inp = HZ.nano_input(VHH)
    k1, k2 = FA.launches, FB.launches
    rows = hum.sample_rows([inp] * 4, len(inp['positions']))
    steps = len(inp['positions'])
    assert steps == 93
    assert FA.launches - k1 == 2 * steps          # cs_layers = 1: two attentions
    assert FB.launches - k2 == (1 + 2) * 3 * steps   # 1 aa + 2 nano_conv blocks, 3 kernels
    cdr = C.HEAVY_CDR_INDEX != 0
    keep = inp['tokens'] != C.IDX_MSK
    assert (rows != C.IDX_MSK).all()
    assert (rows[:, cdr] == inp['clean'][cdr]).all()
    assert (rows[:, keep] == inp['tokens'][keep]).all()


def test_test_size_heavy_train_step_matches_cpu(dev):
    """One f32 heavy train step of the test-size NanoAntiTFNet (dropout
    off, a fixed mask, TF32 off) on the card against the CPU: the loss to
    1e-5 relative and every parameter's gradient to max |err| <= 1e-4
    max |ref|, as the pair step is held."""
    torch.manual_seed(0)
    cpu = NanoAntiTFNet(nano_config().test_size()).eval()
    card = NanoAntiTFNet(nano_config().test_size()).eval()
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, C.N_AA, (2, C.HEAVY_LEN)))
    mask = torch.from_numpy(rs.rand(2, C.HEAVY_LEN) < 0.5)
    mask &= ~torch.from_numpy(C.HEAVY_CDR_INDEX != 0)
    cor = M.Corrupted(torch.where(mask, C.IDX_MSK, tokens), mask, mask.sum(-1))
    grads = []
    for model, d in ((cpu, 'cpu'), (card, dev)):
        state = T.TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
        keep = {}
        for n, prm in model.named_parameters():
            prm.register_post_accumulate_grad_hook(
                lambda t, n=n: keep.__setitem__(n, t.grad.detach().cpu().clone()))
        k = (FA.launches, FA.bwd_launches, FB.launches, FB.bwd_launches)
        m = T.make_heavy_train_step(model)(state, tokens.to(d), 0,
                                           M.Corrupted(*(t.to(d) for t in cor)))
        if d == dev:
            assert (FA.launches - k[0], FA.bwd_launches - k[1]) == (2, 6)
            assert (FB.launches - k[2], FB.bwd_launches - k[3]) == (3 * 3, 3 * 5)
        grads.append((m['loss'].item(), keep))
    (loss_c, g_c), (loss_g, g_g) = grads
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    assert sorted(g_c) == sorted(g_g)
    for n in g_c:
        rel = ((g_g[n] - g_c[n]).abs().max() / g_c[n].abs().max().clamp_min(1e-30)).item()
        assert rel <= 1e-4, f'{n}: {rel}'


def test_test_size_nano_finetune_step_matches_cpu(dev, monkeypatch):
    """One f32 Nb fine-tune step of the test-size NanoAntiTFNet with two
    smoke-size AbNatiV scorers (dropout off, a fixed mask and fixed Gumbel
    uniforms, TF32 off) on the card against the CPU: the loss to 1e-5
    relative, every parameter's gradient to max |err| <= 1e-4 max |ref|,
    the same Gumbel hard choices, and the launches of chip_smoke.py's
    finetune_step_f32_nano at this size (K1 2, K3 6, K2 3 x 3, K4 3 x 5)."""
    from hudiff_tpu_torch.models import finetune as FM
    from hudiff_tpu_torch.ops import scheme_transfer as ST
    from hudiff_tpu_torch.training import finetune as FT
    torch.manual_seed(0)
    cpu = NanoAntiTFNet(nano_config().test_size()).eval()
    card = NanoAntiTFNet(nano_config().test_size()).eval()
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    batch = next(FT.synthetic_nano_batches(2, 0))
    tokens, aho = torch.from_numpy(batch['tokens']).long(), torch.from_numpy(batch['aho'])
    rs = np.random.RandomState(1)
    protected = (C.HEAVY_CDR_INDEX != 0)[None] | (batch['tokens'] == C.IDX_PAD)
    protected[:, 150:] = True
    mask = torch.from_numpy((rs.rand(2, C.HEAVY_LEN) < 0.5) & ~protected)
    cor = M.Corrupted(torch.where(mask, C.IDX_MSK, tokens), mask, mask.sum(-1))
    u = torch.from_numpy(rs.rand(2, C.HEAVY_LEN, C.N_AA).astype(np.float32))
    hard, drawn = [], ST.gumbel_straight_through

    def recording(*a, **kw):
        out = drawn(*a, **kw)
        hard.append(out.detach().argmax(-1).cpu())
        return out

    monkeypatch.setattr(ST, 'gumbel_straight_through', recording)
    results = []
    for model, d in ((cpu, 'cpu'), (card, dev)):
        vh, vhh = (FT.load_abnativ(None, False, seed=s, device=d) for s in (1, 2))
        step, _ = FT.make_nano_finetune_fns(
            FM.make_nano_finetune_loss(model, vh, FM.NanoFinetuneConfig(), vhh), False, 1e-3)
        state = T.TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
        keep = {}
        for n, prm in model.named_parameters():
            prm.register_post_accumulate_grad_hook(
                lambda t, n=n: keep.__setitem__(n, t.grad.detach().cpu().clone()))
        k = (FA.launches, FA.bwd_launches, FB.launches, FB.bwd_launches)
        m = step(state, tokens.to(d), aho.to(d), 0,
                 corrupted=M.Corrupted(*(t.to(d) for t in cor)), u=u.to(d))
        if d == dev:
            assert (FA.launches - k[0], FA.bwd_launches - k[1]) == (2, 6)
            assert (FB.launches - k[2], FB.bwd_launches - k[3]) == (3 * 3, 3 * 5)
        results.append((m['loss'].item(), keep))
    (loss_c, g_c), (loss_g, g_g) = results
    assert torch.equal(hard[0], hard[1])
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    assert sorted(g_c) == sorted(g_g)
    for n in g_c:
        rel = ((g_g[n] - g_c[n]).abs().max() / g_c[n].abs().max().clamp_min(1e-30)).item()
        assert rel <= 1e-4, f'{n}: {rel}'


def _qkvd(B, L, dtype, dev, seed, n=4):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(B, L, 8 * 64, generator=gen).to(dev, dtype) for _ in range(n)]


@pytest.mark.parametrize('dtype,rtol,atol', [(torch.float32, 0.0, 1e-5),
                                             (torch.bfloat16, BF16_RTOL, 5e-3)])
@pytest.mark.parametrize('B,L', [(3, 17), (2, 291), (8, 291)])
def test_k5_matches_plain_and_k1(dev, dtype, rtol, atol, B, L):
    q, k, v = _qkvd(B, L, dtype, dev, B * L, 3)
    cos, sin = rope_tables(64, L, device=dev)
    before = FA.rope_launches
    out = FA.rope_attention(q, k, v, cos, sin, 0.125, 8)
    again = FA.rope_attention(q, k, v, cos, sin, 0.125, 8)
    ref = FA.rope_attention_reference(q, k, v, cos, sin, 0.125, 8)
    k1 = FA.rope_attention_qkv(FA.merge_qkv_heads(q, k, v, 8), cos, sin, 0.125, 8)
    torch.cuda.synchronize()
    assert FA.rope_launches == before + 2
    assert torch.isfinite(out).all() and torch.equal(out, again)
    assert torch.equal(out, k1)   # one body, the same arithmetic on another layout
    err = excess(out, ref, rtol)
    assert err <= atol, f'excess {err} over rtol {rtol}'


@pytest.mark.parametrize('dtype,rtol,atol', [(torch.float32, 0.0, 1e-5),
                                             (torch.bfloat16, BF16_RTOL, 5e-3)])
@pytest.mark.parametrize('B,L', [(3, 17), (2, 291)])
def test_k6_matches_plain_and_k3(dev, dtype, rtol, atol, B, L):
    q, k, v, do = _qkvd(B, L, dtype, dev, B * L + 1)
    cos, sin = rope_tables(64, L, device=dev)
    before = FA.rope_bwd_launches
    grads = FA.rope_attention_backward(q, k, v, cos, sin, do, 0.125, 8)
    again = FA.rope_attention_backward(q, k, v, cos, sin, do, 0.125, 8)
    ref = FA.rope_attention_backward_reference(q, k, v, cos, sin, do, 0.125, 8)
    k3 = FA.split_qkv_heads(FA.rope_attention_qkv_backward(
        FA.merge_qkv_heads(q, k, v, 8), cos, sin, do, 0.125, 8), 8)
    torch.cuda.synchronize()
    assert FA.rope_bwd_launches == before + 6   # three launches per call
    for name, got, same, want, other in zip('qkv', grads, again, ref, k3):
        assert torch.isfinite(got).all() and torch.equal(got, same), name   # no atomics
        assert torch.equal(got, other), name
        err = excess(got, want, rtol)
        assert err <= atol, f'd{name}: excess {err} over rtol {rtol}'


def _out_with_bf16_p(q, k, v, cos, sin):
    """P v in f32 with P rounded to bf16: what the residual forward would
    write as out_f32 without its second product."""
    B, L, A = q.shape
    qh, kh = (apply_rope(t.reshape(B, L, 8, 64), cos, sin).float() for t in (q, k))
    p = torch.softmax(torch.einsum('blhd,bmhd->bhlm', qh, kh) * 0.125, dim=-1)
    return torch.einsum('bhlm,bmhd->blhd', p.to(torch.bfloat16).float(),
                        v.float().reshape(B, L, 8, 64)).reshape(B, L, A)


OUT_F32_RTOL = 1e-4   # chip_smoke.py's limit for out_f32, of max |ref|


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,L', [(3, 17), (2, 100), (2, 291), (8, 291), (16, 152)])
def test_k1_k5_residuals_and_the_same_bits_without_them(dev, dtype, B, L):
    """K1 and K5 give the same output bits with and without the residuals,
    K1's residuals are K5's bits, and they agree with the plain forward's.
    The kernels round the rotation as the plain version does, so both
    residuals differ from it by summation order alone: lse to 1e-5 in f32
    and 1e-3 in bf16; out_f32 in f32 by max |err| <= 1e-4 max |ref|, a limit
    that the outputs with P rounded to bf16 (the plain bf16 output, and P v
    in f32 with P rounded) must fail."""
    q, k, v = _qkvd(B, L, dtype, dev, B * L + 3, 3)
    cos, sin = rope_tables(64, L, device=dev)
    qkv = FA.merge_qkv_heads(q, k, v, 8)
    before = (FA.launches, FA.rope_launches)
    res = [FA.rope_attention_forward(q, k, v, cos, sin, 0.125, 8, residuals=True),
           FA.rope_attention_qkv_forward(qkv, cos, sin, 0.125, 8, residuals=True)]
    bare = [FA.rope_attention_forward(q, k, v, cos, sin, 0.125, 8),
            FA.rope_attention_qkv_forward(qkv, cos, sin, 0.125, 8)]
    plain_out, out_ref, lse_ref = FA.rope_attention_reference(q, k, v, cos, sin, 0.125, 8,
                                                              True)
    torch.cuda.synchronize()
    assert (FA.launches, FA.rope_launches) == (before[0] + 2, before[1] + 2)
    top = out_ref.abs().max().item()
    rel = lambda o: (o.float() - out_ref).abs().max().item() / top  # noqa: E731
    if dtype == torch.bfloat16:
        for control in (plain_out, _out_with_bf16_p(q, k, v, cos, sin)):
            assert rel(control) > OUT_F32_RTOL, rel(control)
    for (out, out_f32, lse), plain in zip(res, bare):
        assert torch.equal(out, plain)
        assert out_f32.dtype == torch.float32 and torch.isfinite(out_f32).all()
        assert rel(out_f32) <= OUT_F32_RTOL, f'out_f32 off by {rel(out_f32)} of max |ref|'
        assert lse.shape == (B, 8, L) and torch.isfinite(lse).all()
        lse_err = (lse - lse_ref).abs().max().item()
        assert lse_err <= (1e-5 if dtype == torch.float32 else 1e-3), lse_err
    assert all(torch.equal(a, b) for a, b in zip(res[0][1:], res[1][1:]))


@pytest.mark.parametrize('dtype,rtol,atol', [(torch.float32, 0.0, 1e-5),
                                             (torch.bfloat16, BF16_RTOL, 5e-3)])
@pytest.mark.parametrize('B,L', [(3, 17), (2, 100), (2, 291)])
def test_k3_k6_from_residuals_match_plain(dev, dtype, rtol, atol, B, L):
    """K3 and K6 given K1's and K5's residuals: the same bits as the
    standalone call (which runs the forward itself), the same bits on a
    repeat (no atomics), K3 the same bits as K6, and within the limits of
    both plain versions: the TPU kernel's arithmetic and the kernels' own
    from the residuals."""
    q, k, v, do = _qkvd(B, L, dtype, dev, B * L + 4)
    cos, sin = rope_tables(64, L, device=dev)
    qkv = FA.merge_qkv_heads(q, k, v, 8)
    _, out, lse = FA.rope_attention_forward(q, k, v, cos, sin, 0.125, 8, residuals=True)
    _, out1, lse1 = FA.rope_attention_qkv_forward(qkv, cos, sin, 0.125, 8, residuals=True)
    before = (FA.rope_launches, FA.rope_bwd_launches, FA.bwd_launches)
    got = FA.rope_attention_backward(q, k, v, cos, sin, do, 0.125, 8, out=out, lse=lse)
    again = FA.rope_attention_backward(q, k, v, cos, sin, do, 0.125, 8, out=out, lse=lse)
    k3 = FA.split_qkv_heads(FA.rope_attention_qkv_backward(qkv, cos, sin, do, 0.125, 8,
                                                           out=out1, lse=lse1), 8)
    assert (FA.rope_launches, FA.rope_bwd_launches, FA.bwd_launches) == (
        before[0], before[1] + 6, before[2] + 3)   # no forward when the residuals are given
    alone = FA.rope_attention_backward(q, k, v, cos, sin, do, 0.125, 8)
    ref = FA.rope_attention_backward_reference(q, k, v, cos, sin, do, 0.125, 8)
    twin = FA.rope_attention_backward_reference(q, k, v, cos, sin, do, 0.125, 8, out, lse)
    torch.cuda.synchronize()
    for name, g, *others in zip('qkv', got, again, k3, alone, ref, twin):
        assert torch.isfinite(g).all(), name
        assert all(torch.equal(g, o) for o in others[:3]), name
        for want in others[3:]:
            err = excess(g, want, rtol)
            assert err <= atol, f'd{name}: excess {err} over rtol {rtol}'


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k6_through_autograd(dev, dtype):
    """``rope_attention`` under autograd: K5 forward, K6 backward, and the
    leaves' gradients are exactly what K6 returns."""
    q, k, v, do = _qkvd(2, 41, dtype, dev, 5)
    cos, sin = rope_tables(64, 41, device=dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (FA.rope_launches, FA.rope_bwd_launches)
    out = FA.rope_attention(*leaves, cos, sin, 0.125, 8)
    out.backward(do)
    want = FA.rope_attention_backward(q, k, v, cos, sin, do, 0.125, 8)
    torch.cuda.synchronize()
    # autograd: K5 writing the residuals, K6 from them; the standalone call
    # runs K5 first
    assert (FA.rope_launches, FA.rope_bwd_launches) == (before[0] + 2, before[1] + 6)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.parametrize('dtype,rtol,atol', [(torch.float32, 0.0, 1e-5),
                                             (torch.bfloat16, BF16_RTOL, 5e-3)])
@pytest.mark.parametrize('B,L', [(3, 17), (2, 291), (8, 291)])
def test_k7_matches_plain(dev, dtype, rtol, atol, B, L):
    q, k, v = (t.reshape(B, L, 8, 64) for t in _qkvd(B, L, dtype, dev, B * L + 2, 3))
    before = FA.attention_launches
    out = FA.attention(q, k, v, 0.125)
    bhld = FA.fused_attention(*(t.transpose(1, 2).contiguous() for t in (q, k, v)), 0.125)
    again = FA.attention(q, k, v, 0.125)
    ref = FA.attention_reference(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert FA.attention_launches == before + 3
    assert torch.isfinite(out).all() and torch.equal(out, again)
    assert torch.equal(bhld.transpose(1, 2), out)
    err = excess(out, ref, rtol)
    assert err <= atol, f'excess {err} over rtol {rtol}'
    with pytest.raises(RuntimeError, match='forward only'):
        FA.attention(q.clone().requires_grad_(), k, v, 0.125)


def _layer(B, L, dm, heads, dtype, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    A = heads * 64
    x = (0.5 * torch.randn(B, L, dm, generator=gen)).to(dev, dtype)
    ws = [(torch.randn(*shape, generator=gen) * sc).to(dev, dtype)
          for shape, sc in (((dm, 3 * A), dm ** -0.5), ((3 * A,), 0.1), ((A, dm), A ** -0.5),
                            ((dm,), 0.1))]
    return x, ws, rope_tables(64, L, device=dev)


@pytest.mark.parametrize('dtype,rtol,atol', [(torch.float32, 0.0, 1e-5),
                                             (torch.bfloat16, BF16_RTOL, 5e-3)])
@pytest.mark.parametrize('B,L,dm,heads', [(2, 37, 128, 2), (2, 291, 768, 8), (1, 291, 768, 3),
                                          (1, 384, 192, 3), (1, 385, 192, 3), (1, 400, 192, 3)])
def test_k8_matches_plain_and_the_current_layer(dev, dtype, rtol, atol, B, L, dm, heads):
    """K8 against its plain version and against cuBLAS projections around
    K1 on the head-major permutation of the same weights (max |err| <=
    1e-5 / 1e-2 of max |ref| in f32 / bf16). Each branch of the bf16
    kernels runs: L not a multiple of 64 or of the 128-row pass (37, 291,
    385), B * H below the SM count (1 x 3), K and V in shared memory up to
    L = 384 and in the workspace past it (385, 400); d_model 192 leaves the
    out projection a half 128-column tile."""
    x, ws, (cos, sin) = _layer(B, L, dm, heads, dtype, dev, B + L + dm)
    lib = _build.load('fused_layer', FL._SIGNATURES, FL._RESTYPES)
    in_workspace = lib.hd_fused_layer_workspace_bytes(B, L, heads, 1) > 0
    assert in_workspace == (L > 384)   # bf16's cut-over; f32 always uses the workspace
    before = FL.launches
    y = FL.fused_layer(x, *ws, cos, sin, 0.125, heads)
    again = FL.fused_layer(x, *ws, cos, sin, 0.125, heads)
    ref = FL.fused_layer_reference(x, *ws, cos, sin, 0.125, heads)
    w_hm, b_hm = FL.column_blocked_to_head_major(ws[0], ws[1], heads)
    cur = FL.current_layer(x, w_hm, b_hm, ws[2], ws[3], cos, sin, 0.125, heads)
    torch.cuda.synchronize()
    assert FL.launches == before + 4   # two launches per call
    assert torch.isfinite(y).all() and torch.equal(y, again)   # no atomics
    err = excess(y, ref, rtol)
    assert err <= atol, f'excess {err} over rtol {rtol}'
    rel = ((y.float() - cur.float()).abs().max() / cur.float().abs().max()).item()
    assert rel <= (1e-5 if dtype == torch.float32 else 1e-2), rel


def test_k8_occupancy(dev):
    """Both bf16 kernels fit an SM at the model's length: one block of 288
    threads each, launch 1 holding K and V in its shared memory."""
    for dtype in (torch.bfloat16, torch.float32):
        occ = FL.kernel_occupancy(291, dtype)
        assert [o['kernel'] for o in occ] == list(FL.KERNEL_NAMES[dtype])
        assert all(o['blocks_per_sm'] >= 1 and 0 < o['smem_bytes'] <= 232448 for o in occ), occ


def test_k8_refuses_what_it_does_not_take(dev):
    x, ws, (cos, sin) = _layer(1, 9, 128, 2, torch.bfloat16, dev, 0)
    with pytest.raises(ValueError, match='wqkv'):
        FL.fused_layer(x, ws[0].float(), *ws[1:], cos, sin, 0.125, 2)
    x, ws, (cos, sin) = _layer(1, 9, 96, 2, torch.bfloat16, dev, 0)
    with pytest.raises(ValueError, match='multiple of 64'):
        FL.fused_layer(x, *ws, cos, sin, 0.125, 2)
    # the bf16 kernels read x and the weights through TMA: 16-byte aligned
    x, ws, (cos, sin) = _layer(1, 9, 128, 2, torch.bfloat16, dev, 0)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    with pytest.raises(ValueError, match='16-byte'):
        FL.fused_layer(shifted, *ws, cos, sin, 0.125, 2)
