#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # from the repository root

Builds every kernel of the path (hudiff_tpu_torch/csrc/*.cu, one nvcc per
source, in parallel), holds each kernel against its plain PyTorch version
on the card, runs the full-width HuDiff-Ab model, then humanizes two
antibodies at full width through ``PairHumanizer.humanize_many``, checks
that the kernels carried that run, and profiles one forward
(torch.profiler: device time by kernel group, idle share). One JSON object
per line; the last line
is ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line. Without a CUDA device it exits 2 and prints no result.

Shapes: K1 at L = 291 (8 heads x 64), K2 at every tower shape of the Ab
path (256/128 GELU and 768/384 ReLU, L = 152 and 139, dilations 1-32),
each at the main path's batch (16 rows) and at B = 64. Times are medians
of CUDA-event windows after a warm-up; inputs stay L2-resident, as they
are on the main path where each kernel reads what the previous op wrote.
"""
import copy
import json
import os
import statistics
import subprocess
import sys
import time

H1 = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
      'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYYFDYWGQGTTLTVSS')
L1 = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
      'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')
H2 = ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYAMSWVRQAPGKGLEWVSAISGSGGSTYY'
      'ADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAKDRGYYFDYWGQGTLVTVSS')
L2 = ('EIVLTQSPGTLSLSPGERATLSCRASQSVSSSYLAWYQQKPGQAPRLLIYGASSRATGIP'
      'DRFSGSGSGTDFTLTISRLEPEDFAVYYCQQYGSSPLTFGGGTKVEIK')

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}  # f32 kernels use FMA, not tensor cores
MAIN_B = 16          # rows per humanization round on the main path
BIG_B = 64
SEED = 2023
# Tolerances. f32: |out - ref| <= TOL_F32, the same arithmetic in another
# summation order. bf16: |out - ref| <= BF16_RTOL |ref| + TOL_BF16, elementwise.
# BF16_RTOL is one bf16 spacing of the output (both sides round it, and may
# round it apart); TOL_BF16 bounds the rest (the excess), which comes from P
# (K1) or p, q (K2) rounded to bf16 at nearby points. Set above the largest
# excess measured on an H100 at these shapes (K1 1.5e-3, K2 1.52e-2), with
# room for the card tests' smaller shapes, which use the same limits.
TOL_F32 = {'K1': 1e-5, 'K2': 2e-5}
BF16_RTOL = 2.0 ** -7
TOL_BF16 = {'K1': 5e-3, 'K2': 2.5e-2}
FORWARD_ATOL = 1e-3   # full-width f32 logits, card vs CPU, 24 blocks + 10 attentions


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    emit({'phase': 'failed', 'error': msg})
    raise SystemExit(1)


def time_ms(torch, fn, reps=10, windows=5):
    """Median over ``windows`` CUDA-event windows of ``reps`` calls, in ms."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def check_err(torch, kernel, out, ref):
    """A kernel's output against its plain version: the record's error keys,
    and whether the output is finite and within the limit."""
    diff = (out.float() - ref.float()).abs()
    rec = {'max_abs_err': diff.max().item()}
    if out.dtype == torch.float32:
        held, rec['tol'] = rec['max_abs_err'], TOL_F32[kernel]
    else:
        held = (diff - BF16_RTOL * ref.float().abs()).max().item()
        rec.update(excess_over_rtol=held, rtol=BF16_RTOL, tol=TOL_BF16[kernel])
    return rec, held <= rec['tol'] and bool(torch.isfinite(out).all().item())


def bound_parts(nbytes, flops, dtype_name):
    """(ms to move the bytes at the HBM rate, ms for the operations at peak)."""
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype_name] * 1e3


def bound_ms(nbytes, flops, dtype_name):
    t_bytes, t_ops = bound_parts(nbytes, flops, dtype_name)
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch.nn.functional as F
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.models.denoiser import AntiTFNet, DenoiserConfig
    from hudiff_tpu_torch.ops import _build
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    from hudiff_tpu_torch.ops.bytenet import ByteNetBlock, dilation_schedule
    from hudiff_tpu_torch.ops.rope import apply_rope, rope_tables
    from hudiff_tpu_torch.sampling import humanize as HZ

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    t_start = time.perf_counter()

    # -- phase 1: the card, the toolchain, the kernel build ------------------
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else 'not read'
    print(card, flush=True)
    t0 = time.perf_counter()
    build_s = _build.build_all()
    emit({'phase': 'device', 'nvidia_smi': card, 'kind': torch.cuda.get_device_name(0),
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'python': sys.version.split()[0],
          'build_s': {k: round(v, 3) for k, v in build_s.items()},
          'build_total_s': round(time.perf_counter() - t0, 3)})

    gen = torch.Generator(device='cpu').manual_seed(SEED)
    results = {'K1': {}, 'K2': {}}

    # -- phase 2: K1 against its plain version --------------------------------
    heads, hd, L = 8, 64, C.PAIR_LEN
    cos, sin = rope_tables(hd, L, device=dev)
    for B in (MAIN_B, BIG_B):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            qkv = torch.randn(B, L, heads * 3 * hd, generator=gen).to(dev, dtype)
            scale = 1.0 / hd ** 0.5
            out = FA.rope_attention_qkv(qkv, cos, sin, scale, heads)
            ref = FA.rope_attention_qkv_reference(qkv, cos, sin, scale, heads)
            torch.cuda.synchronize()
            errs, ok = check_err(torch, 'K1', out, ref)
            rec = {'phase': 'K1', 'B': B, 'L': L, 'dtype': name, **errs}
            if not ok:
                emit(rec)
                fail(f'K1 disagrees with its plain version ({name}, B={B})')
            q, k, v = FA.split_qkv_heads(qkv, heads)
            qr = apply_rope(q.reshape(B, L, heads, hd), cos, sin).transpose(1, 2).contiguous()
            kr = apply_rope(k.reshape(B, L, heads, hd), cos, sin).transpose(1, 2).contiguous()
            vr = v.reshape(B, L, heads, hd).transpose(1, 2).contiguous()
            nbytes = qkv.numel() * qkv.element_size() * 4 // 3 + 2 * cos.numel() * 4
            flops = 4.0 * B * heads * L * L * hd
            rec.update(
                ms=time_ms(torch, lambda: FA.rope_attention_qkv(qkv, cos, sin, scale, heads)),
                plain_ms=time_ms(torch, lambda: FA.rope_attention_qkv_reference(
                    qkv, cos, sin, scale, heads), reps=3),
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qr, kr, vr, scale=scale)))
            rec['bound_ms'], rec['bound_by'] = bound_ms(nbytes, flops, name)
            emit(rec)
            results['K1'][(B, name)] = rec

    # -- phase 3: K2 against its plain version at every Ab tower shape ------
    cfg = DenoiserConfig()
    torch.manual_seed(SEED)   # the blocks' initial weights
    towers = [(cfg.d_model, cfg.activation, cfg.n_encoder_layers),
              (cfg.sum_d_model, 'relu', cfg.dual_layers)]
    K = cfg.aa_kernel_size
    for B in (MAIN_B, BIG_B):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            tot = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'calls': 0,
                   'max_abs_err': 0.0, 'excess_over_rtol': 0.0, 'bytes_ms': 0.0,
                   'ops_ms': 0.0}
            for d, act, n_layers in towers:
                h = d // 2
                for Lc in (C.HEAVY_LEN, C.LIGHT_LEN):
                    for dil in dilation_schedule(n_layers, cfg.r):
                        blk = ByteNetBlock(d, h, K, dilation=dil, activation=act)
                        with torch.no_grad():
                            for ln in (blk.ln1, blk.ln2, blk.ln3):
                                ln.weight.add_(0.1 * torch.randn(ln.weight.shape, generator=gen))
                                ln.bias.add_(0.1 * torch.randn(ln.bias.shape, generator=gen))
                        blk = blk.to(dev)
                        args = [t.detach().to(dtype) if t.dim() >= 2 else t.detach()
                                for t in (blk.ln1.weight, blk.ln1.bias, blk.fc1.weight,
                                          blk.fc1.bias, blk.ln2.weight, blk.ln2.bias,
                                          blk.conv.weight, blk.conv.bias, blk.ln3.weight,
                                          blk.ln3.bias, blk.fc2.weight, blk.fc2.bias)]
                        x = torch.randn(B, Lc, d, generator=gen).to(dev, dtype)
                        kw = dict(dilation=dil, activation_name=act)
                        y = FB.bytenet_block(x, *args, **kw)
                        r = FB.bytenet_block_reference(x, *args, **kw)
                        torch.cuda.synchronize()
                        errs, ok = check_err(torch, 'K2', y, r)
                        rec = {'phase': 'K2', 'B': B, 'L': Lc, 'D': d, 'H': h, 'act': act,
                               'dil': dil, 'dtype': name, **errs}
                        if not ok:
                            emit(rec)
                            fail(f'K2 disagrees with its plain version: {rec}')
                        s = dtype.itemsize
                        nbytes = 2 * x.numel() * s + (2 * d * h + K * h * h) * s + 4 * (5 * h + 4 * d)
                        taps = sum(max(0, Lc - abs(t - (K - 1) // 2) * dil) for t in range(K))
                        flops = 2.0 * B * (Lc * 2 * d * h + taps * h * h)
                        rec['bound_ms'], rec['bound_by'] = bound_ms(nbytes, flops, name)
                        t_bytes, t_ops = bound_parts(nbytes, flops, name)
                        tot['bytes_ms'] += t_bytes
                        tot['ops_ms'] += t_ops
                        rec['ms'] = time_ms(torch, lambda: FB.bytenet_block(x, *args, **kw),
                                            reps=5, windows=3)
                        rec['plain_ms'] = time_ms(torch, lambda: FB.bytenet_block_reference(
                            x, *args, **kw), reps=2, windows=3)
                        emit(rec)
                        for key in ('ms', 'plain_ms', 'bound_ms'):
                            tot[key] += rec[key]
                        tot['calls'] += 1
                        for key in ('max_abs_err', 'excess_over_rtol'):
                            tot[key] = max(tot[key], errs.get(key, 0.0))
            # the forward's 24 calls together: whichever side dominates the sum
            tot['bound_by'] = 'bytes' if tot['bytes_ms'] >= tot['ops_ms'] else 'operations'
            emit({'phase': 'K2_forward_total', 'B': B, 'dtype': name, **tot})
            results['K2'][(B, name)] = tot

    # -- phase 4: full-width forward, f32 on the card vs the CPU --------------
    torch.manual_seed(SEED)
    cpu_model = AntiTFNet(cfg).eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rs = np.random.RandomState(SEED)
    tokens = torch.from_numpy(rs.randint(0, C.N_TOKENS, (2, C.PAIR_LEN))).long()
    region = torch.from_numpy(np.tile(np.concatenate(
        [C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]), (2, 1))).long()
    chain = torch.tensor([[0, 1], [0, 2]])
    with torch.inference_mode():
        ref = cpu_model(tokens, region, chain)
        out = gpu_model(tokens.to(dev), region.to(dev), chain.to(dev)).cpu()
    err = (out - ref).abs().max().item()
    rec = {'phase': 'forward_f32', 'B': 2, 'shape': list(out.shape), 'max_abs_err': err,
           'tol': FORWARD_ATOL, 'max_abs_logit': ref.abs().max().item()}
    emit(rec)
    if not (out.shape == (2, C.PAIR_LEN, C.N_TOKENS) and torch.isfinite(out).all().item()
            and err <= FORWARD_ATOL):
        fail('full-width f32 forward on the card disagrees with the CPU')
    del cpu_model, gpu_model

    # -- phase 5: full-width humanization round, bf16 cast-once --------------
    torch.manual_seed(SEED + 1)
    model = AntiTFNet(cfg, dtype=torch.bfloat16)
    hum = HZ.PairHumanizer(model, batch_size=MAIN_B // 2, seed=SEED, device='cuda',
                           device_batch=MAIN_B)
    inputs = [HZ.pair_input(H1, L1), HZ.pair_input(H2, L2)]
    if any(inp is None for inp in inputs):
        fail('pair_input rejected a test antibody')
    steps = HZ._packed_pad_to(inputs)
    FA.launches = FB.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = hum.humanize_many(inputs, rows_per_input=MAIN_B // 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {'K1': FA.launches, 'K2': FB.launches}
    cdr = np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX]) != 0
    for inp, r in zip(inputs, res):
        g = None if r is None else r['grids']
        if (g is None or g.shape != (MAIN_B // 2, C.PAIR_LEN) or (g == C.IDX_MSK).any()
                or (g < 0).any() or (g >= C.N_TOKENS - 1).any()
                or not (g[:, cdr] == inp['clean'][cdr]).all()
                or not (g[:, inp['tokens'] != C.IDX_MSK]
                        == inp['tokens'][inp['tokens'] != C.IDX_MSK]).all()):
            fail('humanization output fails the CDR / protected-slot checks')
    emit({'phase': 'humanize', 'rows': MAIN_B, 'forwards': steps, 'wall_s': wall,
          'seqs_per_s': MAIN_B / wall, 'ms_per_forward': wall / steps * 1e3,
          'launches': launches,
          'launches_per_forward': {k: v / steps for k, v in launches.items()},
          'cdr_unchanged': True})

    # the counters against the kernels the profiler saw (checked in profile()):
    # every forward must launch that many of each, one K1 per attention and
    # the same number of K2 kernels for each of the tower blocks
    seen = profile(torch, model, hum, inputs)
    attentions = 2 * cfg.cs_layers
    blocks = 2 * (cfg.n_encoder_layers + cfg.dual_layers)
    expected = {k: seen[k] * steps for k in launches}
    emit({'phase': 'launch_check', 'launches': launches, 'expected': expected,
          'profiled_launches_per_forward': seen, 'attentions_per_forward': attentions,
          'tower_blocks_per_forward': blocks})
    if (launches != expected or seen['K1'] != attentions or not seen['K2']
            or seen['K2'] % blocks):
        fail(f'kernel launches {launches} do not match the profiled forwards {seen}')

    # -- phase 6: the kernels line --------------------------------------------
    k1, k1_f32 = results['K1'][(MAIN_B, 'bfloat16')], results['K1'][(MAIN_B, 'float32')]
    k2, k2_f32 = results['K2'][(MAIN_B, 'bfloat16')], results['K2'][(MAIN_B, 'float32')]
    n2 = k2['calls']   # tower shapes measured in phase 3: one per block of a forward
    emit({'kernels': [
        {'name': 'K1 fused RoPE attention (merged head-major qkv)', 'route': 'cuda',
         'source': 'hudiff_tpu_torch/csrc/rope_attention.cu',
         'replaces': 'hudiff_tpu/ops/pallas_attention.py:224',
         'launches': launches['K1'], 'launches_per_forward': launches['K1'] / steps,
         'max_abs_err': k1['max_abs_err'], 'excess_over_rtol': k1['excess_over_rtol'],
         'max_abs_err_f32': k1_f32['max_abs_err'], 'ms': k1['ms'],
         'plain_ms': k1['plain_ms'], 'bound_ms': k1['bound_ms'], 'bound_by': k1['bound_by'],
         'library_ms': k1['library_ms'], 'shape': f'B={MAIN_B} L=291 H=8 D=64 bf16'},
        {'name': 'K2 ByteNet block forward (LayerNorm row passes and GEMMs)',
         'route': 'cuda',
         'source': 'hudiff_tpu_torch/csrc/bytenet_block.cu',
         'replaces': 'hudiff_tpu/ops/pallas_bytenet.py:162',
         'launches': launches['K2'], 'launches_per_forward': launches['K2'] / steps,
         'max_abs_err': k2['max_abs_err'], 'excess_over_rtol': k2['excess_over_rtol'],
         'max_abs_err_f32': k2_f32['max_abs_err'], 'ms': k2['ms'] / n2,
         'plain_ms': k2['plain_ms'] / n2, 'bound_ms': k2['bound_ms'] / n2,
         'bound_by': k2['bound_by'], 'library_ms': None,
         'shape': f'B={MAIN_B}, one call (all its kernels), mean over the {n2} '
                  'tower blocks of one forward, bf16'}]})
    emit({'phase': 'done', 'total_s': time.perf_counter() - t_start})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


def profile(torch, model, hum, inputs):
    """Device time by kernel over a few bf16 forwards at the main batch,
    from torch.profiler, beside the host-clock time of the same forwards
    and of warm sampler steps (forward + draw + write-back). Checks that the
    wrappers' launch counters rose by the number of K1 and K2 kernels the
    profiler saw, and returns those numbers per forward."""
    import numpy as np
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    rows = [inputs[i % len(inputs)] for i in range(MAIN_B)]
    args = [torch.as_tensor(np.stack([r[k] for r in rows]), dtype=torch.long,
                            device='cuda') for k in ('tokens', 'region', 'chain')]
    n = 5
    with torch.inference_mode():
        model(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            model(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        # host time to issue 3 forwards (~900 launches, inside the launch
        # queue) without waiting: the host side of the step
        t0 = time.perf_counter()
        for _ in range(3):
            model(*args)
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
        torch.cuda.synchronize()
        order = torch.as_tensor(np.stack([r['positions'][:20] for r in rows]),
                                dtype=torch.long, device='cuda')
        hum.run(*args, order, hum.generator)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hum.run(*args, order, hum.generator)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / order.shape[1] * 1e3
        FA.launches = FB.launches = 0
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                model(*args)
            torch.cuda.synchronize()
        counted = {'K1': FA.launches, 'K2': FB.launches}
    dev_time = lambda e: getattr(e, 'self_device_time_total',  # noqa: E731
                                 getattr(e, 'self_cuda_time_total', 0))
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_time(e) > 0]
    groups = {'K1': 0.0, 'K2': 0.0, 'cublas': 0.0, 'other': 0.0}
    seen = {'K1': 0, 'K2': 0}
    for e in kernels:
        key = e.key.lower()
        g = ('K1' if 'rope_attention_qkv_kernel' in key else
             'K2' if any(s in key for s in ('bytenet_gemm_kernel', 'bytenet_ln_act_kernel')) else
             'cublas' if any(s in key for s in ('gemm', 'cutlass', 'nvjet', 'xmma')) else
             'other')
        groups[g] += dev_time(e) / n / 1e3
        if g in seen:
            seen[g] += e.count
    busy = sum(groups.values())
    top = sorted(kernels, key=dev_time, reverse=True)[:12]
    emit({'phase': 'profile', 'B': MAIN_B, 'forwards': n, 'wall_ms_per_forward': wall_ms,
          'wall_ms_per_sampler_step': step_ms, 'host_issue_ms_per_forward': host_ms,
          'device_busy_ms_per_forward': busy,
          'device_idle_share': (1 - busy / wall_ms) if busy else 'not measured',
          'kernels_per_forward': sum(e.count for e in kernels) / n,
          'device_ms_per_forward_by_group': groups,
          'top': [{'kernel': e.key[:90], 'calls_per_forward': e.count / n,
                   'ms_per_forward': dev_time(e) / n / 1e3} for e in top],
          'counted_launches': counted, 'profiled_launches': seen})
    if counted != seen or any(v % n for v in seen.values()):
        fail(f'launch counters {counted} != kernels the profiler saw {seen}')
    return {k: v // n for k, v in seen.items()}


if __name__ == '__main__':
    sys.exit(main())
