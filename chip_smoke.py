#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # from the repository root

Builds every kernel of the port (hudiff_tpu_torch/csrc/*.cu, one nvcc per
source, in parallel) and holds each kernel against its plain PyTorch
version on the card. Then:

- humanization (the first slice): the full-width HuDiff-Ab model f32 against
  the CPU, two antibodies humanized at full width through
  ``PairHumanizer.humanize_many``, the launch check and a profile of the
  forward (K1, K2);
- pretraining (the second slice): the backward kernels K3 and K4 against
  their plain versions, one full-width f32 train step against the CPU,
  ``pretrain.run`` at the full width of configs/antibody_train.yml (bf16,
  B = 128, synthetic data: steps, one validation, a best-val checkpoint
  that restores to the same logits) with its launch counts, and a profile
  of one warm step (K1-K4);
- the remaining entry points (the third slice): K5 (RoPE attention on
  separate q, k, v) against its plain version and against K1 on the merged
  input, K6 (its backward), ``attention_api`` (one full-width RoPE attention
  layer through ``rope_attention``, forward and backward under autograd,
  timed and profiled), K7 (plain attention through ``fused_attention`` and
  ``attention``) and K8 (the fused attention layer of the probe
  ``hudiff_tpu_torch.tools.fused_layer_probe``, driven through its
  ``main()``, against its plain version and the production split);
- the backward's residuals (the fourth slice), inside the K1, K3, K5 and
  K6 phases: K1 and K5 write, when asked, their output before rounding
  (f32) and the scores' row log-sum-exp (the same output bits; both held
  against the plain forward's, the f32 output tightly enough that an
  output with P rounded to bf16 fails), and K3 and K6 are held given them
  against both plain versions, the TPU kernel's arithmetic and their own
  from the residuals, repeat to the same bits and match the standalone
  call (K3 also at shorter L); they are timed given the residuals (as
  autograd calls them) and standalone (the forward first). Beside each
  bf16 gate the phases record how far delta from the bf16 output would
  move the gradients;
- the ByteNet block redesign (the fifth slice), inside the K2 and K4
  phases: K2 is three launches a call and K4 five; each is timed beside the
  block as a composition of PyTorch calls in bf16 (``library_ms``; for K4
  its autograd backward), the device time of each launch of one dual-tower
  call is read from the profiler, and K2's bf16 excess is split by stage
  (each plain stage fed the kernel's own p and q, with the LayerNorm
  output rounded to bf16 before the activation as the plain version does,
  and kept in f32 as the TPU kernel keeps it; the whole block both ways
  too; readings only: each call is held against the plain version);
- the nano path (the seventh slice, HuDiff-Nb at the full width of
  configs/heavy_train.yml), after the Ab pretraining phases: K1 and K3 at
  L = 152 (``K1_nano`` at B = 16 and 512, ``K3_nano`` at 512), K2 and K4 at
  the ``nano_conv`` tower's 512/256 GELU over its six dilations
  (``K2_nano`` at B = 16, 128 and 512, ``K4_nano`` at 16 and 512; bf16
  K2 split by stage as above), ``forward_f32_nano`` (card against CPU),
  ``humanize_nano`` (a 93-forward bf16 round of 16 rows through
  ``NanoHumanizer.humanize_many``; host prep, sampler and validity filter
  timed apart), ``profile_nano`` and ``launch_check_nano`` (K1 10 and K2
  36 a forward), ``train_step_f32_nano`` (card against CPU, with its
  sensitivity reading), ``pretrain_nano`` (``pretrain.run(kind='heavy')``
  at B = 512, a checkpoint that restores as ``NanoAntiTFNet``) and
  ``profile_train_nano`` (K1-K4 10 / 36 / 30 / 60 a step). The kernels
  line's K1-K4 entries carry the nano readings under ``nano_*`` keys
  (``nano_conv_ms_*``: the six nano_conv calls only, not the aa tower's);
- fine-tuning against frozen AbNatiV scorers (the eighth slice), after
  the nano phases: ``abnativ_f32`` (one scorer at the released hparams,
  f32, card against CPU: outputs, codebook indices and input gradients
  with straight-through off and on), ``finetune_step_f32_nano`` and
  ``finetune_step_f32_ab`` (one full-width f32 fine-tune step card against
  CPU with injected corruption and Gumbel uniforms: the pretrain step's
  limits and the same hard choices), ``finetune_nano`` (the ``finetune
  nano`` CLI on configs/nano_finetune.yml, B = 512, with cross-training,
  from ``pretrain_nano``'s best checkpoint and scorer files written in the
  reference layout; then a ``NanoHumanizer`` round with ``finetune=True``
  from its best checkpoint), ``profile_finetune_nano`` (one warm step:
  device ms by group with AbNatiV's share, the launch check), and
  ``finetune_ab`` / ``profile_finetune_ab`` the same for HuDiff-Ab
  (configs/antibody_finetune.yml, B = 32, three scorers, a
  ``PairHumanizer`` round). K1-K4 carry ``finetune_nano_*`` and
  ``finetune_ab_*`` launch keys;
- the humanization service and the sampling variants (the ninth slice),
  after the fine-tune phases: K1 and K2 against their plain versions at
  the batches this path gives them (``K1_service``, ``K2_service``: Ab
  B = 1 and 32; ``K1_nano_service``, ``K2_nano_service``: Nb B = 1 and
  64), ``germline_tune_pair`` / ``_heavy`` (the pretraining checkpoints
  trained further on germline grids, so that sampled frameworks realign),
  ``sampler_k2`` (k = 2 against k = 1 at B = 32, warmed, timed k = 2, 1,
  2), ``inpaint_ab``, ``sequential_reference`` / ``_nano`` (B = 1) and
  ``serve`` (``HumanizationService`` behind ``serve(port=0)``: a burst of
  14 requests, its replies, rounds and launches checked; the burst again
  and one request alone per model under torch.profiler, each round's
  device ms and idle share). K1 and K2 carry ``launches_serve``;
- the evaluation path (the tenth slice), after ``serve``, on the
  germline-tuned models: ``released_payloads`` (each model written in the
  three released reference layouts, configs pickled as EasyDicts, and
  loaded back through ``load_denoiser``: logits against the model it came
  from; four AbNatiV scorers at the released hparams as lightning
  ``.ckpt`` files), ``nativeness`` (``api.nativeness`` over 256 heavy
  chains with the VH and VHH scorers, card against CPU), ``eval_ab`` (the
  ``ab`` CLI from the released Ab payload over 16 antibodies, then
  ``eval.harness ab`` with three scorers: every sample realigns with its
  parent's CDRs, the counters equal the forwards' kernels), ``eval_nano``
  (the same for the ``nano`` CLI from the released Nb fine-tune payload
  and ``eval.harness nano``) and ``native_aligner`` (the port's C++
  aligner against its Python DP on every chain those phases aligned, and
  the record store's native reader against mmap). K1 and K2 carry
  ``launches_eval_ab`` and ``launches_eval_nano``.

One JSON object per line; the last line is ``{"ok": true, "device":
{...}}``. Any failed check exits non-zero before that line. Without a CUDA
device it exits 2 and prints no result.

Shapes: K1, K3, K5, K6 and K7 at L = 291 (8 heads x 64); K2 and K4 at
every tower shape of the Ab path (256/128 GELU and 768/384 ReLU, L = 152
and 139, dilations 1-32); K8 at the probe's shapes (B = 64, L = 291,
d_model 768, att 512, 8 heads). K1/K2/K5/K7 at the sampler's batch (16
rows) and B = 64, K3/K4/K6 at the training batch (128) and B = 16. Times
are medians of CUDA-event windows after a warm-up (K8's: the probe's timer,
each call's output fed back as the next call's input); inputs stay
L2-resident, as they are on the main path where each kernel reads what the
previous op wrote.
"""
import copy
import dataclasses
import json
import os
import shutil
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
TRAIN_B = 128        # configs/antibody_train.yml's batch
SHORT_LENGTHS = (17, 37, 100)   # K3 at these lengths too (the entry points take any L)
SEED = 2023
# Tolerances. f32: |out - ref| <= TOL_F32, the same arithmetic in another
# summation order. bf16: |out - ref| <= BF16_RTOL |ref| + TOL_BF16, elementwise.
# BF16_RTOL is one bf16 spacing of the output (both sides round it, and may
# round it apart); TOL_BF16 bounds the rest (the excess), which comes from P
# (K1, K3), p, q (K2) or dq, dp (K4) rounded to bf16 at nearby points. Set
# above the largest excess measured on an H100 at these shapes (K1 1.5e-3,
# K2 1.52e-2, K3 1.6e-3, K4 dx 4.1e-3), with room for the card tests'
# smaller shapes, which use the same limits. K4's parameter gradients are
# f32 sums over B*L rows, held by max |err| <= K4_GRAD_RTOL max |ref| (the
# largest readings: f32 4.0e-6, bf16 9.2e-4, where dq and dp round apart).
# K5, K6 and K7 run K1's and K3's arithmetic in other layouts and take
# their limits (readings on an H100 at these shapes: excess K5 1.3e-3, K6
# 1.0e-3, K7 1.3e-3).
TOL_F32 = {'K1': 1e-5, 'K2': 2e-5, 'K3': 1e-5, 'K4': 2e-5, 'K5': 1e-5, 'K6': 1e-5,
           'K7': 1e-5}
BF16_RTOL = 2.0 ** -7
TOL_BF16 = {'K1': 5e-3, 'K2': 2.5e-2, 'K3': 5e-3, 'K4': 1.5e-2, 'K5': 5e-3, 'K6': 5e-3,
            'K7': 5e-3}
# K8 is held on inputs that make attention peaked (x ~ N(0, 1), weights
# ~ N(0, 1/fan_in)), where the rotation and the softmax move y by a large
# share of max |y| (the phase reports how far the plain version moves
# without RoPE and with a uniform softmax). Its limits are fractions of
# max |ref|, in the form of tests/test_torch_fused_layer.py: f32 max |err|
# <= K8_TOL['float32'] max |ref|; bf16 |err| <= BF16_RTOL |ref| +
# K8_TOL['bfloat16'] max |ref|, the excess from qkv, P and o rounded to
# bf16 on either side of a rounding boundary (readings on an H100 at B =
# 64, max |ref| 0.94: f32 6.6e-7, bf16 3.3e-3).
K8_TOL = {'float32': 1e-5, 'bfloat16': 5e-3}
# The backward's residuals K1 and K5 write, against the plain forward's. The
# kernels round the rotation of q and k as the plain version does (no FMA
# contraction), so the rotated q and k are its bits and both residuals differ
# from it by summation order and exp2 alone. The row log-sum-exp is held to
# LSE_TOL. The f32 output is held in f32, with no rounding to bf16 first, by
# max |err| <= OUT_F32_RTOL max |ref|: it exists to carry P to ~2^-16 (the
# second P v product), and an output with P rounded to bf16 is ~2^-9 off.
# In bf16 two such controls must fail the limit: the plain version's bf16
# output, and P v in f32 with P rounded to bf16 (the residual forward
# without its second product).
LSE_TOL = {'float32': 1e-5, 'bfloat16': 1e-3}
OUT_F32_RTOL = 1e-4
# K8 against the production split (cuBLAS projections around K1) on the
# head-major permutation of the same weights: max |err| / max |ref|. Both
# compute one function with the same rounding points; in bf16 they round qkv,
# o and y at different summation orders, one bf16 spacing (2^-7 of the
# largest output) and the excess it carries (readings on an H100: f32 4.7e-7
# and bf16 4.1e-3 on k8_check_inputs, bf16 2.6e-3 on the probe's weights).
K8_REL_ERR = {'float32': 1e-5, 'bfloat16': 1e-2}
# attention_api in f32: the layer's parameter gradients through K5/K6 against
# the same layer through the plain attention under autograd, max |err| /
# max |ref| per tensor (sums over B*L = 37,248 rows in other orders).
ATTN_API_F32_RTOL = 1e-4
K4_GRAD_RTOL = {'float32': 1e-5, 'bfloat16': 2e-3}
FORWARD_ATOL = 1e-3   # full-width f32 logits, card vs CPU, 24 blocks + 10 attentions
# Full-width f32 train step, card vs CPU (the same arithmetic through K1-K4
# and cuBLAS in other summation orders). The gradients of the random-init
# full-width model are ill-conditioned (ReLU kinks crossed through 24
# blocks and 10 attentions): the phase scales the token embedding by
# (1 + 1e-6) and reports how far the card's own gradients move: on an H100
# as far as card and CPU lie apart (7.06e-3 of the max of the same
# LayerNorm bias of the light dual tower). So each tensor is held by
# max |err| / max |ref| <= TRAIN_STEP_RTOL, and the whole gradient by
# ||err|| / ||ref|| <= TRAIN_STEP_GLOBAL_RTOL; the loss to
# TRAIN_STEP_LOSS_RTOL. Readings for this batch: 7.06e-3, 3.0e-4 and 0.
TRAIN_STEP_RTOL = 3e-2
TRAIN_STEP_GLOBAL_RTOL = 1e-3
TRAIN_STEP_LOSS_RTOL = 1e-5

# configs/antibody_train.yml as a literal (the card machine may lack
# PyYAML), with batch_acc lowered from 300 to 2 so that a few iterations
# validate and save; tests/test_torch_training.py pins the rest to the file.
PRETRAIN_CONFIG = {
    'name': 'trans_oadm',
    'model': {'n_tokens': 23, 'd_embedding': 256, 'd_model': 256, 'n_encoder_layers': 6,
              'aa_kernel_size': 7, 'r': 128, 'n_side': 3, 's_embedding': 4,
              's_model': 256, 'n_region': 7, 'r_embedding': 4, 'r_model': 256,
              'n_pos_model': 256, 'max_len': 291, 'sum_d_model': 768, 'dual_layers': 6,
              'att_model': 512, 'dim_feedforward': 256, 'nhead': 8, 'cs_layers': 5,
              'dropout': 0.2, 'activation': 'gelu'},
    'train': {'seed': 2023, 'max_iter': 1000000, 'batch_acc': 2, 'valid_step': 3,
              'batch_size': TRAIN_B, 'clip_norm': 10, 'loss_type': 'merge',
              'l_loss_weight': 3,
              'optimizer': {'type': 'Adam', 'lr': 1.e-4, 'weight_decay': 1.e-4,
                            'beta1': 0.95, 'beta2': 0.999},
              'scheduler': {'type': 'plateau', 'factor': 0.6, 'patience': 10,
                            'min_lr': 1.e-6, 'multiplier': 10, 'total_epoch': 10}},
}
PRETRAIN_ITERS = 3   # iterations of pretrain.run: 6 steps, validation and save at the 3rd
# The nano path (HuDiff-Nb): the VHHs of tests/test_cli.py and
# tests/test_numbering.py, humanized under the FR mask (93 forwards a round)
VHH1 = ('QVQLVESGGGLVQAGGSLRLSCAASGRTFSSYAMGWFRQAPGKEREFVAAISWSGGSTYYADSVKGRF'
        'TISRDNAKNTVYLQMNSLKPEDTAVYYCAADRGSYYYTRNQYDYWGQGTQVTVSS')
VHH2 = ('QVQLVESGGGSVQAGGSLVLSCAASGYTYTAGCMGWFRQTPGKEREGVAAIDSDGSTAYADSVKGRF'
        'TISRDNDKNMVYLQMNSLKPEDTAMYYCAAASRCGLGTVREYRFWGQGTQVTVSS')
NANO_FORWARDS = 93   # HEAVY_CDR_INDEX == 0: the framework slots a round resamples
NANO_TRAIN_B = 512   # configs/heavy_train.yml's batch
# configs/heavy_train.yml as a literal, batch_acc lowered from 300 to 2 as
# for PRETRAIN_CONFIG; tests/test_torch_training.py pins the rest to the file.
NANO_PRETRAIN_CONFIG = {
    'name': 'nano',
    'model': {'n_tokens': 23, 'd_embedding': 256, 'd_model': 256, 'n_encoder_layers': 6,
              'aa_kernel_size': 7, 'r': 128, 'n_region': 7, 'r_embedding': 4,
              'r_model': 256, 'n_pos_model': 256, 'max_len': 152, 'sum_d_model': 512,
              'dual_layers': 6, 'att_model': 512, 'dim_feedforward': 256, 'nhead': 8,
              'cs_layers': 5, 'dropout': 0.5, 'activation': 'gelu'},
    'train': {'seed': 2023, 'max_iter': 1000000, 'batch_acc': 2, 'valid_step': 3,
              'batch_size': NANO_TRAIN_B, 'clip_norm': 10,
              'optimizer': {'type': 'Adam', 'lr': 1.e-4, 'weight_decay': 0.,
                            'beta1': 0.95, 'beta2': 0.999},
              'scheduler': {'type': 'plateau', 'factor': 0.6, 'patience': 10,
                            'min_lr': 1.e-5, 'multiplier': 10, 'total_epoch': 20}},
}
# The fine-tune slice (HuDiff-Ab and HuDiff-Nb against frozen AbNatiV
# scorers): the CLI reads configs/nano_finetune.yml and
# configs/antibody_finetune.yml (the card machine has PyYAML) for
# FINETUNE_ITERS iterations with a validation every FINETUNE_VALID (Nb: a
# cross-training step at iteration 5).
FINETUNE_CONFIGS = {'heavy': 'configs/nano_finetune.yml',
                    'pair': 'configs/antibody_finetune.yml'}
FINETUNE_ITERS, FINETUNE_VALID, FINETUNE_VAL_BATCHES = 6, 3, 2
FINETUNE_STEP_B = {'heavy': 8, 'pair': 4}   # the f32 step, card against CPU
ABNATIV_B = 64
# AbNatiV in f32 on the card against the CPU: outputs to an absolute limit,
# the input gradient to a fraction of max |ref|
ABNATIV_ATOL, ABNATIV_GRAD_RTOL = 1e-5, 1e-4
# kernels one call launches: K2 three GEMMs; K4 three data GEMMs, one grouped
# weight-gradient GEMM and one fixed-order sum
K2_LAUNCHES, K4_LAUNCHES = 3, 5


_last_record = []


def emit(obj):
    _last_record[:] = [obj]
    print(json.dumps(obj), flush=True)


def fail(msg):
    """Stop with exit code 1: the error on stdout, and on stderr beside the
    last record emitted, so that the end of either stream says what failed."""
    last = json.dumps(_last_record[0])[:4000] if _last_record else 'none'
    emit({'phase': 'failed', 'error': msg})
    print(f'chip_smoke failed: {msg}\nlast record: {last}', file=sys.stderr, flush=True)
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


def residual_check(torch, dtype_name, out, res, res_ref, controls):
    """K1's or K5's call writing the backward's residuals (out, out_f32,
    lse) against its call without (the same output bits) and the residuals
    against the plain forward's (out, out_f32, lse); each of ``controls``,
    an f32 output with P rounded to bf16, must fail the out_f32 limit."""
    out2, out_f32, lse = res
    err = (lse - res_ref[2]).abs().max().item()
    top = res_ref[1].abs().max().item()
    rel = lambda o: (o.float() - res_ref[1]).abs().max().item() / top  # noqa: E731
    rec = {'same_bits_with_residuals': torch.equal(out, out2), 'lse_max_abs_err': err,
           'lse_tol': LSE_TOL[dtype_name], 'out_f32_rel_err': rel(out_f32),
           'out_f32_rtol': OUT_F32_RTOL,
           'out_f32_rel_err_controls': [rel(c) for c in controls]}
    rec['residuals_ok'] = (rec['same_bits_with_residuals']
                           and rec['out_f32_rel_err'] <= OUT_F32_RTOL
                           and all(e > OUT_F32_RTOL for e in rec['out_f32_rel_err_controls'])
                           and err <= LSE_TOL[dtype_name]
                           and bool(torch.isfinite(lse).all().item())
                           and bool(torch.isfinite(out_f32).all().item()))
    return rec


def out_f32_controls(torch, q, k, v, cos, sin, scale, heads, plain_out):
    """The outputs out_f32's limit must tell apart, in bf16: the plain
    version's bf16 output and P v in f32 with P rounded to bf16; none in
    f32, where P is not rounded."""
    if plain_out.dtype == torch.float32:
        return []
    qr, kr, vr = _rotated_bhld(torch, q, k, v, cos, sin, heads)
    p = torch.softmax(qr.float() @ kr.float().transpose(-1, -2) * scale, dim=-1)
    o = p.to(torch.bfloat16).float() @ vr.float()
    B, H, L, D = o.shape
    return [plain_out, o.transpose(1, 2).reshape(B, L, H * D)]


def backward_checks(torch, kernel, got, again, alone, ref, twin):
    """K3's or K6's gradients given the forward's residuals: within the
    limits of both plain versions (the TPU kernel's arithmetic, ``ref``, and
    the kernels' own from the residuals, ``twin``), the same bits on a
    repeat and as the standalone call that runs the forward itself. The
    record's error keys and whether every check holds."""
    errs, ok = check_err(torch, kernel, got, ref)
    twin_errs, ok_twin = check_err(torch, kernel, got, twin)
    rec = {**errs, 'max_abs_err_vs_lse_plain': twin_errs['max_abs_err'],
           'excess_vs_lse_plain': twin_errs.get('excess_over_rtol', twin_errs['max_abs_err']),
           'repeat_identical': torch.equal(got, again),
           'standalone_identical': torch.equal(got, alone)}
    return rec, (ok and ok_twin and rec['repeat_identical'] and rec['standalone_identical'])


def delta_reading(torch, kernel, rounded, ref):
    """K3's or K6's gradients with delta taken from the bf16 output
    (FlashAttention-2's choice, which out_f32 replaces; ``rounded``, None in
    f32) against the TPU kernel's arithmetic: recorded, not held."""
    if rounded is None:
        return {}
    errs, _ = check_err(torch, kernel, rounded, ref)
    return {'excess_delta_from_bf16_out': errs['excess_over_rtol']}


def bound_parts(nbytes, flops, dtype_name):
    """(ms to move the bytes at the HBM rate, ms for the operations at peak)."""
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype_name] * 1e3


def bound_ms(nbytes, flops, dtype_name):
    t_bytes, t_ops = bound_parts(nbytes, flops, dtype_name)
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


LIBRARY_COMPOSITION = ('a composition: F.layer_norm, the activation, F.linear, F.layer_norm, '
                       'the activation, F.conv1d, F.layer_norm, the activation, F.linear, '
                       'in bf16')
STAGE_KEYS = ('excess_p', 'excess_q_given_p', 'excess_y_given_q', 'excess_block',
              'excess_p_f32_ln', 'excess_q_given_p_f32_ln', 'excess_y_given_q_f32_ln',
              'excess_block_f32_ln')


def k2_stage_excess(torch, x, args, dil, act):
    """K2's bf16 excess split by stage: each stage of the plain version fed
    the kernel's own input to it (x, the kernel's p, the kernel's q), once
    as the plain version is (each LayerNorm's output rounded to bf16 before
    the activation, as the Flax module path does) and once with that output
    kept in f32 before the activation, as the TPU kernel and K2 keep it;
    and the whole block's excess both ways. Readings only: the call is held
    against the plain version as it is."""
    import torch.nn.functional as F
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2 = args
    y, p, q, _ = FB._forward(x, args, dil, act, keep=True)

    def excess(out, ref):
        return ((out.float() - ref.float()).abs() - BF16_RTOL * ref.float().abs()).max().item()

    out = {}
    plain_ln = FB.layer_norm
    for tag, ln in (('', plain_ln), ('_f32_ln', lambda t, g, b: F.layer_norm(
            t.float(), (t.shape[-1],), g.float(), b.float(), FB.LN_EPS))):
        FB.layer_norm = ln
        try:
            out['excess_p' + tag] = excess(p, FB._plain_p(x, g1, b1, w1, c1, act))
            out['excess_q_given_p' + tag] = excess(q, FB._plain_q(p, g2, b2, wc, cc, dil, act))
            out['excess_y_given_q' + tag] = excess(y, FB._plain_y(x, q, g3, b3, w2, c2, act))
            out['excess_block' + tag] = excess(y, FB.bytenet_block_reference(
                x, *args, dilation=dil, activation_name=act))
        finally:
            FB.layer_norm = plain_ln
    return out


def composition_params(args, dtype):
    """The block's parameters for ``block_composition``: all in ``dtype``,
    the conv weight as F.conv1d takes it ([out, in, K])."""
    g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2 = (t.detach().to(dtype) for t in args)
    return g1, b1, w1, c1, g2, b2, wc.permute(0, 2, 1).contiguous(), cc, g3, b3, w2, c2


def block_composition(x, prm, dil, act):
    """The ByteNet block as PyTorch's own calls (F.layer_norm with eps 1e-6,
    the activation, F.linear, F.conv1d, F.linear): the yardstick K2 and,
    through autograd, K4 are timed beside. The port never calls it."""
    import torch.nn.functional as F
    g1, b1, w1, c1, g2, b2, wconv, cc, g3, b3, w2, c2 = prm
    f = F.relu if act == 'relu' else F.gelu
    d, h, k = x.shape[-1], w1.shape[0], wconv.shape[-1]
    p = F.linear(f(F.layer_norm(x, (d,), g1, b1, 1e-6)), w1, c1)
    bb = f(F.layer_norm(p, (h,), g2, b2, 1e-6))
    q = F.conv1d(bb.transpose(1, 2), wconv, cc, padding=(k - 1) // 2 * dil,
                 dilation=dil).transpose(1, 2)
    return x + F.linear(f(F.layer_norm(q, (h,), g3, b3, 1e-6)), w2, c2)


def ptxas_registers(logs):
    """Registers and spilled bytes of each kernel, from nvcc's -Xptxas -v
    output by source: {source: [[kernel, registers, spill stores, spill
    loads], ...]} (kernel: its mangled name from the kernel's own name on)."""
    import re
    out = {}
    for src, log in logs.items():
        rows, name, spill = [], None, (0, 0)
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:  # the length-prefixed name that ends in _kernel, and its template
                mangled = m.group(1)
                for d in re.finditer(r'\d+', mangled):  # a length may follow other digits
                    ends = [d.end() + int(d.group()[k:]) for k in range(len(d.group()))]
                    end = next((e for e in ends if mangled[d.end():e].endswith('_kernel')
                                and mangled[d.end()].isalpha()), 0)
                    if end:
                        name = mangled[d.end():end] + mangled[end:end + 40]
                        break
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r'Used (\d+) registers', line)
            if m and name:
                rows.append([name, int(m.group(1)), *spill])
                name, spill = None, (0, 0)
        out[src] = rows
    return out


def sass_counts(library, opcodes=('HGMMA', 'UTMALDG')):
    """How many of each SASS opcode every kernel of a built library holds,
    from ``cuobjdump --dump-sass``: {kernel: {opcode: count}} (kernel: the
    name that ends in _kernel, from its mangled name)."""
    import re
    from hudiff_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), 'cuobjdump')
    out = subprocess.run([tool, '--dump-sass', str(library)], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    counts, kernel = {}, None
    for line in out.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            kernel = next((m.group(1)[d.end():e] for d in re.finditer(r'\d+', m.group(1))
                           for e in (d.end() + int(d.group()[k:]) for k in range(len(d.group())))
                           if re.fullmatch(r'[A-Za-z]\w*_kernel', m.group(1)[d.end():e])),
                          m.group(1))
            counts[kernel] = dict.fromkeys(opcodes, 0)
        elif kernel:
            for op in opcodes:
                if re.search(rf'\b{op}\b', line):
                    counts[kernel][op] += 1
    return counts


MARK = 'chip_smoke_profiled_run'


def profiled_run(torch, work, between=None):
    """torch.profiler over two runs of ``work()``: the first only warms the
    profiler, which can drop the records of the first kernels it sees (on
    an H100 it missed the first kernels of the nano forward's window, the
    same number in every retry; the records' ``profiler`` key counts them).
    ``between()``, when given, is called after the first run. The second run
    follows a marker, with the device idle 50 ms on either side of it (the
    profiler's device and host clocks can lie a millisecond apart) and
    after it; ``work`` synchronizes at its end. Returns the device kernel
    events (not user annotations, which can span the kernels they enclose
    on the device timeline) of the first and of the second run, in start
    order."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    def settle():
        torch.cuda.synchronize()
        time.sleep(0.05)

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        work()
        if between is not None:
            between()
        settle()
        with record_function(MARK):
            pass
        settle()
        work()
        settle()
    events = prof.events()
    mark = next(e.time_range.start for e in events if e.name == MARK)
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, 'is_user_annotation', False)),
                     key=lambda e: e.time_range.start)
    return ([e for e in kernels if e.time_range.start < mark],
            [e for e in kernels if e.time_range.start > mark])


def launch_times(torch, fn, counter, n=5):
    """The device ms of each kernel one call of ``fn`` launches, in launch
    order (median over ``n`` calls, each in a profiled run of its own), from
    the profiler; a run whose kernel records are not the ``counter()``
    launches of one call is read again (the profiler can miss or carry over
    a record, PERF.md §6); 'not measured' when none is."""
    fn()
    torch.cuda.synchronize()
    before = counter()
    fn()
    torch.cuda.synchronize()
    per = counter() - before
    runs, names = [], None

    def work():
        fn()
        torch.cuda.synchronize()

    for _ in range(2 * n):
        ks = [e for e in profiled_run(torch, work)[1] if 'bytenet' in e.name]
        if len(ks) == per:
            runs.append([e.time_range.elapsed_us() / 1e3 for e in ks])
            names = [e.name[:80] for e in ks]
        if len(runs) == n:
            break
    if not runs:
        return 'not measured'
    return [{'kernel': names[i], 'ms': statistics.median(r[i] for r in runs)}
            for i in range(per)]


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
    from hudiff_tpu_torch.ops.rope import rope_tables
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
    emit({'phase': 'registers', 'kernels': ptxas_registers(_build.BUILD_LOGS)})

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
            res_ref = FA.rope_attention_qkv_reference(qkv, cos, sin, scale, heads,
                                                      residuals=True)
            rec.update(residual_check(
                torch, name, out,
                FA.rope_attention_qkv_forward(qkv, cos, sin, scale, heads, residuals=True),
                res_ref, out_f32_controls(torch, *FA.split_qkv_heads(qkv, heads), cos, sin,
                                          scale, heads, res_ref[0])))
            del res_ref
            if not rec['residuals_ok']:
                emit(rec)
                fail(f'K1 writing the residuals: other bits or residuals off their plain '
                     f'versions ({name}, B={B})')
            qr, kr, vr = _rotated_bhld(torch, *FA.split_qkv_heads(qkv, heads), cos, sin, heads)
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
    results['K2'] = k2_phase(
        torch, gen, dev, [(cfg.d_model, cfg.activation, cfg.n_encoder_layers),
                          (cfg.sum_d_model, 'relu', cfg.dual_layers)],
        (MAIN_B, BIG_B), (C.HEAVY_LEN, C.LIGHT_LEN), cfg.aa_kernel_size, cfg.r, 'K2',
        launch_shape=(MAIN_B, cfg.sum_d_model, C.HEAVY_LEN, 1))

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
    reset_counters()
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

    # -- phases 6-10: the pretraining slice ------------------------------------
    results['K3'] = k3_phase(torch, gen, dev)
    results['K4'] = k4_phase(
        torch, gen, dev, [(cfg.d_model, cfg.activation, cfg.n_encoder_layers),
                          (cfg.sum_d_model, 'relu', cfg.dual_layers)],
        (MAIN_B, TRAIN_B), (C.HEAVY_LEN, C.LIGHT_LEN), cfg.aa_kernel_size, cfg.r, 'K4',
        launch_shape=(TRAIN_B, cfg.sum_d_model, C.HEAVY_LEN, 1))
    train_step_f32(torch, cfg, dev)
    pre = pretrain_phase(torch, dev)
    per_step = profile_train(torch, pre['model'], dev)
    trained, ab_ckpt = pre['launches'], pre['ckpt']
    del pre
    torch.cuda.empty_cache()

    # -- the nano path (HuDiff-Nb) ------------------------------------------------
    nano = nano_phases(torch, dev)

    # -- fine-tuning against frozen AbNatiV scorers (Nb and Ab) -----------------
    tuned = finetune_phases(torch, dev, ab_ckpt, nano['ckpt'])

    # -- the humanization service and the sampling variants --------------------
    served, ab_tuned, nano_tuned = service_phases(torch, dev, ab_ckpt, nano['ckpt'])

    # -- the evaluation path and the released payloads -------------------------
    evaluated = eval_phases(torch, dev, ab_tuned, nano_tuned)

    # -- phases 11-15: the remaining entry points ------------------------------
    results['K5'] = k5_phase(torch, gen, dev)
    results['K6'] = k6_phase(torch, gen, dev)
    api = attention_api_phase(torch, gen, dev)
    results['K7'] = k7_phase(torch, gen, dev)
    results['K8'] = k8_phase(torch, dev)

    # -- the kernels line ------------------------------------------------------
    k1, k1_f32 = results['K1'][(MAIN_B, 'bfloat16')], results['K1'][(MAIN_B, 'float32')]
    k2, k2_f32 = results['K2'][(MAIN_B, 'bfloat16')], results['K2'][(MAIN_B, 'float32')]
    k3, k3_f32 = results['K3'][(TRAIN_B, 'bfloat16')], results['K3'][(TRAIN_B, 'float32')]
    k4, k4_f32 = results['K4'][(TRAIN_B, 'bfloat16')], results['K4'][(TRAIN_B, 'float32')]
    n2 = k2['calls']   # tower shapes measured in phase 3: one per block of a forward
    n4 = k4['calls']
    nk = nano_entries(nano)
    emit({'kernels': [
        {'name': 'K1 fused RoPE attention (merged head-major qkv)', 'route': 'cuda',
         'source': 'hudiff_tpu_torch/csrc/rope_attention.cu',
         'replaces': 'hudiff_tpu/ops/pallas_attention.py:224',
         'launches': launches['K1'], 'launches_per_forward': launches['K1'] / steps,
         'launches_pretrain': trained['K1'],
         'max_abs_err': k1['max_abs_err'], 'excess_over_rtol': k1['excess_over_rtol'],
         'max_abs_err_f32': k1_f32['max_abs_err'], 'ms': k1['ms'],
         'plain_ms': k1['plain_ms'], 'bound_ms': k1['bound_ms'], 'bound_by': k1['bound_by'],
         'library_ms': k1['library_ms'], 'shape': f'B={MAIN_B} L=291 H=8 D=64 bf16',
         **nk['K1'], **tuned['K1'], 'launches_serve': served['K1'], **evaluated['K1']},
        {'name': 'K2 ByteNet block forward (three GEMMs, each LayerNorm + activation '
                 'applied as its operand lands)',
         'route': 'cuda',
         'source': 'hudiff_tpu_torch/csrc/bytenet_block.cu',
         'replaces': 'hudiff_tpu/ops/pallas_bytenet.py:162',
         'launches': launches['K2'], 'launches_per_forward': launches['K2'] / steps,
         'launches_pretrain': trained['K2'],
         'max_abs_err': k2['max_abs_err'], 'excess_over_rtol': k2['excess_over_rtol'],
         'max_abs_err_f32': k2_f32['max_abs_err'], 'ms': k2['ms'] / n2,
         'plain_ms': k2['plain_ms'] / n2, 'bound_ms': k2['bound_ms'] / n2,
         'bound_by': k2['bound_by'], 'library_ms': k2['library_ms'] / n2,
         'library': LIBRARY_COMPOSITION, 'ms_per_forward': k2['ms'],
         'stage_excess': {k: k2[k] for k in STAGE_KEYS},
         'launch_ms_one_dual_tower_call': k2['launch_ms'],
         'shape': f'B={MAIN_B}, one call (all its kernels), mean over the {n2} '
                  'tower blocks of one forward, bf16', **nk['K2'], **tuned['K2'],
         'launches_serve': served['K2'], **evaluated['K2']},
        {'name': 'K3 fused RoPE attention backward (merged head-major dqkv)',
         'route': 'cuda', 'source': 'hudiff_tpu_torch/csrc/rope_attention_bwd.cu',
         'replaces': 'hudiff_tpu/ops/pallas_attention.py:248',
         'launches': trained['K3'], 'launches_per_step': per_step['K3'],
         'max_abs_err': k3['max_abs_err'], 'excess_over_rtol': k3['excess_over_rtol'],
         'max_abs_err_f32': k3_f32['max_abs_err'], 'ms': k3['ms'],
         'ms_standalone': k3['ms_standalone'],
         'plain_ms': k3['plain_ms'], 'bound_ms': k3['bound_ms'], 'bound_by': k3['bound_by'],
         'library_ms': k3['library_ms'],
         'shape': f'B={TRAIN_B} L=291 H=8 D=64 bf16, one call given K1\'s residuals '
                  '(three kernels); ms_standalone runs K1 for them first', **nk['K3'],
         **tuned['K3']},
        {'name': 'K4 ByteNet block backward (three data GEMMs with the LayerNorm '
                 'backward in their epilogues, one grouped weight-gradient GEMM, one '
                 'fixed-order sum)',
         'route': 'cuda', 'source': 'hudiff_tpu_torch/csrc/bytenet_block_bwd.cu',
         'replaces': 'hudiff_tpu/ops/pallas_bytenet.py:192',
         'launches': trained['K4'], 'launches_per_step': per_step['K4'],
         'max_abs_err': k4['max_abs_err'], 'excess_over_rtol': k4['excess_over_rtol'],
         'max_abs_err_f32': k4_f32['max_abs_err'], 'grad_rel_err': k4['grad_rel_err'],
         'ms': k4['ms'] / n4, 'plain_ms': k4['plain_ms'] / n4,
         'bound_ms': k4['bound_ms'] / n4, 'bound_by': k4['bound_by'],
         'library_ms': k4['library_ms'] / n4,
         'library': LIBRARY_COMPOSITION + ', its autograd backward',
         'ms_per_step': k4['ms'], 'bound_ms_per_step': k4['bound_ms'],
         'library_ms_per_step': k4['library_ms'],
         'launch_ms_one_dual_tower_call': k4['launch_ms'],
         'shape': f'B={TRAIN_B}, one call (all its kernels), mean over the {n4} '
                  'tower blocks of one step, bf16', **nk['K4'], **tuned['K4']},
        *later_kernels(results, api)]})
    emit({'phase': 'done', 'total_s': time.perf_counter() - t_start})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


# CUDA kernel names by group, matched in this order (K3's and K6's prefixes
# also take their prologue kernels, rope_attention_[sep_]bwd_prep_kernel)
KERNEL_GROUPS = (('K4', ('bytenet_bwd_',)), ('K3', ('rope_attention_bwd_',)),
                 ('K6', ('rope_attention_sep_bwd_',)),
                 ('K5', ('rope_attention_sep_fwd_kernel',)),
                 ('K1', ('rope_attention_qkv_kernel',)),
                 ('K7', ('plain_attention_kernel',)), ('K8', ('fused_layer_',)),
                 ('K2', ('bytenet_fwd_gemm_kernel',)),
                 ('cublas', ('gemm', 'cutlass', 'nvjet', 'xmma')))
KERNELS = ('K1', 'K2', 'K3', 'K4', 'K5', 'K6', 'K7', 'K8')


def kernel_groups(events, n):
    """From the device kernel events of ``n`` repeats (``profiled_run``):
    device ms per repeat by group (K1-K8, cuBLAS, other), the number of
    K1-K8 kernels seen, and every kernel with device time, largest first."""
    by_name = {}
    for e in events:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    groups = dict.fromkeys(KERNELS + ('cublas', 'other'), 0.0)
    seen = dict.fromkeys(KERNELS, 0)
    for name, (ms, calls) in by_name.items():
        key = name.lower()
        g = next((g for g, names in KERNEL_GROUPS if any(s in key for s in names)), 'other')
        groups[g] += ms / n
        if g in seen:
            seen[g] += calls
    top = sorted(({'kernel': name[:90], 'calls': calls, 'ms_per_repeat': ms / n}
                  for name, (ms, calls) in by_name.items() if ms > 0),
                 key=lambda t: t['ms_per_repeat'], reverse=True)
    return groups, seen, top


def profiled(torch, window, n):
    """``window()`` profiled (``profiled_run``; it sets the counters to 0
    before the kernels it profiles and synchronizes at its end): (counters
    read just after, kernel_groups over ``n`` repeats, the ``profiler``
    record). The record holds ``warmup_run_missed``: the launches of each
    kernel of K1-K8 whose records the profiler dropped in the warm-up run,
    which ``profiled_run`` leaves out of the counts. A window whose counters
    differ from the K1-K8 kernels seen after the marker is profiled again,
    up to twice, the last reading held; the record then also keeps the
    first reading and how many windows followed it."""
    rec, windows = {}, 3
    for attempt in range(windows):
        warm = {}
        before, after = profiled_run(torch, window, lambda: warm.update(counters()))
        warm_seen = kernel_groups(before, n)[1]
        rec.setdefault('warmup_run_missed', []).append(
            {k: warm[k] - warm_seen[k] for k in KERNELS if warm[k] != warm_seen[k]})
        counted = counters()
        groups, seen, top = kernel_groups(after, n)
        if counted == seen or attempt == windows - 1:
            return counted, (groups, seen, top), rec
        rec.setdefault('first_window', {'counted_launches': counted, 'profiled_launches': seen})
        rec['first_window']['profiled_again'] = attempt + 1


def profile(torch, model, hum, inputs, phase='profile'):
    """Device time by kernel over a few bf16 forwards at the main batch,
    from torch.profiler, beside the host-clock time of the same forwards
    and of warm sampler steps (forward + draw + write-back). Checks that the
    wrappers' launch counters rose by the number of K1 and K2 kernels the
    profiler saw, and returns those numbers per forward. The model's inputs
    are the rows' tokens and the humanizer's conditioning (``COND``)."""
    import numpy as np
    rows = [inputs[i % len(inputs)] for i in range(MAIN_B)]
    args = [torch.as_tensor(np.stack([r[k] for r in rows]), dtype=torch.long,
                            device='cuda') for k in ('tokens', *hum.COND)]
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
        hum.run(args[0], order, hum.generator, *args[1:])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hum.run(args[0], order, hum.generator, *args[1:])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / order.shape[1] * 1e3

        def window():
            reset_counters()
            for _ in range(n):
                model(*args)
            torch.cuda.synchronize()

        counted, (groups, seen, top), first = profiled(torch, window, n)
    busy = sum(groups.values())
    emit({'phase': phase, 'B': MAIN_B, 'forwards': n, 'wall_ms_per_forward': wall_ms,
          'wall_ms_per_sampler_step': step_ms, 'host_issue_ms_per_forward': host_ms,
          'device_busy_ms_per_forward': busy,
          'device_idle_share': (1 - busy / wall_ms) if busy else 'not measured',
          'kernels_per_forward': sum(t['calls'] for t in top) / n,
          'device_ms_per_forward_by_group': groups,
          'top': top[:12], 'counted_launches': counted, 'profiled_launches': seen,
          'profiler': first})
    if counted != seen or any(v % n for v in seen.values()):
        fail(f'launch counters {counted} != kernels the profiler saw {seen}')
    return {k: v // n for k, v in seen.items()}


def counters():
    """The eight wrappers' launch counters."""
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    from hudiff_tpu_torch.tools import fused_layer_probe as FL
    return {'K1': FA.launches, 'K2': FB.launches, 'K3': FA.bwd_launches,
            'K4': FB.bwd_launches, 'K5': FA.rope_launches, 'K6': FA.rope_bwd_launches,
            'K7': FA.attention_launches, 'K8': FL.launches}


def reset_counters():
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    from hudiff_tpu_torch.tools import fused_layer_probe as FL
    FA.launches = FB.launches = FA.bwd_launches = FB.bwd_launches = 0
    FA.rope_launches = FA.rope_bwd_launches = FA.attention_launches = FL.launches = 0


def k2_phase(torch, gen, dev, towers, batches, lengths, K, r, phase, launch_shape=None):
    """K2 against its plain version at every block of ``towers`` ((D,
    activation, blocks) over the dilation cycle up to ``r``), each length
    and batch, f32 and bf16: one record a call, and a ``<phase>_forward_total``
    over the calls of one (B, dtype) with times summed. bf16 calls also
    time the PyTorch composition, split the excess by stage, and at
    ``launch_shape`` (B, D, L, dilation) read each launch's device ms."""
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    from hudiff_tpu_torch.ops.bytenet import ByteNetBlock, dilation_schedule
    out = {}
    for B in batches:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            tot = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'calls': 0,
                   'max_abs_err': 0.0, 'excess_over_rtol': 0.0, 'bytes_ms': 0.0,
                   'ops_ms': 0.0, 'library_ms': 0.0 if dtype == torch.bfloat16 else None}
            for d, act, n_layers in towers:
                h = d // 2
                for Lc in lengths:
                    for dil in dilation_schedule(n_layers, r):
                        blk = ByteNetBlock(d, h, K, dilation=dil, activation=act)
                        args = [t.to(dev, dtype) if t.dim() >= 2 else t.to(dev)
                                for t in _block_params(torch, gen, blk)]
                        x = torch.randn(B, Lc, d, generator=gen).to(dev, dtype)
                        kw = dict(dilation=dil, activation_name=act)
                        y = FB.bytenet_block(x, *args, **kw)
                        ref = FB.bytenet_block_reference(x, *args, **kw)
                        torch.cuda.synchronize()
                        errs, ok = check_err(torch, 'K2', y, ref)
                        rec = {'phase': phase, 'B': B, 'L': Lc, 'D': d, 'H': h, 'act': act,
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
                        if dtype == torch.bfloat16:
                            rec.update(k2_stage_excess(torch, x, args, dil, act))
                            lib = composition_params(args, dtype)
                            rec['library_ms'] = time_ms(
                                torch, lambda: block_composition(x, lib, dil, act),
                                reps=5, windows=3)
                            rec['library_max_abs_err'] = (block_composition(x, lib, dil, act)
                                                          .float() - ref.float()).abs().max().item()
                            tot['library_ms'] += rec['library_ms']
                            if (B, d, Lc, dil) == launch_shape:
                                rec['launch_ms'] = tot['launch_ms'] = launch_times(
                                    torch, lambda: FB.bytenet_block(x, *args, **kw),
                                    lambda: FB.launches)
                        emit(rec)
                        for key in ('ms', 'plain_ms', 'bound_ms'):
                            tot[key] += rec[key]
                        tot['calls'] += 1
                        for key in ('max_abs_err', 'excess_over_rtol', *STAGE_KEYS):
                            if key in rec:
                                tot[key] = max(tot.get(key, 0.0), rec[key])
                        del x, y, ref
            # the calls together: whichever side dominates the sum
            tot['bound_by'] = 'bytes' if tot['bytes_ms'] >= tot['ops_ms'] else 'operations'
            emit({'phase': f'{phase}_forward_total', 'B': B, 'dtype': name, **tot})
            out[(B, name)] = tot
            torch.cuda.empty_cache()
    return out


def k3_phase(torch, gen, dev):
    """K3 against its plain version at L = 291, B = 16 and 128, f32 and
    bf16, and at SHORT_LENGTHS (B = 128, bf16); times beside the plain
    version and the backward alone of scaled_dot_product_attention on
    pre-rotated q/k/v with the same dO."""
    import torch.nn.functional as F
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops.rope import rope_tables
    heads, hd, L = 8, 64, C.PAIR_LEN
    cos, sin = rope_tables(hd, L, device=dev)
    scale = 1.0 / hd ** 0.5
    out = {}
    for B in (MAIN_B, TRAIN_B):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            qkv = torch.randn(B, L, heads * 3 * hd, generator=gen).to(dev, dtype)
            do = torch.randn(B, L, heads * hd, generator=gen).to(dev, dtype)
            o_bf, o32, lse = FA.rope_attention_qkv_forward(qkv, cos, sin, scale, heads, True)
            res = dict(out=o32, lse=lse)
            got = FA.rope_attention_qkv_backward(qkv, cos, sin, do, scale, heads, **res)
            again = FA.rope_attention_qkv_backward(qkv, cos, sin, do, scale, heads, **res)
            alone = FA.rope_attention_qkv_backward(qkv, cos, sin, do, scale, heads)
            ref = FA.rope_attention_qkv_backward_reference(qkv, cos, sin, do, scale, heads)
            twin = FA.rope_attention_qkv_backward_reference(qkv, cos, sin, do, scale, heads,
                                                            o32, lse)
            rounded = FA.rope_attention_qkv_backward(
                qkv, cos, sin, do, scale, heads, out=o_bf.float(),
                lse=lse) if dtype == torch.bfloat16 else None
            torch.cuda.synchronize()
            errs, ok = backward_checks(torch, 'K3', got, again, alone, ref, twin)
            rec = {'phase': 'K3', 'B': B, 'L': L, 'dtype': name, **errs,
                   **delta_reading(torch, 'K3', rounded, ref)}
            if not ok:
                emit(rec)
                fail(f'K3 disagrees with its plain versions or repeats apart ({name}, B={B})')
            del got, again, alone, ref, twin, rounded, o_bf
            qr, kr, vr = (t.requires_grad_() for t in _rotated_bhld(
                torch, *FA.split_qkv_heads(qkv, heads), cos, sin, heads))
            o = F.scaled_dot_product_attention(qr, kr, vr, scale=scale)
            dO = do.reshape(B, L, heads, hd).transpose(1, 2).contiguous()
            rec['library_ms'] = time_ms(torch, lambda: torch.autograd.grad(
                o, (qr, kr, vr), dO, retain_graph=True))
            del o, qr, kr, vr, dO
            # given the residuals, as autograd calls it (and as SDPA's backward
            # alone is timed); the standalone call runs K1 for them first
            rec['ms'] = time_ms(torch, lambda: FA.rope_attention_qkv_backward(
                qkv, cos, sin, do, scale, heads, **res))
            rec['ms_standalone'] = time_ms(torch, lambda: FA.rope_attention_qkv_backward(
                qkv, cos, sin, do, scale, heads))
            rec['plain_ms'] = time_ms(torch, lambda: FA.rope_attention_qkv_backward_reference(
                qkv, cos, sin, do, scale, heads), reps=2, windows=3)
            # read qkv and dO once, write dqkv once; five 2 L^2 D products
            nbytes = (2 * qkv.numel() + do.numel()) * qkv.element_size() + 2 * cos.numel() * 4
            flops = 5 * 2.0 * B * heads * L * L * hd
            rec['bound_ms'], rec['bound_by'] = bound_ms(nbytes, flops, name)
            emit(rec)
            out[(B, name)] = rec
            del qkv, do
            torch.cuda.empty_cache()
    # Shorter sequences, where attention is more peaked and the output
    # larger: K3 given the residuals held to its gate, and delta from the
    # bf16 output recorded beside it (inputs from their own seed, so the
    # phases after this one draw what they drew before)
    gen_short = torch.Generator(device='cpu').manual_seed(SEED + 1)
    for Ls in SHORT_LENGTHS:
        cs, sn = rope_tables(hd, Ls, device=dev)
        qkv = torch.randn(TRAIN_B, Ls, heads * 3 * hd, generator=gen_short).to(
            dev, torch.bfloat16)
        do = torch.randn(TRAIN_B, Ls, heads * hd, generator=gen_short).to(dev, torch.bfloat16)
        o_bf, o32, lse = FA.rope_attention_qkv_forward(qkv, cs, sn, scale, heads, True)
        got = FA.rope_attention_qkv_backward(qkv, cs, sn, do, scale, heads, out=o32, lse=lse)
        rounded = FA.rope_attention_qkv_backward(qkv, cs, sn, do, scale, heads,
                                                 out=o_bf.float(), lse=lse)
        ref = FA.rope_attention_qkv_backward_reference(qkv, cs, sn, do, scale, heads)
        torch.cuda.synchronize()
        errs, ok = check_err(torch, 'K3', got, ref)
        rec = {'phase': 'K3_short', 'B': TRAIN_B, 'L': Ls, 'dtype': 'bfloat16', **errs,
               **delta_reading(torch, 'K3', rounded, ref)}
        emit(rec)
        if not ok:
            fail(f'K3 disagrees with its plain version (bfloat16, B={TRAIN_B}, L={Ls})')
        del qkv, do, o_bf, o32, lse, got, rounded, ref
    return out


def _block_params(torch, gen, blk):
    with torch.no_grad():
        for ln in (blk.ln1, blk.ln2, blk.ln3):
            ln.weight.add_(0.1 * torch.randn(ln.weight.shape, generator=gen))
            ln.bias.add_(0.1 * torch.randn(ln.bias.shape, generator=gen))
    return [t.detach() for t in (blk.ln1.weight, blk.ln1.bias, blk.fc1.weight, blk.fc1.bias,
                                 blk.ln2.weight, blk.ln2.bias, blk.conv.weight,
                                 blk.conv.bias, blk.ln3.weight, blk.ln3.bias,
                                 blk.fc2.weight, blk.fc2.bias)]


def k4_phase(torch, gen, dev, towers, batches, lengths, K, r, phase, launch_shape=None):
    """K4 against its plain version at every block of ``towers`` ((D,
    activation, blocks) over the dilation cycle up to ``r``; the Ab towers
    are the 24 blocks of a step), each length and batch, f32 and bf16: dx
    elementwise, each parameter gradient by max |err| / max |ref|; per-call
    times summed over the blocks in ``<phase>_step_total``. The parameters
    are f32, as training holds them. At ``launch_shape`` (B, D, L,
    dilation) each launch's device ms is read."""
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    from hudiff_tpu_torch.ops.bytenet import ByteNetBlock, dilation_schedule
    out = {}
    for B in batches:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            tot = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'calls': 0, 'max_abs_err': 0.0,
                   'excess_over_rtol': 0.0, 'grad_rel_err': 0.0, 'bytes_ms': 0.0,
                   'ops_ms': 0.0, 'library_ms': 0.0 if dtype == torch.bfloat16 else None}
            for d, act, n_layers in towers:
                h = d // 2
                for Lc in lengths:
                    for dil in dilation_schedule(n_layers, r):
                        torch.manual_seed(SEED + d + Lc + dil)
                        blk = ByteNetBlock(d, h, K, dilation=dil, activation=act)
                        params = [t.to(dev) for t in _block_params(torch, gen, blk)]
                        x = torch.randn(B, Lc, d, generator=gen).to(dev, dtype)
                        dy = torch.randn(B, Lc, d, generator=gen).to(dev, dtype)
                        kw = dict(dilation=dil, activation_name=act)
                        _, p, q, st = FB._forward(x, params, dil, act, keep=True)
                        # as autograd calls it: given K2's LayerNorm statistics,
                        # held against the plain version given the same
                        got = FB.bytenet_block_backward(x, p, q, *params, dy, **kw, stats=st)
                        ref = FB.bytenet_block_backward_reference(x, p, q, *params, dy, **kw,
                                                                  stats=st)
                        torch.cuda.synchronize()
                        errs, ok = check_err(torch, 'K4', got[0], ref[0])
                        rel = grad_rel_err(got, ref)
                        ok = ok and rel <= K4_GRAD_RTOL[name] and all(
                            bool(torch.isfinite(g).all().item()) for g in got)
                        rec = {'phase': phase, 'B': B, 'L': Lc, 'D': d, 'H': h, 'act': act,
                               'dil': dil, 'dtype': name, **errs, 'grad_rel_err': rel,
                               'grad_rtol': K4_GRAD_RTOL[name]}
                        if not ok:
                            emit(rec)
                            fail(f'K4 disagrees with its plain version: {rec}')
                        del got, ref
                        # taking the statistics itself, against the plain version
                        # doing the same: recorded, not held (a ReLU input within
                        # rounding of 0 can take the other side in either)
                        alone = FB.bytenet_block_backward(x, p, q, *params, dy, **kw)
                        ref = FB.bytenet_block_backward_reference(x, p, q, *params, dy, **kw)
                        alone_errs, _ = check_err(torch, 'K4', alone[0], ref[0])
                        rec.update(standalone_max_abs_err=alone_errs['max_abs_err'],
                                   standalone_grad_rel_err=grad_rel_err(alone, ref))
                        del alone, ref
                        s = dtype.itemsize
                        # read x, p, q, dy and the f32 parameters; write dx and
                        # the f32 gradients. Twice the forward's products.
                        nbytes = (s * B * Lc * (3 * d + 2 * h)
                                  + 2 * 4 * (2 * d * h + K * h * h + 5 * h + 4 * d))
                        taps = sum(max(0, Lc - abs(t - (K - 1) // 2) * dil) for t in range(K))
                        flops = 2 * 2.0 * B * (Lc * 2 * d * h + taps * h * h)
                        rec['bound_ms'], rec['bound_by'] = bound_ms(nbytes, flops, name)
                        t_bytes, t_ops = bound_parts(nbytes, flops, name)
                        tot['bytes_ms'] += t_bytes
                        tot['ops_ms'] += t_ops
                        # timed as ByteNetBlockFn calls it: on the forward's copies of
                        # the weights in x's type, which K4 reads without rounding
                        cd_params = FB._prepared(params, dev, dtype)
                        call = lambda: FB.bytenet_block_backward(  # noqa: E731
                            x, p, q, *cd_params, dy, **kw, stats=st)
                        rec['ms'] = time_ms(torch, call, reps=5, windows=3)
                        rec['plain_ms'] = time_ms(
                            torch, lambda: FB.bytenet_block_backward_reference(
                                x, p, q, *params, dy, **kw, stats=st), reps=1, windows=3)
                        if dtype == torch.bfloat16:
                            rec['library_ms'] = composition_backward_ms(torch, x, params, dy,
                                                                        dil, act)
                            tot['library_ms'] += rec['library_ms']
                            if (B, d, Lc, dil) == launch_shape:
                                rec['launch_ms'] = tot['launch_ms'] = launch_times(
                                    torch, call, lambda: FB.bwd_launches)
                        emit(rec)
                        for key in ('ms', 'plain_ms', 'bound_ms'):
                            tot[key] += rec[key]
                        tot['calls'] += 1
                        for key in ('max_abs_err', 'excess_over_rtol', 'grad_rel_err',
                                    'standalone_max_abs_err', 'standalone_grad_rel_err'):
                            tot[key] = max(tot.get(key, 0.0), rec.get(key, 0.0))
                        del x, dy, p, q, st
            tot['bound_by'] = 'bytes' if tot['bytes_ms'] >= tot['ops_ms'] else 'operations'
            emit({'phase': f'{phase}_step_total', 'B': B, 'dtype': name, **tot})
            out[(B, name)] = tot
            torch.cuda.empty_cache()
    return out


def grad_rel_err(got, ref):
    """The largest of the 12 parameter gradients' max |err| / max |ref|."""
    return max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got[1:], ref[1:]))


def composition_backward_ms(torch, x, params, dy, dil, act):
    """ms of the backward of ``block_composition`` under autograd (its graph
    built once, then the gradients of x and the 12 parameters for ``dy``):
    K4's yardstick."""
    leaves = [x.detach().clone().requires_grad_()] + [
        t.requires_grad_() for t in composition_params(params, x.dtype)]
    y = block_composition(leaves[0], leaves[1:], dil, act)
    ms = time_ms(torch, lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True),
                 reps=3, windows=3)
    del y
    return ms


def _pair_batch(torch, B, seed):
    """(tokens, chain_type, fixed Corrupted) for a pair train step: about
    half of each row's framework masked, the mean of OA-ARDM's draws."""
    import numpy as np
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.ops import masking as M
    rs = np.random.RandomState(seed)
    tokens = torch.from_numpy(rs.randint(0, C.N_AA, (B, C.PAIR_LEN)))
    cdr = torch.from_numpy(np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX]) != 0)
    mask = torch.from_numpy(rs.rand(B, C.PAIR_LEN) < 0.5) & ~cdr
    chain = torch.from_numpy(np.stack([np.zeros(B), rs.randint(1, 3, B)], 1)).long()
    return tokens, chain, M.Corrupted(torch.where(mask, C.IDX_MSK, tokens), mask, mask.sum(-1))


def _heavy_batch(torch, B, seed):
    """(tokens, None, fixed Corrupted) for a heavy train step, as
    ``_pair_batch`` draws them over the 152 heavy slots."""
    import numpy as np
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.ops import masking as M
    rs = np.random.RandomState(seed)
    tokens = torch.from_numpy(rs.randint(0, C.N_AA, (B, C.HEAVY_LEN)))
    mask = torch.from_numpy(rs.rand(B, C.HEAVY_LEN) < 0.5) & ~torch.from_numpy(
        C.HEAVY_CDR_INDEX != 0)
    return tokens, None, M.Corrupted(torch.where(mask, C.IDX_MSK, tokens), mask, mask.sum(-1))


def _kind_parts(kind):
    """(model class, batch maker, ByteNet blocks a forward, phase suffix) of
    the pair (HuDiff-Ab) or heavy (HuDiff-Nb) path."""
    from hudiff_tpu_torch.models.denoiser import AntiTFNet, NanoAntiTFNet
    if kind == 'pair':
        return AntiTFNet, _pair_batch, lambda c: 2 * (c.n_encoder_layers + c.dual_layers), ''
    return NanoAntiTFNet, _heavy_batch, lambda c: c.n_encoder_layers + c.dual_layers, '_nano'


def _train_step_fn(model, kind, **kw):
    """``step(state, tokens, chain_or_None, seed, corrupted=None)`` of the kind."""
    from hudiff_tpu_torch.training import train_step as T
    if kind == 'pair':
        return T.make_pair_train_step(model, **kw)
    heavy = T.make_heavy_train_step(model)
    return lambda state, tokens, chain, seed, corrupted=None: heavy(state, tokens, seed,
                                                                    corrupted)


def train_step_f32(torch, cfg, dev, kind='pair'):
    """One full-width f32 train step (B = 2, dropout off, a fixed mask, TF32
    off) on the card against the CPU: the loss and every parameter's
    gradient, with the launches the card's step made. Beside it, how far
    the card's own gradients move when the token embedding is scaled by
    (1 + 1e-6): the model's conditioning, which the limits must allow for."""
    from hudiff_tpu_torch.ops import masking as M
    from hudiff_tpu_torch.training import train_step as T
    model_cls, make_batch, blocks, suffix = _kind_parts(kind)
    torch.manual_seed(SEED)
    cpu_model = model_cls(cfg).eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    tokens, chain, cor = make_batch(torch, 2, SEED)

    def step(model, d):
        """(loss, {name: gradient on the CPU}, launches) of one step on d."""
        kept = {}

        class KeepGrads(torch.optim.Optimizer):
            def step(self, closure=None):
                kept.update((n, p.grad.detach().cpu().clone())
                            for n, p in model.named_parameters())

        state = T.TrainState(model, KeepGrads(model.parameters(), {}))
        reset_counters()
        m = _train_step_fn(model, kind)(state, tokens.to(d),
                                        None if chain is None else chain.to(d), SEED,
                                        M.Corrupted(*(t.to(d) for t in cor)))
        return m['loss'].item(), kept, counters()

    def rel_errs(got, ref):
        return {n: ((got[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30)).item()
                for n in ref}

    loss_c, g_c, _ = step(cpu_model, torch.device('cpu'))
    loss_g, g_g, launched = step(gpu_model, dev)
    with torch.no_grad():
        gpu_model.aa_embed.weight.mul_(1 + 1e-6)
    moved = rel_errs(step(gpu_model, dev)[1], g_g)
    most_moved = max(moved, key=moved.get)
    rel = rel_errs(g_g, g_c)
    order = sorted(rel, key=rel.get, reverse=True)
    worst = order[0]
    glob = (sum(((g_g[n] - g_c[n]) ** 2).sum().item() for n in g_c)
            / sum((g_c[n] ** 2).sum().item() for n in g_c)) ** 0.5
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    expected = {'K1': 2 * cfg.cs_layers, 'K3': 6 * cfg.cs_layers,
                'K2': K2_LAUNCHES * blocks(cfg), 'K4': K4_LAUNCHES * blocks(cfg),
                'K5': 0, 'K6': 0, 'K7': 0, 'K8': 0}
    emit({'phase': 'train_step_f32' + suffix, 'B': 2, 'loss_cpu': loss_c, 'loss_card': loss_g,
          'loss_rel_err': loss_rel, 'max_grad_rel_err': rel[worst], 'worst_param': worst,
          'worst_five': {n: rel[n] for n in order[:5]}, 'global_grad_rel_err': glob,
          'embed_scaled_1e-6_max_grad_rel_change': moved[most_moved],
          'embed_scaled_1e-6_most_moved': most_moved,
          'params': len(rel), 'tol': TRAIN_STEP_RTOL, 'global_tol': TRAIN_STEP_GLOBAL_RTOL,
          'loss_tol': TRAIN_STEP_LOSS_RTOL, 'launches': launched,
          'expected_launches': expected})
    if not (sorted(g_c) == sorted(g_g) and loss_rel <= TRAIN_STEP_LOSS_RTOL
            and rel[worst] <= TRAIN_STEP_RTOL and glob <= TRAIN_STEP_GLOBAL_RTOL
            and launched == expected):
        fail(f'full-width f32 {kind} train step on the card disagrees with the CPU')


def pretrain_phase(torch, dev, config=None, kind='pair'):
    """``pretrain.run`` at the full width of ``config`` (PRETRAIN_CONFIG,
    configs/antibody_train.yml; NANO_PRETRAIN_CONFIG, configs/heavy_train.yml)
    in bf16 with synthetic data and batch_acc 2: the launch counts, finite
    losses, changed parameters, a best-val checkpoint that restores (as the
    kind's model) to the same logits, steps/s after a warm iteration and
    the peak memory. The best checkpoint is kept (``ckpt``) for the
    fine-tune phases."""
    import numpy as np
    from hudiff_tpu_torch.models.denoiser import DenoiserConfig
    from hudiff_tpu_torch.training import checkpoints as CKPT
    from hudiff_tpu_torch.training import pretrain as PT
    from hudiff_tpu_torch.training import train_step as T
    from hudiff_tpu_torch.utils.config import Namespace
    model_cls, make_batch, blocks, suffix = _kind_parts(kind)
    cfg = Namespace.wrap(copy.deepcopy(config or PRETRAIN_CONFIG))
    mcfg = DenoiserConfig.from_dict(cfg.model)
    acc, B = cfg.train.batch_acc, cfg.train.batch_size
    torch.manual_seed(SEED)
    model = model_cls(mcfg, dtype=torch.bfloat16, device=dev)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build', 'chip_smoke_runs')
    shutil.rmtree(root, ignore_errors=True)
    synthetic = 2 * B   # two validation batches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    log_dir = PT.run(cfg, kind=kind, synthetic=synthetic, max_iter=PRETRAIN_ITERS,
                     logdir=root, seed=SEED, device='cuda', model=model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counters()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(log_dir, 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if 'train/loss' in r]
    val = [r for r in rows if 'val/loss' in r]
    steps, val_forwards = PRETRAIN_ITERS * acc, max(1, min(4, synthetic // B))
    expected = {'K1': (steps + val_forwards) * 2 * mcfg.cs_layers,
                'K2': (steps + val_forwards) * blocks(mcfg) * K2_LAUNCHES,
                'K3': steps * 2 * mcfg.cs_layers * 3,
                'K4': steps * blocks(mcfg) * K4_LAUNCHES,
                'K5': 0, 'K6': 0, 'K7': 0, 'K8': 0}
    # host time at the end of iteration i is i * acc / steps_per_sec(i);
    # iteration 2 is warm and runs no validation
    ends = [r['step'] * acc / r['train/steps_per_sec'] for r in train]
    warm_sps = acc / (ends[1] - ends[0]) if len(ends) >= 2 else 'not measured'
    changed = sum(not torch.equal(before[k], v.detach()) for k, v in model.named_parameters())
    ckpt_dir = os.path.join(log_dir, 'checkpoints')
    latest = CKPT.latest_step(ckpt_dir)
    tokens, chain, _ = make_batch(torch, 2, SEED + 3)
    region = torch.from_numpy(T.pair_region_batch(2) if kind == 'pair'
                              else T.heavy_region_batch(2))
    args = [t.to(dev) for t in (tokens, region, chain) if t is not None]
    restored_ckpt = CKPT.restore(ckpt_dir)
    restored = CKPT.model_class(restored_ckpt['kind'])(mcfg, dtype=torch.bfloat16, device=dev)
    restored.load_state_dict(restored_ckpt['payload']['model'])
    loaded, _ = CKPT.load(os.path.join(ckpt_dir, f'step_{latest}.pt'), dtype=torch.bfloat16)
    with torch.inference_mode():
        ref = model.eval()(*args)
        diffs = [(m.eval()(*args) - ref).abs().max().item() for m in (restored, loaded)]
    rec = {'phase': 'pretrain' + suffix, 'B': B, 'batch_acc': acc, 'iterations': len(train),
           'steps': steps, 'wall_s': wall,
           'train_loss': [r['train/loss'] for r in train],
           'opt_steps': [int(r['train/opt_steps']) for r in train],
           'val_loss': [r['val/loss'] for r in val], 'saved_step': latest,
           'restored_as': [type(m).__name__ for m in (restored, loaded)],
           'steps_per_sec': train[-1]['train/steps_per_sec'] if train else 'not measured',
           'steps_per_sec_warm': warm_sps, 'ms_per_step_warm': (
               1e3 / warm_sps if isinstance(warm_sps, float) else 'not measured'),
           'max_memory_allocated_gb': peak / 1e9,
           'params_changed': changed, 'params': len(before),
           'restore_max_abs_logit_diff': diffs, 'launches': launched,
           'expected_launches': expected, 'launches_per_step': {
               k: v / steps for k, v in launched.items()}}
    emit(rec)
    kept = os.path.join(os.path.dirname(root), 'chip_smoke_ckpts', f'pretrain{suffix}.pt')
    os.makedirs(os.path.dirname(kept), exist_ok=True)
    shutil.copyfile(os.path.join(ckpt_dir, f'step_{latest}.pt'), kept)
    shutil.rmtree(root, ignore_errors=True)
    ok = (rec['opt_steps'] == [acc * (i + 1) for i in range(PRETRAIN_ITERS)]
          and all(np.isfinite(rec['train_loss'])) and len(val) == 1
          and np.isfinite(rec['val_loss']).all() and latest == PRETRAIN_ITERS
          and all(isinstance(m, model_cls) for m in (restored, loaded))
          and changed == len(before) and max(diffs) == 0.0 and launched == expected)
    if not ok:
        fail(f'full-width {kind} pretraining failed its checks')
    return {'model': model, 'launches': launched, 'ckpt': kept}


def profile_train(torch, model, dev, config=None, kind='pair', expected=None):
    """Device time by kernel group over one warm bf16 train step at the
    config's batch (torch.profiler), beside the host-clock time of warm
    steps; checks that the launch counters rose by the K1-K8 kernels the
    profiler saw (K5-K8 none; ``expected``, when given, the exact counts),
    and returns those numbers per step."""
    from hudiff_tpu_torch.training import pretrain as PT
    from hudiff_tpu_torch.training import schedules
    from hudiff_tpu_torch.training import train_step as T
    from hudiff_tpu_torch.utils.config import Namespace
    suffix = _kind_parts(kind)[3]
    cfg = Namespace.wrap(copy.deepcopy(config or PRETRAIN_CONFIG))
    B = cfg.train.batch_size
    batch = next(PT.synthetic_batches(kind, B, SEED))
    tokens = torch.as_tensor(batch['tokens'], dtype=torch.long, device=dev)
    chain = (torch.as_tensor(batch['chain_type'], dtype=torch.long, device=dev)
             if kind == 'pair' else None)
    opt = schedules.make_optimizer(cfg.train.optimizer, model.parameters())
    state = T.TrainState(model, opt, clip_norm=cfg.train.clip_norm)
    step = _train_step_fn(model, kind, **(
        {'l_weight': cfg.train.l_loss_weight} if kind == 'pair' else {}))
    model.train()
    step(state, tokens, chain, SEED)
    torch.cuda.synchronize()
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, tokens, chain, SEED)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3

    def window():
        reset_counters()
        step(state, tokens, chain, SEED)
        torch.cuda.synchronize()

    counted, (groups, seen, top), first = profiled(torch, window, 1)
    busy = sum(groups.values())
    emit({'phase': 'profile_train' + suffix, 'B': B, 'wall_ms_per_step': wall_ms,
          'steps_per_sec': 1e3 / wall_ms, 'device_busy_ms_per_step': busy,
          'device_idle_share': (1 - busy / wall_ms) if busy else 'not measured',
          'kernels_per_step': sum(t['calls'] for t in top),
          'device_ms_per_step_by_group': groups,
          'top': top[:15], 'counted_launches': counted, 'profiled_launches': seen,
          'expected_launches': expected, 'profiler': first})
    if (counted != seen or not all(seen[k] for k in ('K1', 'K2', 'K3', 'K4'))
            or (expected is not None and seen != expected)):
        fail(f'launch counters {counted} != kernels the profiler saw {seen}'
             + (f' or != {expected}' if expected else ''))
    return seen


def k1_record(torch, qkv, cos, sin, heads, phase):
    """K1 on ``qkv`` [B, L, 3 * heads * hd] against its plain version (the
    run fails past the K1 limits), timed beside the plain version and SDPA
    on the rotated inputs, with its bound: the record, emitted."""
    import torch.nn.functional as F
    from hudiff_tpu_torch.ops import fused_attention as FA
    B, L, width = qkv.shape
    hd = width // (3 * heads)
    scale = 1.0 / hd ** 0.5
    name = str(qkv.dtype).split('.')[-1]
    o = FA.rope_attention_qkv(qkv, cos, sin, scale, heads)
    ref = FA.rope_attention_qkv_reference(qkv, cos, sin, scale, heads)
    torch.cuda.synchronize()
    errs, ok = check_err(torch, 'K1', o, ref)
    rec = {'phase': phase, 'B': B, 'L': L, 'dtype': name, **errs}
    if not ok:
        emit(rec)
        fail(f'K1 disagrees with its plain version at L = {L} ({name}, B={B})')
    del o, ref
    qr, kr, vr = _rotated_bhld(torch, *FA.split_qkv_heads(qkv, heads), cos, sin, heads)
    rec.update(
        ms=time_ms(torch, lambda: FA.rope_attention_qkv(qkv, cos, sin, scale, heads)),
        plain_ms=time_ms(torch, lambda: FA.rope_attention_qkv_reference(
            qkv, cos, sin, scale, heads), reps=2, windows=3),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qr, kr, vr, scale=scale)))
    nbytes = qkv.numel() * qkv.element_size() * 4 // 3 + 2 * cos.numel() * 4
    rec['bound_ms'], rec['bound_by'] = bound_ms(nbytes, 4.0 * B * heads * L * L * hd, name)
    emit(rec)
    return rec


def attention_nano_phase(torch, gen, dev):
    """K1 and K3 at the nano path's attention shape (L = 152, 8 x 64, qkv
    [B, 152, 1536]), f32 and bf16, against their plain versions: K1 at the
    sampler's batch and the training batch; K3 at the training batch, given
    K1's residuals as autograd calls it, against both plain versions. Timed
    as the Ab phases time them."""
    import torch.nn.functional as F
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops.rope import rope_tables
    heads, hd, L = 8, 64, C.HEAVY_LEN
    cos, sin = rope_tables(hd, L, device=dev)
    scale = 1.0 / hd ** 0.5
    out = {}
    for B in (MAIN_B, NANO_TRAIN_B):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            qkv = torch.randn(B, L, heads * 3 * hd, generator=gen).to(dev, dtype)
            out[('K1', B, name)] = k1_record(torch, qkv, cos, sin, heads, 'K1_nano')
            if B != NANO_TRAIN_B:
                continue
            qr, kr, vr = _rotated_bhld(torch, *FA.split_qkv_heads(qkv, heads), cos, sin, heads)
            do = torch.randn(B, L, heads * hd, generator=gen).to(dev, dtype)
            _, o32, lse = FA.rope_attention_qkv_forward(qkv, cos, sin, scale, heads, True)
            res = dict(out=o32, lse=lse)
            got = FA.rope_attention_qkv_backward(qkv, cos, sin, do, scale, heads, **res)
            again = FA.rope_attention_qkv_backward(qkv, cos, sin, do, scale, heads, **res)
            alone = FA.rope_attention_qkv_backward(qkv, cos, sin, do, scale, heads)
            ref = FA.rope_attention_qkv_backward_reference(qkv, cos, sin, do, scale, heads)
            twin = FA.rope_attention_qkv_backward_reference(qkv, cos, sin, do, scale, heads,
                                                            o32, lse)
            torch.cuda.synchronize()
            errs, ok = backward_checks(torch, 'K3', got, again, alone, ref, twin)
            rec = {'phase': 'K3_nano', 'B': B, 'L': L, 'dtype': name, **errs}
            if not ok:
                emit(rec)
                fail(f'K3 disagrees with its plain versions or repeats apart at L = {L} '
                     f'({name}, B={B})')
            del got, again, alone, ref, twin
            qr, kr, vr = (t.requires_grad_() for t in (qr, kr, vr))
            o = F.scaled_dot_product_attention(qr, kr, vr, scale=scale)
            dO = do.reshape(B, L, heads, hd).transpose(1, 2).contiguous()
            rec['library_ms'] = time_ms(torch, lambda: torch.autograd.grad(
                o, (qr, kr, vr), dO, retain_graph=True))
            del o, dO
            rec['ms'] = time_ms(torch, lambda: FA.rope_attention_qkv_backward(
                qkv, cos, sin, do, scale, heads, **res))
            rec['plain_ms'] = time_ms(torch, lambda: FA.rope_attention_qkv_backward_reference(
                qkv, cos, sin, do, scale, heads), reps=1, windows=3)
            nbytes = (2 * qkv.numel() + do.numel()) * qkv.element_size() + 2 * cos.numel() * 4
            rec['bound_ms'], rec['bound_by'] = bound_ms(
                nbytes, 5 * 2.0 * B * heads * L * L * hd, name)
            emit(rec)
            out[('K3', B, name)] = rec
            del qkv, do, qr, kr, vr, o32, lse
            torch.cuda.empty_cache()
    return out


class _KeptRows:
    """Mixed into a humanizer: keeps each nanobody's rows as sampled, before
    the validity filter, so that every row's CDRs can be checked."""

    def _filtered(self, inp, out):
        self.sampled.append((inp, out))
        return super()._filtered(inp, out)


def nano_phases(torch, dev):
    """The nano path (HuDiff-Nb) at the full width of configs/heavy_train.yml:
    K1-K4 at its shapes against their plain versions, the f32 forward card
    against CPU, a bf16 humanization round through
    ``NanoHumanizer.humanize_many`` with its launch check and a profile of
    forwards, the f32 heavy train step card against CPU, ``pretrain.run
    (kind='heavy')`` at B = 512 and a profile of one warm step."""
    import numpy as np
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.models.denoiser import DenoiserConfig, NanoAntiTFNet
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    from hudiff_tpu_torch.sampling import humanize as HZ
    cfg = DenoiserConfig.from_dict(NANO_PRETRAIN_CONFIG['model'])
    # inputs from a generator of their own: the phases after this one draw
    # what they drew before it existed
    gen = torch.Generator(device='cpu').manual_seed(SEED + 7)
    out = {'attention': attention_nano_phase(torch, gen, dev)}
    torch.manual_seed(SEED + 7)   # the blocks' initial weights
    nano_conv = [(cfg.sum_d_model, 'gelu', cfg.dual_layers)]
    K, L = cfg.aa_kernel_size, C.HEAVY_LEN
    out['K2'] = k2_phase(torch, gen, dev, nano_conv, (MAIN_B, TRAIN_B, NANO_TRAIN_B), (L,),
                         K, cfg.r, 'K2_nano', launch_shape=(MAIN_B, cfg.sum_d_model, L, 1))
    out['K4'] = k4_phase(torch, gen, dev, nano_conv, (MAIN_B, NANO_TRAIN_B), (L,), K, cfg.r,
                         'K4_nano', launch_shape=(NANO_TRAIN_B, cfg.sum_d_model, L, 1))

    # the full-width forward, f32 on the card vs the CPU
    torch.manual_seed(SEED)
    cpu_model = NanoAntiTFNet(cfg).eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rs = np.random.RandomState(SEED)
    tokens = torch.from_numpy(rs.randint(0, C.N_TOKENS, (2, L))).long()
    region = torch.from_numpy(np.tile(C.HEAVY_REGION_INDEX, (2, 1))).long()
    with torch.inference_mode():
        ref = cpu_model(tokens, region)
        got = gpu_model(tokens.to(dev), region.to(dev)).cpu()
    err = (got - ref).abs().max().item()
    emit({'phase': 'forward_f32_nano', 'B': 2, 'shape': list(got.shape), 'max_abs_err': err,
          'tol': FORWARD_ATOL, 'max_abs_logit': ref.abs().max().item()})
    if not (got.shape == (2, L, C.N_TOKENS) and torch.isfinite(got).all().item()
            and err <= FORWARD_ATOL):
        fail('full-width f32 nano forward on the card disagrees with the CPU')
    del cpu_model, gpu_model

    # a full-width humanization round, bf16 cast-once: host prep, the
    # sampler's 93 forwards and the validity filter timed apart
    class Humanizer(_KeptRows, HZ.NanoHumanizer):
        sampled = []

    torch.manual_seed(SEED + 1)
    model = NanoAntiTFNet(cfg, dtype=torch.bfloat16)
    hum = Humanizer(model, batch_size=MAIN_B // 2, seed=SEED, device='cuda',
                    device_batch=MAIN_B)
    t0 = time.perf_counter()
    inputs = [HZ.nano_input(VHH1), HZ.nano_input(VHH2)]
    prep_s = time.perf_counter() - t0
    if any(inp is None for inp in inputs):
        fail('nano_input rejected a test nanobody')
    steps = HZ._packed_pad_to(inputs)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = hum.humanize_many(inputs, rows_per_input=MAIN_B // 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {'K1': FA.launches, 'K2': FB.launches}
    cdr = C.HEAVY_CDR_INDEX != 0
    for inp, g in hum.sampled:
        keep = inp['tokens'] != C.IDX_MSK
        if (g.shape != (MAIN_B // 2, L) or (g == C.IDX_MSK).any() or (g < 0).any()
                or (g >= C.N_TOKENS - 1).any() or not (g[:, cdr] == inp['clean'][cdr]).all()
                or not (g[:, keep] == inp['tokens'][keep]).all()):
            fail('nano humanization output fails the CDR / protected-slot checks')
    sampler_s = wall - hum.filter_s
    emit({'phase': 'humanize_nano', 'rows': MAIN_B, 'forwards': steps, 'wall_s': wall,
          'sampler_s': sampler_s, 'filter_s': hum.filter_s, 'nano_input_s': prep_s,
          'seqs_per_s': MAIN_B / sampler_s, 'seqs_per_s_with_filter': MAIN_B / wall,
          'ms_per_forward': sampler_s / steps * 1e3,
          'rows_checked': sum(len(g) for _, g in hum.sampled),
          'rows_aligning_as_heavy': sum(len(r['seqs']) for r in res if r is not None),
          'launches': launches,
          'launches_per_forward': {k: v / steps for k, v in launches.items()},
          'cdr_unchanged': True})
    if steps != NANO_FORWARDS or len(hum.sampled) != len(inputs):
        fail(f'the nano round ran {steps} forwards over {len(hum.sampled)} nanobodies')
    seen = profile(torch, model, hum, inputs, phase='profile_nano')
    per_forward = {'K1': 2 * cfg.cs_layers,
                   'K2': K2_LAUNCHES * (cfg.n_encoder_layers + cfg.dual_layers)}
    expected = {k: v * steps for k, v in per_forward.items()}
    emit({'phase': 'launch_check_nano', 'launches': launches, 'expected': expected,
          'profiled_launches_per_forward': seen, 'expected_per_forward': per_forward})
    if launches != expected or any(seen[k] != per_forward.get(k, 0) for k in seen):
        fail(f'nano kernel launches {launches} do not match the profiled forwards {seen}')
    del model, hum
    out.update(round=launches, steps=steps, per_forward=seen)

    # training: the f32 step, pretrain.run at B = 512 and a profiled step
    train_step_f32(torch, cfg, dev, kind='heavy')
    pre = pretrain_phase(torch, dev, NANO_PRETRAIN_CONFIG, kind='heavy')
    blocks = cfg.n_encoder_layers + cfg.dual_layers
    out['per_step'] = profile_train(
        torch, pre['model'], dev, NANO_PRETRAIN_CONFIG, kind='heavy', expected={
            'K1': 2 * cfg.cs_layers, 'K2': K2_LAUNCHES * blocks,
            'K3': 3 * 2 * cfg.cs_layers, 'K4': K4_LAUNCHES * blocks,
            'K5': 0, 'K6': 0, 'K7': 0, 'K8': 0})
    out['pretrain'], out['ckpt'] = pre['launches'], pre['ckpt']
    del pre
    torch.cuda.empty_cache()
    return out


def _finetune_config(kind):
    """The kind's fine-tune config file, read as the CLI reads it."""
    from hudiff_tpu_torch.utils.config import load_yaml
    return load_yaml(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  FINETUNE_CONFIGS[kind]))


def _scorer_specs(kind):
    """(CLI flag, scorer name, straight_through) of each scorer of the kind:
    Nb VH and VHH without straight-through, Ab VH, VKappa and VLambda with."""
    if kind == 'heavy':
        return [('--abnativ-vh', 'VH', False), ('--abnativ-vhh', 'VHH', False)]
    return [('--abnativ-vh', 'VH', True), ('--abnativ-vlk', 'VKappa', True),
            ('--abnativ-vll', 'VLambda', True)]


def _released_scorer(torch, i, straight_through):
    """A frozen scorer at the released checkpoints' hparams
    (``AbNatiVParams()``) with random weights from seed SEED + 20 + i, on
    the CPU."""
    from hudiff_tpu_torch.models import abnativ as AB
    torch.manual_seed(SEED + 20 + i)
    return AB.frozen(AB.AbNatiVModel(AB.AbNatiVParams(), straight_through))


def _onehots(torch, B, seed):
    """[B, 149, 21] AHo one-hots, a quarter of the columns gaps."""
    import numpy as np
    from hudiff_tpu_torch import constants as C
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, 20, (B, C.AHO_LEN))
    idx[rs.rand(B, C.AHO_LEN) < 0.25] = C.ABNATIV_GAP_IDX
    return torch.nn.functional.one_hot(torch.from_numpy(idx), C.ABNATIV_ALPHABET_SIZE).float()


def abnativ_phase(torch, dev):
    """One ``AbNatiVParams()`` scorer (random weights from a seed) in f32 on
    the card against the same weights on the CPU at B = ABNATIV_B: the
    reconstruction, the errors and ``loss_pbe`` to ABNATIV_ATOL, the codebook
    indices equal (beside the CPU lookup's smallest top-2 cosine gap), and
    the gradient of (nativeness + loss_pbe) with respect to the inputs, with
    straight-through off and on, to ABNATIV_GRAD_RTOL of max |ref|. Also the
    card's f32 time of one forward, and of one with the backward to the
    inputs, at the Nb fine-tune's batch (512) and the Ab one's (32)."""
    import numpy as np
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.models import abnativ as AB
    cpu = _released_scorer(torch, 0, False)
    card = copy.deepcopy(cpu).to(dev)
    x = _onehots(torch, ABNATIV_B, SEED)
    portion = torch.from_numpy(np.random.RandomState(SEED + 1).rand(ABNATIV_B, C.AHO_LEN) < 0.4)
    keys = ('x_recon', 'recon_error_pres_pposi', 'recon_error_pposi', 'recon_error_pbe',
            'loss_pbe')
    rec = {'phase': 'abnativ_f32', 'B': ABNATIV_B, 'hparams': dataclasses.asdict(cpu.hp),
           'tol': ABNATIV_ATOL, 'grad_tol': ABNATIV_GRAD_RTOL}
    ok = True
    for st in (False, True):
        outs = []
        for model, d in ((cpu, 'cpu'), (card, dev)):
            model.vqvae.straight_through = st
            xi = x.to(d).detach().requires_grad_()
            out = model(xi)
            (AB.nativeness_scores(out, portion.to(d), 'VH').sum()
             + out['loss_pbe'].sum()).backward()
            outs.append(({k: out[k].detach().cpu() for k in (*keys, 'encoding_indices')},
                         xi.grad.cpu()))
        (ref, g_ref), (got, g_got) = outs
        errs = {k: (got[k] - ref[k]).abs().max().item() for k in keys}
        same = torch.equal(got['encoding_indices'], ref['encoding_indices'])
        grad_rel = ((g_got - g_ref).abs().max() / g_ref.abs().max()).item()
        tag = 'st' if st else 'no_st'
        rec.update({f'max_abs_err_{tag}': errs, f'indices_equal_{tag}': same,
                    f'input_grad_rel_err_{tag}': grad_rel})
        ok = (ok and same and max(errs.values()) <= ABNATIV_ATOL
              and grad_rel <= ABNATIV_GRAD_RTOL)
    with torch.no_grad():
        xp = cpu.vqvae.project_in(cpu.encoder(x))
        xn = xp / (torch.linalg.vector_norm(xp, dim=-1, keepdim=True) + 1e-12)
        e = cpu.vqvae._codebook.embed
        top = torch.einsum('bnd,cd->bnc', xn, e / (torch.linalg.vector_norm(
            e, dim=-1, keepdim=True) + 1e-12)).topk(2, -1).values
    rec['min_top2_cosine_gap_cpu'] = (top[..., 0] - top[..., 1]).min().item()
    card.vqvae.straight_through = False
    for B in (_finetune_config('heavy').finetune.batch_size,
              _finetune_config('pair').finetune.batch_size):
        xb = _onehots(torch, B, SEED + 2).to(dev)

        def fwd_bwd():
            xi = xb.clone().requires_grad_()
            card(xi)['recon_error_pposi'].sum().backward()

        with torch.no_grad():
            rec[f'forward_ms_B{B}'] = time_ms(torch, lambda: card(xb), reps=5, windows=3)
        rec[f'forward_backward_ms_B{B}'] = time_ms(torch, fwd_bwd, reps=5, windows=3)
    emit(rec)
    if not ok:
        fail('the f32 AbNatiV scorer on the card disagrees with the CPU')


def _finetune_batch(torch, kind, B, seed):
    """(tokens, chain_type or None, aho, fixed Corrupted, Gumbel uniforms) of
    a synthetic fine-tune batch: about half of the slots the step's
    corruption may mask are masked; the uniforms come from numpy."""
    import numpy as np
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.ops import masking as M
    from hudiff_tpu_torch.training import finetune as FT
    rs = np.random.RandomState(seed)
    if kind == 'heavy':
        b = next(FT.synthetic_nano_batches(B, seed))
        protected = (C.HEAVY_CDR_INDEX != 0)[None] | (b['tokens'] == C.IDX_PAD)
        protected[:, 150:] = True   # outside the camel window
    else:
        b = next(FT.synthetic_pair_batches(B, seed))
        protected = (np.concatenate([C.HEAVY_CDR_KABAT_NO_VERNIER,
                                     C.LIGHT_CDR_KABAT_NO_VERNIER]) != 0)[None] | (
            b['tokens'] == C.IDX_PAD)
    tokens = torch.from_numpy(b['tokens']).long()
    mask = torch.from_numpy((rs.rand(*tokens.shape) < 0.5) & ~protected)
    cor = M.Corrupted(torch.where(mask, C.IDX_MSK, tokens), mask, mask.sum(-1))
    u = torch.from_numpy(rs.rand(*tokens.shape, C.N_AA).astype(np.float32))
    chain = torch.from_numpy(b['chain_type']).long() if kind == 'pair' else None
    return tokens, chain, torch.from_numpy(b['aho']), cor, u


def _finetune_step(kind, model, scorers):
    """The kind's fine-tune step over ``model`` and ``scorers`` with the
    config's loss settings, called as ``step(state, tokens, chain_or_None,
    aho, seed, corrupted=None, u=None)``."""
    from hudiff_tpu_torch.models import finetune as FM
    from hudiff_tpu_torch.training import finetune as FT
    config = _finetune_config(kind)
    m = config.model
    if kind == 'heavy':
        cfg = FM.NanoFinetuneConfig(**{k: m[k] for k in (
            'loss_type', 'vhh_nativeness', 'temperature', 'human_threshold', 'human_all_seq',
            'vhh_all_seq', 'equal_weight')})
        step, _ = FT.make_nano_finetune_fns(
            FM.make_nano_finetune_loss(model, scorers[0], cfg, scorers[1]),
            m['part_reconstruct_vhh'],
            config.finetune.reconstruct_loss_weight)
        return lambda state, tokens, chain, aho, seed, **kw: step(state, tokens, aho, seed,
                                                                  **kw)
    cfg = FM.AbFinetuneConfig(loss_type=m['loss_type'], human_threshold=m['human_threshold'],
                              all_seq=m['all_seq'], mutation=m['mutation'])
    step, _ = FT.make_ab_finetune_fns(FM.make_ab_finetune_loss(model, *scorers, cfg),
                                      m['mouse_resi_h_ratio'], m['mouse_resi_l_ratio'])
    return step


def finetune_step_f32(torch, dev, kind):
    """One full-width f32 fine-tune step (B = FINETUNE_STEP_B; dropout off;
    TF32 off; scorers at ``AbNatiVParams()``; injected corruption and Gumbel
    uniforms) on the card against the CPU: the loss and every parameter's
    gradient at the pretrain step's limits, and the Gumbel hard choice at
    every position, which must be the same on both devices; with the
    launches the card's step made."""
    from hudiff_tpu_torch.models.denoiser import DenoiserConfig
    from hudiff_tpu_torch.ops import masking as M
    from hudiff_tpu_torch.ops import scheme_transfer as ST
    from hudiff_tpu_torch.training import train_step as T
    model_cls, _, blocks, _ = _kind_parts(kind)
    cfg = DenoiserConfig.from_dict((NANO_PRETRAIN_CONFIG if kind == 'heavy'
                                    else PRETRAIN_CONFIG)['model'])
    B = FINETUNE_STEP_B[kind]
    torch.manual_seed(SEED)
    cpu_model = model_cls(cfg).eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    cpu_scorers = [_released_scorer(torch, i, st)
                   for i, (_, _, st) in enumerate(_scorer_specs(kind))]
    gpu_scorers = [copy.deepcopy(s).to(dev) for s in cpu_scorers]
    tokens, chain, aho, cor, u = _finetune_batch(torch, kind, B, SEED + 4)
    hard, drawn = [], ST.gumbel_straight_through

    def recording(*a, **kw):
        out = drawn(*a, **kw)
        hard.append(out.detach().argmax(-1).cpu())
        return out

    def step(model, scorers, d):
        kept = {}

        class KeepGrads(torch.optim.Optimizer):
            def step(self, closure=None):
                kept.update((n, p.grad.detach().cpu().clone())
                            for n, p in model.named_parameters())

        state = T.TrainState(model, KeepGrads(model.parameters(), {}))
        reset_counters()
        m = _finetune_step(kind, model, scorers)(
            state, tokens.to(d), None if chain is None else chain.to(d), aho.to(d), SEED,
            corrupted=M.Corrupted(*(t.to(d) for t in cor)), u=u.to(d))
        return {k: v.item() for k, v in m.items()}, kept, counters()

    ST.gumbel_straight_through = recording   # keeps each step's hard choices
    try:
        m_c, g_c, _ = step(cpu_model, cpu_scorers, torch.device('cpu'))
        m_g, g_g, launched = step(gpu_model, gpu_scorers, dev)
    finally:
        ST.gumbel_straight_through = drawn
    differ = int((hard[0] != hard[1]).sum())
    rel = {n: ((g_g[n] - g_c[n]).abs().max() / g_c[n].abs().max().clamp_min(1e-30)).item()
           for n in g_c}
    order = sorted(rel, key=rel.get, reverse=True)
    glob = (sum(((g_g[n] - g_c[n]) ** 2).sum().item() for n in g_c)
            / sum((g_c[n] ** 2).sum().item() for n in g_c)) ** 0.5
    loss_rel = abs(m_g['loss'] - m_c['loss']) / abs(m_c['loss'])
    expected = {'K1': 2 * cfg.cs_layers, 'K3': 6 * cfg.cs_layers,
                'K2': K2_LAUNCHES * blocks(cfg), 'K4': K4_LAUNCHES * blocks(cfg),
                'K5': 0, 'K6': 0, 'K7': 0, 'K8': 0}
    emit({'phase': 'finetune_step_f32_' + ('nano' if kind == 'heavy' else 'ab'), 'B': B,
          'metrics_cpu': m_c,
          'metrics_card': m_g, 'loss_rel_err': loss_rel, 'max_grad_rel_err': rel[order[0]],
          'worst_five': {n: rel[n] for n in order[:5]}, 'global_grad_rel_err': glob,
          'positions': hard[0].numel(), 'hard_choices_differing': differ,
          'masked_positions': int(cor.mask.sum()), 'params': len(rel),
          'tol': TRAIN_STEP_RTOL, 'global_tol': TRAIN_STEP_GLOBAL_RTOL,
          'loss_tol': TRAIN_STEP_LOSS_RTOL, 'launches': launched,
          'expected_launches': expected})
    if not (sorted(g_c) == sorted(g_g) and loss_rel <= TRAIN_STEP_LOSS_RTOL
            and rel[order[0]] <= TRAIN_STEP_RTOL and glob <= TRAIN_STEP_GLOBAL_RTOL
            and differ == 0 and launched == expected):
        fail(f'full-width f32 {kind} fine-tune step on the card disagrees with the CPU')


def _humanized_ok(inp, grids, rows):
    """The invariants of a humanized round: ``rows`` candidates, CDRs and
    unmasked slots kept, no <msk> left, every token a residue or X."""
    import numpy as np
    from hudiff_tpu_torch import constants as C
    if grids is None or len(grids) != rows:
        return False
    cdr = (C.HEAVY_CDR_INDEX if grids.shape[1] == C.HEAVY_LEN
           else np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX])) != 0
    keep = inp['tokens'] != C.IDX_MSK
    return bool(not (grids == C.IDX_MSK).any() and not (grids < 0).any()
                and not (grids >= C.N_TOKENS - 1).any()
                and (grids[:, cdr] == inp['clean'][cdr]).all()
                and (grids[:, keep] == inp['tokens'][keep]).all())


def finetune_phase(torch, dev, kind, pretrain_ckpt):
    """The fine-tune CLI (``finetune nano|ab``) at the full width of its
    config (Nb B = 512 with cross-training, Ab B = 32), bf16, synthetic
    data, from the kind's pretraining checkpoint and scorer files written
    here in the reference layout at ``AbNatiVParams()``: finite losses, two
    validations, the Nb cross step at iteration 5, the launch counts, a
    best-val checkpoint (``finetuned``, the kind) that restores to the same
    logits both ways and changed every parameter of the pretrained model;
    then one humanization round with ``finetune=True`` by the humanizer
    that loads it. Returns the launches and the files."""
    import numpy as np
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.models.denoiser import DenoiserConfig
    from hudiff_tpu_torch.sampling import humanize as HZ
    from hudiff_tpu_torch.training import checkpoints as CKPT
    from hudiff_tpu_torch.training import finetune as FT
    _, _, blocks, _ = _kind_parts(kind)
    nano = kind == 'heavy'
    config = _finetune_config(kind)
    name = 'finetune_nano' if nano else 'finetune_ab'
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, 'build', name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    scorer_args, scorers = [], []
    for i, (flag, sname, st) in enumerate(_scorer_specs(kind)):
        path = FT.save_abnativ(os.path.join(root, f'{sname}.ckpt'),
                               _released_scorer(torch, i, st))
        scorer_args += [flag, path]
        scorers.append(path)
    argv = ['nano' if nano else 'ab', '--config', os.path.join(here, FINETUNE_CONFIGS[kind]),
            '--pretrain-ckpt', pretrain_ckpt,
            *scorer_args, '--synthetic', '--max-iter', str(FINETUNE_ITERS), '--valid-step',
            str(FINETUNE_VALID), '--logdir', os.path.join(root, 'logs')]
    if nano:
        argv.append('--cross-training')
    t0 = time.perf_counter()
    next((FT.synthetic_nano_batches if nano else FT.synthetic_pair_batches)(
        config['finetune']['batch_size'], SEED))
    synthetic_s = time.perf_counter() - t0   # the host's time to draw one batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    log_dir = FT.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counters()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(log_dir, 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if 'finetune/loss' in r]
    val = [r for r in rows if 'val/loss' in r]
    cross = [r['step'] for r in rows if 'cross/loss' in r]
    mcfg = DenoiserConfig.from_dict((NANO_PRETRAIN_CONFIG if nano
                                     else PRETRAIN_CONFIG)['model'])
    # every iteration and cross step trains; each validation runs the eval
    # forward on its batches (Nb: the VHH split and the heavy split)
    steps = FINETUNE_ITERS + len(cross)
    forwards = (FINETUNE_ITERS // FINETUNE_VALID) * FINETUNE_VAL_BATCHES * (2 if nano else 1)
    expected = {'K1': (steps + forwards) * 2 * mcfg.cs_layers,
                'K2': (steps + forwards) * K2_LAUNCHES * blocks(mcfg),
                'K3': steps * 6 * mcfg.cs_layers, 'K4': steps * K4_LAUNCHES * blocks(mcfg),
                'K5': 0, 'K6': 0, 'K7': 0, 'K8': 0}
    # host time at the end of iteration i is i / steps_per_sec(i); iteration
    # 2 is warm and runs neither a validation nor a cross step
    ends = [r['step'] / r['finetune/steps_per_sec'] for r in train]
    warm_sps = 1.0 / (ends[1] - ends[0]) if len(ends) >= 2 else 'not measured'
    ckpt_dir = os.path.join(log_dir, 'checkpoints')
    restored = CKPT.restore(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{restored['step']}.pt")
    best_step = min(val, key=lambda r: r['val/loss'])['step'] if val else None
    tokens, chain, _, _, _ = _finetune_batch(torch, kind, 2, SEED + 5)
    region = torch.from_numpy(np.tile(C.HEAVY_REGION_INDEX if nano else np.concatenate(
        [C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]), (2, 1))).long()
    args = [t.to(dev) for t in (tokens, region, chain) if t is not None]
    again = CKPT.model_class(restored['kind'])(mcfg, dtype=torch.bfloat16, device=dev)
    again.load_state_dict(restored['payload']['model'])
    loaded, lcfg = CKPT.load(path, dtype=torch.bfloat16)
    with torch.inference_mode():
        diff = (again.eval()(*args) - loaded(*args)).abs().max().item()
    before = torch.load(pretrain_ckpt, map_location='cpu', weights_only=True)['model']
    changed = sum(not torch.equal(before[k], v)
                  for k, v in restored['payload']['model'].items() if v.is_floating_point())
    n_float = sum(v.is_floating_point() for v in before.values())
    del again, loaded

    # one humanization round with the fine-tune mask, from the checkpoint
    model, finetuned = HZ.load_denoiser(path, kind)
    if nano:
        class Humanizer(_KeptRows, HZ.NanoHumanizer):
            sampled = []
    else:
        Humanizer = HZ.PairHumanizer
    hum = Humanizer(model, batch_size=MAIN_B // 2, seed=SEED, device='cuda',
                    device_batch=MAIN_B)
    inputs = ([HZ.nano_input(v, finetune=True) for v in (VHH1, VHH2)] if nano else
              [HZ.pair_input(H1, L1, finetune=True), HZ.pair_input(H2, L2, finetune=True)])
    if any(inp is None for inp in inputs):
        fail(f'a test sequence was rejected as a {kind} fine-tune input')
    t0 = time.perf_counter()
    res = hum.humanize_many(inputs, rows_per_input=MAIN_B // 2)
    torch.cuda.synchronize()
    hum_s = time.perf_counter() - t0
    sampled = hum.sampled if nano else [(inp, r and r['grids']) for inp, r in zip(inputs, res)]
    humanized_ok = len(sampled) == len(inputs) and all(
        _humanized_ok(inp, g, MAIN_B // 2) for inp, g in sampled)
    rec = {'phase': name, 'B': config['finetune']['batch_size'],
           'iterations': len(train), 'steps': steps, 'wall_s': wall,
           'finetune_loss': [r['finetune/loss'] for r in train],
           'val_steps': [r['step'] for r in val], 'val_loss': [r['val/loss'] for r in val],
           'cross_steps': cross, 'saved_step': restored['step'], 'best_val_step': best_step,
           'checkpoint_config': {k: lcfg.get(k) for k in ('finetuned', 'kind')},
           'restore_max_abs_logit_diff': diff, 'params_changed': changed,
           'params': n_float, 'steps_per_sec': train[-1]['finetune/steps_per_sec'],
           'steps_per_sec_warm': warm_sps, 'ms_per_step_warm': (
               1e3 / warm_sps if isinstance(warm_sps, float) else 'not measured'),
           'max_memory_allocated_gb': peak / 1e9, 'synthetic_batch_s': synthetic_s,
           'launches': launched, 'expected_launches': expected,
           'tf32': 'off (matmul and cuDNN)', 'humanize': {'finetuned_checkpoint': finetuned, 'rows': MAIN_B,
                        'forwards': HZ._packed_pad_to(inputs), 'wall_s': hum_s,
                        'invariants_hold': humanized_ok}}
    emit(rec)
    ok = (len(train) == FINETUNE_ITERS and all(np.isfinite(rec['finetune_loss']))
          and rec['val_steps'] == list(range(FINETUNE_VALID, FINETUNE_ITERS + 1,
                                             FINETUNE_VALID))
          and np.isfinite(rec['val_loss']).all() and cross == ([5] if nano else [])
          and restored['step'] == best_step and restored['kind'] == kind
          and lcfg.get('finetuned') is True and restored['meta']['config']['finetuned'] is True
          and diff == 0.0 and changed == n_float and launched == expected
          and finetuned is True and humanized_ok)
    if not ok:
        fail(f'the {kind} fine-tune CLI failed its checks')
    del model, hum
    torch.cuda.empty_cache()
    return {'launches': launched, 'ckpt': path, 'scorers': scorers}


def profile_finetune(torch, dev, kind, ckpt, scorer_paths):
    """One warm bf16 fine-tune step at the config's batch (Nb 512, Ab 32)
    from the fine-tuned checkpoint and the scorer files, profiled after a
    warm-up run (``profiled``): wall ms over warm steps, device ms by group,
    the idle share and the peak memory. AbNatiV's device time is the
    profiled time of the step's scorer work alone (the same forwards, and
    the backwards to the inputs, on inputs of the step's shapes); it is
    taken out of the cuBLAS and other-torch groups and given as its own.
    The launch counters must equal the K1-K4 kernels the profiler saw:
    10 / 36 / 30 / 60 (Nb) and 10 / 72 / 30 / 120 (Ab) a step."""
    import numpy as np
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.models import abnativ as AB
    from hudiff_tpu_torch.sampling import humanize as HZ
    from hudiff_tpu_torch.training import finetune as FT
    from hudiff_tpu_torch.training import schedules
    from hudiff_tpu_torch.training import train_step as T
    _, _, blocks, _ = _kind_parts(kind)
    nano = kind == 'heavy'
    cfg = _finetune_config(kind)
    B = cfg.finetune.batch_size
    model, _ = HZ.load_denoiser(ckpt, kind)
    scorers = [FT.load_abnativ(p, st)
               for p, (_, _, st) in zip(scorer_paths, _scorer_specs(kind))]
    step = _finetune_step(kind, model, scorers)
    state = T.TrainState(model, schedules.make_optimizer(cfg.finetune.optimizer,
                                                         model.parameters()),
                         clip_norm=cfg.finetune.get('clip_norm'))
    b = next((FT.synthetic_nano_batches if nano else FT.synthetic_pair_batches)(B, SEED))
    tokens = torch.as_tensor(b['tokens'], dtype=torch.long, device=dev)
    chain = None if nano else torch.as_tensor(b['chain_type'], dtype=torch.long, device=dev)
    aho = torch.as_tensor(b['aho'], device=dev)
    model.train()
    step(state, tokens, chain, aho, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, tokens, chain, aho, SEED)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated()
    # the host's time to issue one step, without waiting for the device
    t0 = time.perf_counter()
    step(state, tokens, chain, aho, SEED)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()

    def window():
        reset_counters()
        step(state, tokens, chain, aho, SEED)
        torch.cuda.synchronize()

    counted, (groups, seen, top), first = profiled(torch, window, 1)

    # the step's scorer work alone: Nb VH and VHH on the infilled grid (with
    # the backward to it) and VHH on the original; Ab VH on the heavy half,
    # VKappa and VLambda on the light half, each with the backward
    x = torch.cat([_onehots(torch, B, SEED + 6 + i) for i in range(1 if nano else 2)],
                  1).to(dev)
    portion = torch.from_numpy(np.random.RandomState(SEED).rand(B, C.AHO_LEN) < 0.4).to(dev)

    def scorer_work():
        reset_counters()
        xi = x.clone().requires_grad_()
        if nano:
            total = (AB.nativeness_scores(scorers[0](xi), portion, 'VH').sum()
                     + AB.nativeness_scores(scorers[1](xi), portion, 'VHH').sum())
            AB.nativeness_scores(scorers[1](aho), portion, 'VHH')
        else:
            h, l = xi[:, : C.AHO_LEN], xi[:, C.AHO_LEN:]
            total = sum(AB.nativeness_scores(s(part), portion, t).sum() for s, part, t in (
                (scorers[0], h, 'VH'), (scorers[1], l, 'VKappa'), (scorers[2], l, 'VLambda')))
        total.backward()
        torch.cuda.synchronize()

    scorer_groups = profiled(torch, scorer_work, 1)[1][0]
    abnativ = sum(scorer_groups.values())
    by_group = dict(groups, abnativ=abnativ)
    for g in ('cublas', 'other'):
        by_group[g] = groups[g] - scorer_groups[g]
    busy = sum(groups.values())
    expected = {'K1': 2 * model.cfg.cs_layers, 'K2': K2_LAUNCHES * blocks(model.cfg),
                'K3': 6 * model.cfg.cs_layers, 'K4': K4_LAUNCHES * blocks(model.cfg),
                'K5': 0, 'K6': 0, 'K7': 0, 'K8': 0}
    emit({'phase': 'profile_finetune_' + ('nano' if nano else 'ab'), 'B': B,
          'wall_ms_per_step': wall_ms, 'host_issue_ms_per_step': host_ms,
          'steps_per_sec': 1e3 / wall_ms, 'device_busy_ms_per_step': busy,
          'device_idle_share': (1 - busy / wall_ms) if busy else 'not measured',
          'max_memory_allocated_gb': peak / 1e9,
          'kernels_per_step': sum(t['calls'] for t in top),
          'device_ms_per_step_by_group': by_group,
          'abnativ_share': abnativ / busy if busy else 'not measured',
          'abnativ_by_group': scorer_groups, 'top': top[:15], 'counted_launches': counted,
          'profiled_launches': seen, 'expected_launches': expected, 'profiler': first,
          'tf32': 'off (matmul and cuDNN)'})
    if counted != seen or seen != expected:
        fail(f'fine-tune launch counters {counted} != kernels the profiler saw {seen} '
             f'or != {expected}')
    del model, state, scorers
    torch.cuda.empty_cache()
    return seen


def finetune_phases(torch, dev, ab_ckpt, nano_ckpt):
    """The fine-tune slice: AbNatiV in f32 card against CPU, the f32
    fine-tune steps card against CPU (Nb, Ab), the CLI runs (Nb at B = 512,
    Ab at B = 32) and a profile of one warm step of each. Returns the
    kernels line's fine-tune keys for K1-K4."""
    abnativ_phase(torch, dev)
    finetune_step_f32(torch, dev, 'heavy')
    finetune_step_f32(torch, dev, 'pair')
    out = {k: {} for k in ('K1', 'K2', 'K3', 'K4')}
    for kind, ckpt, tag in (('heavy', nano_ckpt, 'finetune_nano'),
                            ('pair', ab_ckpt, 'finetune_ab')):
        run = finetune_phase(torch, dev, kind, ckpt)
        per_step = profile_finetune(torch, dev, kind, run['ckpt'], run['scorers'])
        for k in out:
            out[k].update({f'{tag}_launches': run['launches'][k],
                           f'{tag}_launches_per_step': per_step[k]})
    return out


# -- the humanization service and the sampling variants (the ninth slice) ----

# the germline warm-up: the pretraining checkpoints (random weights after a
# few steps on random tokens) are trained this many steps further, at this
# batch and rate, on grids of the embedded human germline library, so that
# sampled frameworks look human and realign; a stand-in for OAS pretraining
GERMLINE_STEPS, GERMLINE_B, GERMLINE_LR = 300, 128, 1e-3
SAMPLER_ROWS = 16       # rows per antibody in the k = 2 and inpaint rounds
SAMPLER_BATCH = 32      # their device batch: two antibodies in one round
SERVE_BATCH, SERVE_DEVICE_BATCH, SERVE_WINDOW_MS = 16, 64, 50.0
KERNELS_PER_FORWARD = {'pair': {'K1': 10, 'K2': 72}, 'heavy': {'K1': 10, 'K2': 36}}
CDR_KEYS = ('cdr1', 'cdr2', 'cdr3')


def service_shapes_phase(torch, dev):
    """K1 and K2 against their plain versions at the batches this slice's
    path gives them and no earlier phase checks, f32 and bf16 at the K1/K2
    limits, timed as the earlier phases time them: B = 1 (the sequential
    reference) and SAMPLER_BATCH (``sampler_k2``, ``inpaint_ab``) at the Ab
    shapes (K1 at L = 291; K2 at both towers, L = 152 and 139, which holds
    the Nb model's 256/128 tower), B = 1 and SERVE_DEVICE_BATCH (the
    service's rounds) at the Nb shapes (K1 at L = 152; K2 at nano_conv
    512/256 GELU). Inputs and block weights from a seed of their own."""
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.models.denoiser import DenoiserConfig
    from hudiff_tpu_torch.ops.rope import rope_tables
    gen = torch.Generator(device='cpu').manual_seed(SEED + 13)
    torch.manual_seed(SEED + 13)   # the blocks' initial weights
    heads, hd = 8, 64
    for L, batches, phase in ((C.PAIR_LEN, (1, SAMPLER_BATCH), 'K1_service'),
                              (C.HEAVY_LEN, (1, SERVE_DEVICE_BATCH), 'K1_nano_service')):
        cos, sin = rope_tables(hd, L, device=dev)
        for B in batches:
            for dtype in (torch.float32, torch.bfloat16):
                qkv = torch.randn(B, L, heads * 3 * hd, generator=gen).to(dev, dtype)
                k1_record(torch, qkv, cos, sin, heads, phase)
                del qkv
    ab, nb = DenoiserConfig(), DenoiserConfig.from_dict(NANO_PRETRAIN_CONFIG['model'])
    k2_phase(torch, gen, dev, [(ab.d_model, ab.activation, ab.n_encoder_layers),
                               (ab.sum_d_model, 'relu', ab.dual_layers)],
             (1, SAMPLER_BATCH), (C.HEAVY_LEN, C.LIGHT_LEN), ab.aa_kernel_size, ab.r,
             'K2_service')
    k2_phase(torch, gen, dev, [(nb.sum_d_model, 'gelu', nb.dual_layers)],
             (1, SERVE_DEVICE_BATCH), (C.HEAVY_LEN,), nb.aa_kernel_size, nb.r,
             'K2_nano_service')
    torch.cuda.empty_cache()


def _germline_library():
    """The germline library as token grids by group (H, K, L): each V gene
    gridded in full-chain context (as grafting grids it) and the J genes'
    FR4 tokens."""
    import numpy as np
    from hudiff_tpu_torch.numbering import germline as G
    from hudiff_tpu_torch.sampling import humanize as HZ
    out = {}
    for group, js in (('H', G.GERMLINE_J_HEAVY), ('K', G.GERMLINE_J_KAPPA),
                      ('L', G.GERMLINE_J_LAMBDA)):
        grids = np.stack([HZ._TOK.seq2idx(''.join(g))
                          for g in G._gridded_library(group).values()])
        out[group] = (grids, np.stack([HZ._TOK.seq2idx(j) for j in js.values()]))
    return out


def _germline_batch(lib, kind, B, rs):
    """B clean grids of germline chains, each with a J drawn apart from its
    V; for the pair kind a heavy chain beside a kappa or lambda one, and
    the chain types."""
    import numpy as np
    from hudiff_tpu_torch import constants as C

    def chains(group, n):
        grids, js = lib[group]
        out = grids[rs.randint(len(grids), size=n)].copy()
        out[:, -js.shape[1]:] = js[rs.randint(len(js), size=n)]
        return out

    heavy = chains('H', B)
    if kind == 'heavy':
        return heavy, None
    light = np.empty((B, C.LIGHT_LEN), heavy.dtype)
    groups = rs.choice(['K', 'L'], B)
    for g in 'KL':
        light[groups == g] = chains(g, int((groups == g).sum()))
    chain = np.stack([np.zeros(B, np.int64), [C.CHAIN_TYPES[g] for g in groups]], axis=1)
    return np.concatenate([heavy, light], axis=1), chain


def germline_tune(torch, dev, kind, ckpt, lib):
    """The kind's pretraining checkpoint, trained GERMLINE_STEPS steps at
    GERMLINE_B on germline grids (the kind's pretrain step, Adam at
    GERMLINE_LR, bf16, clip 10) and saved beside it; returns its path."""
    import numpy as np
    from hudiff_tpu_torch.models.denoiser import DenoiserConfig
    from hudiff_tpu_torch.training import checkpoints as CKPT
    from hudiff_tpu_torch.training import train_step as T
    model, config = CKPT.load(ckpt, dtype=torch.bfloat16, device=dev)
    state = T.TrainState(model.train(), torch.optim.Adam(model.parameters(), lr=GERMLINE_LR),
                         clip_norm=10)
    pair = kind == 'pair'
    step = T.make_pair_train_step(model) if pair else T.make_heavy_train_step(model)
    rs = np.random.RandomState(SEED + 11)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(GERMLINE_STEPS):
        tokens, chain = _germline_batch(lib, kind, GERMLINE_B, rs)
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        m = (step(state, tokens, torch.as_tensor(chain, device=dev), SEED) if pair
             else step(state, tokens, SEED))
        if i % 50 == 0 or i == GERMLINE_STEPS - 1:
            losses.append(m['loss'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    path = os.path.join(os.path.dirname(ckpt), f'germline_{kind}.pt')
    CKPT.save(path, model.eval(), DenoiserConfig.from_dict(config['model']))
    emit({'phase': f'germline_tune_{kind}', 'from': os.path.basename(ckpt),
          'steps': GERMLINE_STEPS, 'B': GERMLINE_B, 'lr': GERMLINE_LR, 'wall_s': wall,
          'ms_per_step': wall / GERMLINE_STEPS * 1e3, 'loss_every_50_steps': losses})
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f'the germline warm-up of the {kind} model did not lower its loss: {losses}')
    del model, state
    torch.cuda.empty_cache()
    return path


def _region_cdrs(h_seq, l_seq=None, light_group='K'):
    """The CDR strings of a chain (or pair) by ``regions.region_sequences``,
    realigned from its sequence; None where a chain does not align."""
    from hudiff_tpu_torch.numbering import regions as R
    parts = [R.region_sequences(h_seq, True, 'H' if l_seq else 'VHH')]
    if l_seq is not None:
        parts.append(R.region_sequences(l_seq, False, light_group))
    if any(p is None for p in parts):
        return None
    return [p[k] for p in parts for k in CDR_KEYS]


def _round(torch, hum, inputs, rows):
    """``humanize_many`` over ``inputs`` at ``rows`` a input: (results, wall
    s, K1/K2 launches), the counters set to 0 just before."""
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = hum.humanize_many(inputs, rows_per_input=rows)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, {'K1': FA.launches, 'K2': FB.launches}


def sampler_k2_phase(torch, dev, ab_ckpt):
    """Phase 5's Ab round (two test antibodies, SAMPLER_ROWS rows each, one
    round of SAMPLER_BATCH) with k = 1 and k = 2 positions per forward on
    one bf16 model: one untimed k = 1 round first (the first at this batch),
    then timed rounds in the order k = 2, 1, 2. Each timed round is held to
    its launch counts and the rows' invariants, and reads the CDRs of each
    row as ``regions`` realigns them (a reading of the warm-up)."""
    from hudiff_tpu_torch.sampling import humanize as HZ
    model, _ = HZ.load_denoiser(ab_ckpt, 'pair', device='cuda')
    pairs = ((H1, L1), (H2, L2))
    inputs = [HZ.pair_input(*p) for p in pairs]
    pad_to = HZ._packed_pad_to(inputs)
    rec = {'phase': 'sampler_k2', 'rows': 2 * SAMPLER_ROWS, 'B': SAMPLER_BATCH,
           'pad_to': pad_to, 'order': 'untimed k1, then k2, k1, k2'}

    def humanizer(k):
        return HZ.PairHumanizer(model, batch_size=SAMPLER_ROWS, seed=SEED, device='cuda',
                                device_batch=SAMPLER_BATCH, positions_per_step=k)

    _round(torch, humanizer(1), inputs, SAMPLER_ROWS)
    for i, k in enumerate((2, 1, 2)):
        res, wall, launched = _round(torch, humanizer(k), inputs, SAMPLER_ROWS)
        forwards = -(-pad_to // k)
        expected = {n: v * forwards for n, v in KERNELS_PER_FORWARD['pair'].items()}
        kept = [sum(_region_cdrs(h, l, inp['l_group']) == _region_cdrs(*p, inp['l_group'])
                    for h, l in zip(r['h_seqs'], r['l_seqs']))
                for p, inp, r in zip(pairs, inputs, res)]
        rec.setdefault(f'k{k}', []).append(
            {'forwards': forwards, 'wall_s': wall, 'rows_per_s': 2 * SAMPLER_ROWS / wall,
             'ms_per_forward': wall / forwards * 1e3, 'launches': launched,
             'expected_launches': expected,
             'rows_whose_realigned_cdrs_are_the_parents': kept})
        if launched != expected or not all(
                _humanized_ok(inp, r['grids'], SAMPLER_ROWS) for inp, r in zip(inputs, res)):
            emit(rec)
            fail(f'the k = {k} Ab round (timed round {i + 1}) failed its launch or row checks')
    rec['speedup_k2'] = (rec['k1'][0]['wall_s']
                         / statistics.mean(r['wall_s'] for r in rec['k2']))
    emit(rec)
    return model


def inpaint_ab_phase(torch, model):
    """``pair_inpaint_input`` on the two test antibodies, then one
    ``humanize_many`` round: CDRs and every slot frozen by germline identity
    kept, ``positions`` the framework slots that are not frozen."""
    import numpy as np
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.numbering import germline as G
    from hudiff_tpu_torch.sampling import humanize as HZ
    t0 = time.perf_counter()
    inputs = [HZ.pair_inpaint_input(H1, L1), HZ.pair_inpaint_input(H2, L2)]
    prep_s = time.perf_counter() - t0
    fr = np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX]) == 0
    for inp in inputs:
        grids = [np.asarray(list(inp['h_grid'])), np.asarray(list(inp['l_grid']))]
        identity = np.concatenate([
            (g == G.graft_cdrs(g, group)['grid']) & (g != '-')
            for g, group in zip(grids, ('H', inp['l_group']))])
        if not (np.array_equal(inp['positions'], np.nonzero(fr & ~identity)[0])
                and (inp['tokens'][inp['positions']] == C.IDX_MSK).all()):
            fail('pair_inpaint_input: positions are not the framework slots off the germline')
    hum = HZ.PairHumanizer(model, batch_size=SAMPLER_ROWS, seed=SEED, device='cuda',
                           device_batch=SAMPLER_BATCH)
    pad_to = HZ._packed_pad_to(inputs)
    res, wall, launched = _round(torch, hum, inputs, SAMPLER_ROWS)
    expected = {n: v * pad_to for n, v in KERNELS_PER_FORWARD['pair'].items()}
    rec = {'phase': 'inpaint_ab', 'rows': 2 * SAMPLER_ROWS, 'B': SAMPLER_BATCH,
           'positions': [len(inp['positions']) for inp in inputs],
           'frozen_framework_slots': [int(fr.sum()) - len(inp['positions']) for inp in inputs],
           'pad_to': pad_to, 'forwards': pad_to, 'pair_inpaint_input_s': prep_s,
           'wall_s': wall, 'rows_per_s': 2 * SAMPLER_ROWS / wall,
           'ms_per_forward': wall / pad_to * 1e3, 'launches': launched,
           'expected_launches': expected}
    emit(rec)
    if launched != expected or not all(
            _humanized_ok(inp, r['grids'], SAMPLER_ROWS) for inp, r in zip(inputs, res)):
        fail('the inpaint round failed its launch, CDR or frozen-slot checks')


def sequential_reference_phase(torch, dev, kind, ckpt, inp):
    """``sequential_reference_sampler`` at B = 1 over every FR position of
    ``inp``: one forward per position, the tokens read back after each."""
    import numpy as np
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    from hudiff_tpu_torch.sampling import humanize as HZ
    from hudiff_tpu_torch.sampling import sampler as S
    model, _ = HZ.load_denoiser(ckpt, kind, device='cuda')
    run = S.sequential_reference_sampler(model)
    keys = ('region', 'chain') if kind == 'pair' else ('region',)
    put = lambda a: torch.as_tensor(np.asarray(a)[None], dtype=torch.long, device=dev)  # noqa: E731
    order = put(S.build_order(inp['positions'], 1, rng=SEED)[0])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    run(put(inp['tokens']), order[:, :2], gen, *(put(inp[k]) for k in keys))   # warm
    n = len(inp['positions'])
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(put(inp['tokens']), order, gen, *(put(inp[k]) for k in keys))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {'K1': FA.launches, 'K2': FB.launches}
    expected = {k: v * n for k, v in KERNELS_PER_FORWARD[kind].items()}
    suffix = '' if kind == 'pair' else '_nano'
    emit({'phase': 'sequential_reference' + suffix, 'B': 1, 'L': len(inp['tokens']),
          'forwards': n, 'wall_s': wall, 'ms_per_forward': wall / n * 1e3,
          'rows_per_s': 1 / wall, 'launches': launched, 'expected_launches': expected})
    if launched != expected or not _humanized_ok(inp, out.cpu().numpy(), 1):
        fail(f'the sequential reference ({kind}) failed its launch or row checks')


def _timed(fn, log):
    """``fn`` recording (name, seconds) of each outermost call per thread:
    ``pair_inpaint_input`` calls ``pair_input`` within it."""
    import threading
    depth = threading.local()

    def wrapper(*a, **kw):
        outer = not getattr(depth, 'n', 0)
        depth.n = getattr(depth, 'n', 0) + 1
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            depth.n -= 1
            if outer:
                log.append((fn.__name__, time.perf_counter() - t0))
    return wrapper


SERVE_REQUESTS = (
    [('/humanize/ab', {'h_seq': h, 'l_seq': l, 'sample_number': 1})
     for h, l in ((H1, L1), (H2, L2)) * 3]
    + [('/humanize/ab', {'h_seq': h, 'l_seq': l, 'method': 'inpaint'})
       for h, l in ((H1, L1), (H2, L2))]
    + [('/humanize/nano', {'vhh_seq': v, 'sample_number': 2}) for v in (VHH1, VHH2) * 2]
    + [('/graft', {'h_seq': h, 'l_seq': l, 'back_mutation': b})
       for (h, l), b in (((H1, L1), False), ((H2, L2), True))])
# one request alone per model, a full round each (``rows`` = the device
# batch): the rounds of a service with no other request in flight
QUIET_REQUESTS = (
    ('/humanize/ab', {'h_seq': H1, 'l_seq': L1, 'rows': SERVE_DEVICE_BATCH}),
    ('/humanize/nano', {'vhh_seq': VHH1, 'rows': SERVE_DEVICE_BATCH}))
ROUND_MARK_CYCLES = 1000   # torch.cuda._sleep around each profiled round


def _serve_burst(torch, SV, svc, prep, requests=SERVE_REQUESTS):
    """``requests`` against ``svc`` behind ``serve(port=0)`` in a thread,
    released together from a barrier, then /health and /metrics: (K1/K2
    launches, wall s, replies as (status, body, client s), /health,
    /metrics). The counters and the host-prep log ``prep`` are set to 0
    just before the release; the server is shut down after."""
    import threading
    import urllib.error
    import urllib.request
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    srv = SV.serve(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{srv.server_address[1]}'
    replies = [None] * len(requests)
    ready = threading.Barrier(len(requests) + 1)

    def call(i):
        path, body = requests[i]
        req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                     {'Content-Type': 'application/json'})
        ready.wait(60)
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                replies[i] = (r.status, json.loads(r.read()), time.perf_counter() - t)
        except urllib.error.HTTPError as e:
            replies[i] = (e.code, json.loads(e.read()), time.perf_counter() - t)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    reset_counters()
    prep.clear()
    ready.wait(60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(900)
    torch.cuda.synchronize()
    burst_s = time.perf_counter() - t0
    launched = {'K1': FA.launches, 'K2': FB.launches}
    with urllib.request.urlopen(url + '/health', timeout=60) as r:
        health = json.loads(r.read())
    with urllib.request.urlopen(url + '/metrics', timeout=60) as r:
        metrics = json.loads(r.read())
    srv.shutdown()
    srv.server_close()
    return launched, burst_s, replies, health, metrics


def _serve_errors(replies, requests=SERVE_REQUESTS):
    """What is wrong with the replies to ``requests``: a status other than 200, a
    candidate count other than sample_number, CDRs (realigned by
    ``regions``) other than the parent's, a graft other than
    ``cdr_pair_grafting``'s."""
    from hudiff_tpu_torch.numbering import germline as G
    from hudiff_tpu_torch.sampling import humanize as HZ
    errors = []
    for (path, body), reply in zip(requests, replies):
        if reply is None or reply[0] != 200:
            errors.append(f'{path}: {reply and reply[:2]}')
            continue
        out = reply[1]
        if path == '/graft':
            if (out['h_seq'], out['l_seq']) != G.cdr_pair_grafting(
                    body['h_seq'], body['l_seq'], back_mutation=body['back_mutation']):
                errors.append(f'{path}: differs from cdr_pair_grafting')
            continue
        want = body.get('sample_number', 1)
        if len(out['candidates']) != want:
            errors.append(f'{path}: {len(out["candidates"])} candidates, not {want}')
        for c in out['candidates']:
            if path == '/humanize/ab':
                group = HZ.pair_input(body['h_seq'], body['l_seq'])['l_group']
                got = _region_cdrs(c['h_seq'], c['l_seq'], group)
                parent = _region_cdrs(body['h_seq'], body['l_seq'], group)
            else:
                got, parent = _region_cdrs(c['vhh_seq']), _region_cdrs(body['vhh_seq'])
            if got != parent:
                errors.append(f'{path} {body.get("method", "FR")}: CDRs {got} != {parent}')
    return errors


def _marked_rounds(torch, events):
    """From the device events of a profiled window whose rounds are each
    framed by two ``torch.cuda._sleep`` kernels: per round, in order, the
    device span between the marks (ms) and the time the device was busy
    in it (ms, the union of its kernels and copies)."""
    on_device = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                        and not getattr(e, 'is_user_annotation', False)),
                       key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(on_device) if 'spin_kernel' in e.name]
    out = []
    for a, b in zip(marks[0::2], marks[1::2]):
        t0, t1 = on_device[a].time_range.end, on_device[b].time_range.start
        busy, end = 0, t0
        for e in on_device[a + 1:b]:
            start, stop = max(e.time_range.start, end), min(e.time_range.end, t1)
            if stop > start:
                busy += stop - start
                end = stop
        out.append(((t1 - t0) / 1e3, busy / 1e3))
    return out


def serve_phase(torch, ab_ckpt, nano_ckpt):
    """``HumanizationService`` on both models (warm-up included), then the
    burst (``_serve_burst``). Fails unless every reply passes
    ``_serve_errors``, the Ab rounds stay within ceil(rows / device batch)
    + 1, /health names both models and the card, and the K1/K2 counters
    equal the kernels of the forwards the burst's rounds ran: each round
    runs ceil(pad_to / k) forwards at the pad_to it was given. Prints the
    endpoints' p50/p95, rows and rounds per model, the burst's wall and
    rows/s, the warm-up's time, each round's ms per forward (warm-up and
    burst) and the host time of the input functions as the handler threads
    spend it. Then the same burst again and one QUIET_REQUESTS request per
    model alone, under torch.profiler (device activity only), each round
    framed by two marker kernels: each round's device ms, ms per forward
    and idle share (1 - busy / the span between its marks); the replies
    are held to the same checks. Returns the first burst's K1/K2
    launches."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from hudiff_tpu_torch import serving as SV
    from hudiff_tpu_torch.sampling import humanize as HZ
    prep = []
    originals = {n: getattr(HZ, n) for n in ('pair_input', 'pair_inpaint_input', 'nano_input')}
    for n, fn in originals.items():
        setattr(HZ, n, _timed(fn, prep))
    # every round as run, by (stage, model): (rows, batch, pad_to, seconds),
    # each ending in the grids' copy to the host; in the profiled stages
    # also in run order, each framed by marker kernels (under the device
    # lock, as the rounds are)
    stage, log, marked = ['warmup'], {}, []
    for cls, name in ((HZ.PairHumanizer, 'ab'), (HZ.NanoHumanizer, 'nano')):
        def recording(self, rows, pad_to, batch=None, _f=cls.sample_rows, _name=name):
            mark = stage[0] in ('profiled_burst', 'quiet')
            if mark:
                torch.cuda._sleep(ROUND_MARK_CYCLES)
            t = time.perf_counter()
            out = _f(self, rows, pad_to, batch=batch)
            r = (len(rows), batch, pad_to, time.perf_counter() - t)
            if mark:
                torch.cuda._sleep(ROUND_MARK_CYCLES)
                marked.append((stage[0], _name, r))
            log.setdefault((stage[0], _name), []).append(r)
            return out
        cls.sample_rows = recording
    try:
        t0 = time.perf_counter()
        svc = SV.HumanizationService(ab_ckpt, nano_ckpt, device='cuda', batch_size=SERVE_BATCH,
                                     device_batch=SERVE_DEVICE_BATCH,
                                     window_ms=SERVE_WINDOW_MS, warmup=True)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        stage[0] = 'burst'
        launched, burst_s, replies, health, metrics = _serve_burst(torch, SV, svc, prep)
        burst_prep = list(prep)
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            # the profiler can drop the records of the first kernels it sees
            for _ in range(20):
                torch.ones(8, device=svc.device).add_(1)
            torch.cuda.synchronize()
            time.sleep(0.05)
            stage[0] = 'profiled_burst'
            _, profiled_s, profiled_replies, _, _ = _serve_burst(torch, SV, svc, prep)
            stage[0] = 'quiet'
            quiet_replies = [_serve_burst(torch, SV, svc, prep, (req,))[2][0]
                             for req in QUIET_REQUESTS]
            torch.cuda.synchronize()
        spans = _marked_rounds(torch, prof.events())
    finally:
        del HZ.PairHumanizer.sample_rows, HZ.NanoHumanizer.sample_rows
        for n, fn in originals.items():
            setattr(HZ, n, fn)
    errors = (_serve_errors(replies) + _serve_errors(profiled_replies)
              + _serve_errors(quiet_replies, QUIET_REQUESTS))
    k = svc.ab.positions_per_step
    rounds = {m: log.get(('burst', m), []) for m in ('ab', 'nano')}
    forwards = {m: sum(-(-r[2] // k) for r in rs) for m, rs in rounds.items()}
    expected = {n: sum(KERNELS_PER_FORWARD[kind][n] * forwards[m]
                       for m, kind in (('ab', 'pair'), ('nano', 'heavy')))
                for n in ('K1', 'K2')}
    rows = {m: sum(r[0] for r in rs) for m, rs in rounds.items()}
    ab_bound = -(-rows['ab'] // SERVE_DEVICE_BATCH) + 1
    client_s = {}
    for (path, body), reply in zip(SERVE_REQUESTS, replies):
        if reply is not None:
            kind = path + (' inpaint' if body.get('method') == 'inpaint' else '')
            client_s.setdefault(kind, []).append(reply[2])
    # the profiled rounds: device ms, ms per forward, idle share; the
    # unprofiled rounds' idle share from their host wall and the median
    # device ms per forward of the profiled rounds of their model
    device = ('not measured: the profiler saw {} marked rounds of {}'.format(
        len(spans), len(marked)) if len(spans) != len(marked) else [
        {'stage': st, 'model': m, 'rows': r[0], 'batch': r[1], 'pad_to': r[2],
         'host_ms': r[3] * 1e3, 'span_ms': span, 'device_ms': busy,
         'device_ms_per_forward': busy / -(-r[2] // k), 'idle_share': 1 - busy / span}
        for (st, m, r), (span, busy) in zip(marked, spans)])
    estimated = 'not measured'
    if not isinstance(device, str):
        per_forward = {m: statistics.median(d['device_ms_per_forward'] for d in device
                                            if d['model'] == m) for m in ('ab', 'nano')}
        estimated = {f'{st}_{m}': [1 - per_forward[m] * -(-r[2] // k) / (r[3] * 1e3)
                                   for r in rs]
                     for (st, m), rs in log.items() if st in ('warmup', 'burst')}
    per_forward_ms = {f'{st}_{m}': [r[3] / -(-r[2] // k) * 1e3 for r in rs]
                      for (st, m), rs in log.items()}
    emit({'phase': 'serve', 'batch_size': SERVE_BATCH, 'device_batch': SERVE_DEVICE_BATCH,
          'window_ms': SERVE_WINDOW_MS, 'requests': len(SERVE_REQUESTS),
          'service_start_with_warmup_s': warmup_s, 'burst_s': burst_s,
          'rows': rows, 'rows_per_s': sum(rows.values()) / burst_s,
          'rounds': {m: len(rs) for m, rs in rounds.items()}, 'ab_round_bound': ab_bound,
          'rounds_as_run': {f'{st}_{m}': rs for (st, m), rs in log.items()},
          'round_ms_per_forward': per_forward_ms,
          'first_burst_ab_round_vs_warmup': (per_forward_ms['burst_ab'][0]
                                             / statistics.mean(per_forward_ms['warmup_ab']) - 1),
          'forwards': forwards, 'launches': launched, 'expected_launches': expected,
          'p50_p95_sec': {ep: [v.get('p50_sec'), v.get('p95_sec')]
                          for ep, v in metrics['endpoints'].items()},
          'client_sec': {kind: sorted(v) for kind, v in client_s.items()},
          'host_prep_s': {n: [s for f, s in burst_prep if f == n] for n in originals},
          'profiled_burst_s': profiled_s, 'profiled_rounds': device,
          'idle_share_from_profiled_device_ms': estimated,
          'metrics': metrics, 'health': health, 'errors': errors[:10]})
    if errors:
        fail(f'serve: {len(errors)} replies failed their checks: {errors[:3]}')
    if len(rounds['ab']) > ab_bound:
        fail(f'serve: {len(rounds["ab"])} Ab rounds for {rows["ab"]} rows (bound {ab_bound})')
    if launched != expected:
        fail(f'serve: launches {launched} != the forwards the rounds ran {expected}')
    if (health['models'] != ['ab', 'nano'] or health['device'] != 'cuda'
            or health['device_name'] != torch.cuda.get_device_name(0)):
        fail(f'serve: /health reads {health}')
    return launched


def service_phases(torch, dev, ab_ckpt, nano_ckpt):
    """The ninth slice: K1 and K2 at its batches (``service_shapes_phase``),
    the germline warm-up of both checkpoints, then
    ``sampler_k2``, ``inpaint_ab``, ``sequential_reference`` (Ab and Nb)
    and ``serve``. Returns the burst's K1/K2 launches and the paths of the
    germline-tuned Ab and Nb checkpoints."""
    from hudiff_tpu_torch.sampling import humanize as HZ
    service_shapes_phase(torch, dev)
    lib = _germline_library()
    ab = germline_tune(torch, dev, 'pair', ab_ckpt, lib)
    nano = germline_tune(torch, dev, 'heavy', nano_ckpt, lib)
    model = sampler_k2_phase(torch, dev, ab)
    inpaint_ab_phase(torch, model)
    del model
    sequential_reference_phase(torch, dev, 'pair', ab, HZ.pair_input(H1, L1))
    sequential_reference_phase(torch, dev, 'heavy', nano, HZ.nano_input(VHH1))
    torch.cuda.empty_cache()
    return serve_phase(torch, ab, nano), ab, nano


# -- the evaluation path and the released payloads (the tenth slice) --------

EVAL_ROWS = 16          # candidate rows per antibody in the eval CLIs (--batch-size)
EVAL_PACK = 64          # their device batch (--pack-size): a batch K1/K2 are held at above
NATIVENESS_N, NATIVENESS_B = 256, 64
NATIVENESS_TOL = 1e-4   # f32 scores, card against the CPU
# a released payload loaded through load_denoiser against the port model it
# was written from: the conversion only permutes and reshapes, so f32
# logits within RELEASED_F32_TOL; bf16 at the K1 limits
RELEASED_F32_TOL = 1e-6
RELEASED_LAYOUTS = {'ab_pretrain': ('pair', False), 'ab_finetune': ('pair', True),
                    'nb_finetune': ('heavy', True)}
SCORER_TYPES = ('VH', 'VKappa', 'VLambda', 'VHH')
ALIGN_SCORE_RTOL = 1e-4   # native (f32) against the Python DP (f64)
STORE_RECORDS, STORE_BATCH = 4096, 128

# The port's parameter names -> the reference's, for one ByteNet block:
# (port leaf, reference module, how the weight is laid out). Scaffolding that
# writes the released layouts from a port model (the inverse of
# hudiff_tpu_torch/training/checkpoints.py::convert_torch_denoiser); the
# package itself only reads them.
_REF_BLOCK = (('ln1', 'sequence1.0', None), ('fc1', 'sequence1.2.conv', 'pff'),
              ('ln2', 'sequence1.3', None), ('conv', 'conv', 'conv'),
              ('ln3', 'sequence2.0', None), ('fc2', 'sequence2.2.conv', 'pff'))


def reference_state_dict(state_dict, nhead):
    """The reference torch state_dict (hudiffab.pt / hudiffnb.pt names:
    interleaved RoPE pairs, separate query/key/value projections,
    PositionFeedForward convolutions [out, in, 1], Conv1d [out, in, K]) of a
    port ``AntiTFNet`` / ``NanoAntiTFNet`` state_dict, as f32 CPU tensors."""
    import numpy as np
    import torch
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    out = {}

    def copy(dst, src, layout=None):
        for p in ('weight', 'bias'):
            v = sd.get(f'{src}.{p}')
            if v is None:
                continue
            if p == 'weight' and layout == 'pff':
                v = v[:, :, None]
            elif p == 'weight' and layout == 'conv':
                v = v.transpose(0, 2, 1)   # port [out, K, in]
            out[f'{dst}.{p}'] = v

    def tower(dst, src):
        i = 0
        while f'{src}.blocks.{i}.ln1.weight' in sd:
            for leaf, module, layout in _REF_BLOCK:
                copy(f'{dst}.{i}.{module}', f'{src}.blocks.{i}.{leaf}', layout)
            i += 1

    def qkv(dst, src):
        # port [3A, in], head-major ([q_h | k_h | v_h] per head), q/k in
        # rotate-half order (i, D/2 + i) -> interleaved pairs (2i, 2i + 1)
        w, b = sd[f'{src}.weight'], sd[f'{src}.bias']
        A = w.shape[0] // 3
        hd = A // nhead
        per_head = np.concatenate([np.arange(0, hd, 2), np.arange(1, hd, 2)])
        inv = np.argsort(np.concatenate([h * hd + per_head for h in range(nhead)]))
        w, b = w.reshape(nhead, 3, hd, -1), b.reshape(nhead, 3, hd)
        for j, part in enumerate(('query', 'key', 'value')):
            wj, bj = w[:, j].reshape(A, -1), b[:, j].reshape(A)
            if part != 'value':
                wj, bj = wj[inv], bj[inv]
            out[f'{dst}.{part}.weight'], out[f'{dst}.{part}.bias'] = wj, bj

    out['aa_encoder.embedder.weight'] = sd['aa_embed.weight']
    if 'side_encoder.embed.weight' in sd:
        for side in ('h', 'l'):
            tower(f'aa_encoder.{side}_layers', f'aa_encoder.{side}_tower')
            tower(f'dual_conv_block.{side}_layers', f'dual_conv.{side}_tower')
        for src, dst in (('embed', 'side_embeddinng'), ('fc1', 'side_mlp.0'),
                         ('ln', 'side_mlp.1'), ('fc2', 'side_mlp.3')):
            copy(f'side_encoder.{dst}', f'side_encoder.{src}')
    else:
        tower('aa_encoder.layers', 'aa_encoder')
        tower('nano_conv_block.layers', 'nano_conv')
    for src, dst, layout in (('embed', 'region_embedding', None), ('ln1', 'region_layer1.0', None),
                             ('fc', 'region_layer1.2.conv', 'pff'),
                             ('ln2', 'region_layer1.3', None)):
        copy(f'region_encoder.{dst}', f'region_encoder.{src}', layout)
    copy('pos_encoder.pos_lin.ln1', 'pos_encoder.mlp.fc1')
    copy('pos_encoder.pos_lin.ln2', 'pos_encoder.mlp.fc2')
    i = 0
    while f'self_att.blocks.{i}.norm1.weight' in sd:
        dst, src = f'self_at.layers.{i}', f'self_att.blocks.{i}'
        for att, ref in (('attn', 'attn_hl'), ('attn_c', 'attn_hl_c')):
            qkv(f'{dst}.{ref}', f'{src}.{att}.qkv')
            copy(f'{dst}.{ref}.out_put', f'{src}.{att}.out')
        for leaf, ref in (('norm1', 'norm_hl1'), ('norm2', 'norm_hl2'), ('ff1', 'ff_hl.0'),
                          ('ff2', 'ff_hl.2')):
            copy(f'{dst}.{ref}', f'{src}.{leaf}')
        i += 1
    copy('last_norm', 'last_norm')
    copy('decoder', 'decoder')
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def _easydict(d):
    """``d`` as nested ``easydict.EasyDict`` objects, the class the released
    files pickle (the port's unpickle shim provides it when the package is
    absent)."""
    from hudiff_tpu_torch.training import checkpoints as CKPT
    CKPT._ensure_unpickle_shims()
    import easydict
    out = easydict.EasyDict()
    for k, v in d.items():
        out[k] = _easydict(v) if isinstance(v, dict) else v
    return out


def released_payload(layout, ref_sd, model_cfg):
    """A payload in one released layout (tests/test_release_payloads.py pins
    them): ``ab_pretrain`` (hudiffab.pt: an EasyDict config with a .model
    section, antibody_train.py:439-445), ``ab_finetune`` (the bare
    denoiser under 'model', its config under 'pretrain_config',
    antibody_finetune.py:348-355) or ``nb_finetune`` (hudiffnb.pt: the
    framework's state_dict with 'infilling_pretrain.' and
    'eval_abnativ_model.' prefixes, the model kwargs under
    'infilling_params', nanofinetune.py:531-539). ``ref_sd`` is a
    ``reference_state_dict``, ``model_cfg`` the model's config fields."""
    import torch
    opt = {'state': {0: {'step': torch.tensor(1), 'exp_avg': torch.zeros(3)}},
           'param_groups': [{'lr': 1e-4}]}
    if layout == 'ab_pretrain':
        return {'config': _easydict({'model': dict(model_cfg),
                                     'train': {'seed': SEED, 'batch_size': 64},
                                     'dataset': {'name': 'oas_pair'}}),
                'model': ref_sd, 'optimizer': opt, 'scheduler': {'factor': 0.6},
                'iteration': 100000}
    if layout == 'ab_finetune':
        return {'fineconfig': _easydict({'finetune': {'lr': 1e-5}}),
                'pretrain_config': _easydict({'model': dict(model_cfg)}),
                'model': ref_sd, 'optimizer': opt, 'scheduler': {}, 'iteration': 5000}
    sd = {f'infilling_pretrain.{k}': v for k, v in ref_sd.items()}
    # the frozen scorer's weights ride along under their own prefix
    sd['eval_abnativ_model.encoder.fc.weight'] = torch.zeros(4, 4)
    sd['eval_abnativ_model.encoder.fc.bias'] = torch.zeros(4)
    return {'config': _easydict({'model': {'loss_type': 'smooth_loss'}}), 'model': sd,
            'abnativ_params': {'d_embedding': 128, 'kernel': 4},
            'infilling_params': _easydict(dict(model_cfg)), 'optimizer': opt,
            'scheduler': {}, 'iteration': 28000}


def released_scorer_payload(model):
    """An AbNatiV scorer in the released lightning ``.ckpt`` layout: the
    hparams pickled as an EasyDict under ``hyper_parameters['hparams']``
    (abnativ_scoring.py:284-287)."""
    return {'hyper_parameters': {'hparams': _easydict(dataclasses.asdict(model.hp))},
            'state_dict': {k: v.detach().cpu() for k, v in model.state_dict().items()},
            'epoch': 3, 'global_step': 1234}


def _logit_inputs(torch, kind, B, dev):
    import numpy as np
    from hudiff_tpu_torch import constants as C
    rs = np.random.RandomState(SEED + 30)
    L = C.PAIR_LEN if kind == 'pair' else C.HEAVY_LEN
    put = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)  # noqa: E731
    tokens = put(rs.randint(0, C.N_TOKENS, (B, L)))
    if kind == 'pair':
        region = put(np.tile(np.concatenate([C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]),
                             (B, 1)))
        return tokens, region, put([[0, 1 + i % 2] for i in range(B)])
    return tokens, put(np.tile(C.HEAVY_REGION_INDEX, (B, 1)))


def released_payloads_phase(torch, dev, ab_ckpt, nano_ckpt, root):
    """The germline-tuned models written in the three released layouts and
    loaded back through ``load_denoiser``: f32 logits on the card against
    the model each came from (RELEASED_F32_TOL), bf16 at the K1 limits,
    ``finetuned`` as the layout says; then four AbNatiV scorers at the
    released hparams (random weights) written as lightning ``.ckpt`` files
    that ``load_abnativ`` reads back to the same weights.
    Returns every path by layout and scorer type."""
    from hudiff_tpu_torch.models.denoiser import DenoiserConfig
    from hudiff_tpu_torch.sampling import humanize as HZ
    from hudiff_tpu_torch.training import checkpoints as CKPT
    os.makedirs(root, exist_ok=True)
    paths, rec, ok = {}, {'phase': 'released_payloads', 'B': 4}, True
    for layout, (kind, finetuned) in RELEASED_LAYOUTS.items():
        src_path = ab_ckpt if kind == 'pair' else nano_ckpt
        src, config = CKPT.load(src_path, device=dev)
        cfg = DenoiserConfig.from_dict(config['model'])
        path = paths[layout] = os.path.join(root, f'{layout}.pt')
        torch.save(released_payload(layout, reference_state_dict(src.state_dict(), cfg.nhead),
                                    dataclasses.asdict(cfg)), path)
        del src
        inputs = _logit_inputs(torch, kind, rec['B'], dev)
        r = {'bytes': os.path.getsize(path)}
        for bf16 in (False, True):
            dtype = torch.bfloat16 if bf16 else torch.float32
            t0 = time.perf_counter()
            model, found = HZ.load_denoiser(path, kind, device=dev, use_bf16=bf16)
            load_s = time.perf_counter() - t0
            ref_model, _ = CKPT.load(src_path, dtype=dtype, device=dev)
            with torch.inference_mode():
                got, ref = model(*inputs).float(), ref_model(*inputs).float()
            err = (got - ref).abs()
            tag = 'bf16' if bf16 else 'f32'
            r.update({f'load_s_{tag}': load_s, f'max_abs_err_{tag}': err.max().item(),
                      'finetuned': found, 'max_abs_logit': ref.abs().max().item()})
            within = (err <= BF16_RTOL * ref.abs() + TOL_BF16['K1']).all().item() if bf16 \
                else err.max().item() <= RELEASED_F32_TOL
            ok = ok and within and found == finetuned and torch.isfinite(got).all().item()
            del model, ref_model
        rec[layout] = r
    from hudiff_tpu_torch.training import finetune as FT
    for i, name in enumerate(SCORER_TYPES):
        path = paths[name] = os.path.join(root, f'{name}_model.ckpt')
        scorer = _released_scorer(torch, 30 + i, False)
        torch.save(released_scorer_payload(scorer), path)
        loaded = FT.load_abnativ(path, straight_through=False, device='cpu')
        ok = ok and loaded.hp == scorer.hp and all(
            torch.equal(loaded.state_dict()[k], v) for k, v in scorer.state_dict().items())
    rec['tol_f32'] = RELEASED_F32_TOL
    emit(rec)
    if not ok:
        fail('a released payload did not load back to the model it was written from')
    torch.cuda.empty_cache()
    return paths


class _EvalClock:
    """Inside ``with``: the host seconds of every alignment (each outermost
    ``align_to_aho`` / ``align_to_aho_batch`` call), of every scorer batch
    (``harness._score_batch``, ended by a synchronize) and each batch's
    device ms (CUDA events), and the set of (sequence, profile) the
    aligner saw, added to ``aligned``."""

    def __init__(self, torch, aligned):
        self.torch, self.aligned = torch, aligned
        self.align_s = self.score_s = 0.0
        self.batch_ms = []

    def __enter__(self):
        from hudiff_tpu_torch.eval import harness as EH
        from hudiff_tpu_torch.numbering import align as AL
        torch, depth = self.torch, [0]
        self._orig = (AL.align_to_aho, AL.align_to_aho_batch, EH._score_batch)
        one, batch, score = self._orig

        def timed(fn, record):
            def wrapper(seqs, chain_type='H'):
                record(seqs, chain_type)
                depth[0] += 1
                t0 = time.perf_counter()
                try:
                    return fn(seqs, chain_type=chain_type)
                finally:
                    depth[0] -= 1
                    if not depth[0]:
                        self.align_s += time.perf_counter() - t0
            return wrapper

        def scored(model, x, model_type):
            if x.device.type != 'cuda':
                return score(model, x, model_type)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = score(model, x, model_type)
            end.record()
            end.synchronize()
            self.score_s += time.perf_counter() - t0
            self.batch_ms.append(start.elapsed_time(end))
            return out

        AL.align_to_aho = timed(one, lambda s, c: self.aligned.add((s, c)))
        AL.align_to_aho_batch = timed(batch, lambda ss, c: self.aligned.update(
            (s, c) for s in ss if isinstance(s, str)))
        EH._score_batch = scored
        return self

    def __exit__(self, *exc):
        from hudiff_tpu_torch.eval import harness as EH
        from hudiff_tpu_torch.numbering import align as AL
        AL.align_to_aho, AL.align_to_aho_batch, EH._score_batch = self._orig

    def record(self):
        return {'align_s': self.align_s, 'score_s': self.score_s,
                'scorer_batches': len(self.batch_ms),
                'device_ms_per_batch': statistics.median(self.batch_ms) if self.batch_ms
                else 'not measured'}


def _mutant(seq, rs, n=5):
    """``seq`` with ``n`` residues at random positions replaced."""
    from hudiff_tpu_torch import constants as C
    s = list(seq)
    for i in rs.choice(len(s), n, replace=False):
        s[i] = C.AA_1[rs.randint(len(C.AA_1))]
    return ''.join(s)


def nativeness_phase(torch, dev, paths, aligned):
    """``api.nativeness`` over NATIVENESS_N heavy chains (germline V + J
    combinations of the embedded library, every other one a five-residue
    mutant) at batch NATIVENESS_B with the VH and VHH scorers, on the card
    after one untimed call: seqs/s, the seconds in alignment and in the
    scorer, device ms a batch; then the same calls on the CPU: the f32
    scores to NATIVENESS_TOL, NaN (unaligned) at the same places."""
    import numpy as np
    from hudiff_tpu_torch import api
    from hudiff_tpu_torch.sampling import humanize as HZ
    rs = np.random.RandomState(SEED + 31)
    grids, _ = _germline_batch(_germline_library(), 'heavy', NATIVENESS_N, rs)
    seqs = [HZ._TOK.idx2seq(g) for g in grids]
    seqs = [_mutant(s, rs) if i % 2 else s for i, s in enumerate(seqs)]
    rec, ok = {'phase': 'nativeness', 'n': len(seqs), 'batch_size': NATIVENESS_B}, True
    for mtype in ('VH', 'VHH'):
        api.nativeness(seqs[:NATIVENESS_B], mtype, paths[mtype], batch_size=NATIVENESS_B,
                       device=dev)
        with _EvalClock(torch, aligned) as clock:
            t0 = time.perf_counter()
            card = api.nativeness(seqs, mtype, paths[mtype], batch_size=NATIVENESS_B,
                                  device=dev)
            wall = time.perf_counter() - t0
        cpu = api.nativeness(seqs, mtype, paths[mtype], batch_size=NATIVENESS_B, device='cpu')
        c, p = np.asarray(card), np.asarray(cpu)
        same_nan = bool((np.isnan(c) == np.isnan(p)).all())
        live = ~np.isnan(p)
        err = float(np.abs(c[live] - p[live]).max()) if live.any() else float('nan')
        rec[mtype] = {'wall_s': wall, 'seqs_per_s': len(seqs) / wall, **clock.record(),
                      'unaligned': int((~live).sum()), 'max_abs_err_vs_cpu': err,
                      'score_range': [float(p[live].min()), float(p[live].max())]}
        ok = ok and same_nan and live.sum() > len(seqs) // 2 and err <= NATIVENESS_TOL
    rec['tol'] = NATIVENESS_TOL
    emit(rec)
    if not ok:
        fail('nativeness: the card scores disagree with the CPU, or most chains did not align')


def _eval_pairs():
    """Sixteen mouse-like pairs: the two test antibodies, their chains
    swapped, and seeded framework mutants of those four."""
    import numpy as np
    from hudiff_tpu_torch.sampling import humanize as HZ
    rs = np.random.RandomState(SEED + 32)
    base = [(H1, L1), (H2, L2), (H1, L2), (H2, L1)]
    pairs = list(base)
    while len(pairs) < 16:
        h, l = base[len(pairs) % 4]
        m = (_mutant(h, rs, 3), _mutant(l, rs, 3))
        inp = HZ.pair_input(*m)
        if inp is not None and _region_cdrs(*m, inp['l_group']) == _region_cdrs(h, l, inp['l_group']):
            pairs.append(m)
    return [(f'm{i}', h, l) for i, (h, l) in enumerate(pairs)]


def _counting_rounds(cls, forwards):
    """Wrap ``cls.sample_rows`` adding each round's forwards (ceil(pad_to /
    k)) to ``forwards[0]``; returns the undo."""
    orig = cls.sample_rows

    def recording(self, rows, pad_to, batch=None):
        forwards[0] += -(-pad_to // self.positions_per_step)
        return orig(self, rows, pad_to, batch=batch)

    cls.sample_rows = recording
    return lambda: setattr(cls, 'sample_rows', orig)


def _run_cli(fn, argv):
    """``fn(argv)`` with its standard output captured: (result, text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue()


def _sample_rows(path):
    import csv
    with open(path, newline='') as f:
        return list(csv.DictReader(f))


def eval_ab_phase(torch, dev, paths, root, aligned):
    """The ``ab`` CLI from the released Ab pretraining payload (bf16, 16
    rows an antibody, device batch EVAL_PACK) over ``_eval_pairs``, then
    ``eval.harness ab`` on its CSV against the pairs' CSV (an
    ``order_name`` column; each pair's experimental partner its
    ``cdr_pair_grafting`` graft) with the released-layout VH, VKappa and
    VLambda scorers. Fails unless every antibody got a sample, every sample
    aligns and its realigned CDRs are its parent's, the K1/K2 counters equal
    the forwards the CLI's rounds ran, and the report's AbNatiV means are
    finite. Returns the CLI's K1/K2 launches."""
    import json as _json
    import numpy as np
    from hudiff_tpu_torch.eval import harness as EH
    from hudiff_tpu_torch.numbering import germline as G
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    from hudiff_tpu_torch.sampling import humanize as HZ
    pairs = _eval_pairs()
    pair_csv = os.path.join(root, 'eval_pairs.csv')
    with open(pair_csv, 'w') as f:
        f.write('type,name,order_name,h_seq,l_seq\n')
        for i, (name, h, l) in enumerate(pairs):
            f.write(f'mouse,{name},{i}_mouse,{h},{l}\n')
        for i, (name, h, l) in enumerate(pairs):
            f.write('humanized,{}h,{}_humanized,{},{}\n'.format(name, i, *G.cdr_pair_grafting(h, l)))
    forwards = [0]
    undo = _counting_rounds(HZ.PairHumanizer, forwards)
    try:
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_csv, _ = _run_cli(HZ.main, [
            'ab', '--ckpt', paths['ab_pretrain'], '--data-fpath', pair_csv,
            '--batch-size', str(EVAL_ROWS), '--pack-size', str(EVAL_PACK),
            '--logdir', os.path.join(root, 'logs'), '--device', dev.type])
        torch.cuda.synchronize()
        humanize_s = time.perf_counter() - t0
        launched = {'K1': FA.launches, 'K2': FB.launches}
    finally:
        undo()
    expected = {k: v * forwards[0] for k, v in KERNELS_PER_FORWARD['pair'].items()}
    with _EvalClock(torch, aligned) as clock:
        t0 = time.perf_counter()
        report, text = _run_cli(EH.main, [
            'ab', '--sample-csv', sample_csv, '--pair-csv', pair_csv,
            '--abnativ-vh', paths['VH'], '--abnativ-vlk', paths['VKappa'],
            '--abnativ-vll', paths['VLambda'], '--out', os.path.join(root, 'eval_ab.json'),
            '--device', dev.type])
        eval_s = time.perf_counter() - t0
    parents = {name: (h, l) for name, h, l in pairs}
    samples = [r for r in _sample_rows(sample_csv) if r['Specific'] == 'humanization']
    bad = []
    for r in samples:
        h, l = parents[EH._parental_key(r['name'])]
        group = HZ.pair_input(h, l)['l_group']
        if _region_cdrs(r['hseq'], r['lseq'], group) != _region_cdrs(h, l, group):
            bad.append(r['name'])
    emit({'phase': 'eval_ab', 'antibodies': len(pairs), 'samples': len(samples),
          'rows_per_antibody': EVAL_ROWS, 'device_batch': EVAL_PACK, 'forwards': forwards[0],
          'humanize_s': humanize_s, 'eval_s': eval_s, **clock.record(),
          'launches': launched, 'expected_launches': expected,
          'report_keys': sorted(report), 'report': report,
          'samples_whose_cdrs_differ': bad})
    if not (len(samples) == len(pairs) and report['n_matched'] == len(pairs)
            and report['n_skipped_unaligned'] == 0 and not bad and launched == expected
            and _json.loads(text) == report
            and all(np.isfinite(report[k]) for k in (
                'abnativ_vh_mean', 'abnativ_vh_improvement', 'abnativ_vl_mean',
                'abnativ_vl_improvement'))):
        fail('eval_ab: a sample is missing, unaligned or changed its CDRs, the launches '
             'differ from the forwards, or an AbNatiV mean is not finite')
    return launched


def eval_nano_phase(torch, dev, paths, root, aligned):
    """The ``nano`` CLI from the released Nb fine-tune payload (bf16, 16
    rows a nanobody, device batch EVAL_PACK) over the two test VHHs and six
    seeded framework mutants, then ``eval.harness nano`` with the
    released-layout VH and VHH scorers; the checks of ``eval_ab_phase``.
    Returns the CLI's K1/K2 launches."""
    import json as _json
    import numpy as np
    from hudiff_tpu_torch.eval import harness as EH
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    from hudiff_tpu_torch.sampling import humanize as HZ
    rs = np.random.RandomState(SEED + 33)
    vhhs = [VHH1, VHH2]
    while len(vhhs) < 8:
        m = _mutant(vhhs[len(vhhs) % 2], rs, 3)
        if HZ.nano_input(m) is not None and _region_cdrs(m) == _region_cdrs(vhhs[len(vhhs) % 2]):
            vhhs.append(m)
    vhh_csv = os.path.join(root, 'eval_vhhs.csv')
    with open(vhh_csv, 'w') as f:
        f.write('vhh_seq\n' + ''.join(v + '\n' for v in vhhs))
    forwards = [0]
    undo = _counting_rounds(HZ.NanoHumanizer, forwards)
    try:
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_csv, _ = _run_cli(HZ.main, [
            'nano', '--ckpt', paths['nb_finetune'], '--data-fpath', vhh_csv,
            '--batch-size', str(EVAL_ROWS), '--pack-size', str(EVAL_PACK),
            '--logdir', os.path.join(root, 'logs'), '--device', dev.type])
        torch.cuda.synchronize()
        humanize_s = time.perf_counter() - t0
        launched = {'K1': FA.launches, 'K2': FB.launches}
    finally:
        undo()
    expected = {k: v * forwards[0] for k, v in KERNELS_PER_FORWARD['heavy'].items()}
    with _EvalClock(torch, aligned) as clock:
        t0 = time.perf_counter()
        report, text = _run_cli(EH.main, [
            'nano', '--sample-csv', sample_csv, '--abnativ-vh', paths['VH'],
            '--abnativ-vhh', paths['VHH'], '--out', os.path.join(root, 'eval_nano.json'),
            '--device', dev.type])
        eval_s = time.perf_counter() - t0
    samples = [r for r in _sample_rows(sample_csv) if r['Specific'] == 'humanization']
    bad = [r['name'] for r in samples
           if _region_cdrs(r['vhh_seq']) != _region_cdrs(vhhs[int(EH._parental_key(r['name']))])]
    emit({'phase': 'eval_nano', 'nanobodies': len(vhhs), 'samples': len(samples),
          'rows_per_nanobody': EVAL_ROWS, 'device_batch': EVAL_PACK, 'forwards': forwards[0],
          'humanize_s': humanize_s, 'eval_s': eval_s, **clock.record(),
          'launches': launched, 'expected_launches': expected,
          'report_keys': sorted(report), 'report': report,
          'samples_whose_cdrs_differ': bad})
    if not (len(samples) == len(vhhs) and report['n_matched'] == len(vhhs) and not bad
            and launched == expected and _json.loads(text) == report
            and all(np.isfinite(report[k]) for k in (
                'abnativ_vh_mean', 'abnativ_vhh_mean', 'consensus_fr_identity'))):
        fail('eval_nano: a sample is missing, unaligned or changed its CDRs, the launches '
             'differ from the forwards, or an AbNatiV mean is not finite')
    return launched


def alignment_path_score(aligned, chain_type):
    """The f64 score of one AHo alignment (its residues' column scores less
    the skip cost of each empty column): equal to the Python DP's optimum
    when the alignment is optimal too, so a tie two DPs broke apart scores
    the same."""
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.numbering import align as AL
    score_mat, skip_cost = AL._profile(chain_type)
    total = 0.0
    for j, a in enumerate(aligned):
        if a == '-':
            total -= skip_cost[j]
        elif a != 'X':
            total += score_mat[j, C.AA_1.index(a)]
    return float(total)


def native_aligner_phase(torch, aligned, root):
    """On the card's host: the native aligner against the Python DP on every
    (chain, profile) the eval phases aligned (aligned strings equal, or a
    tie the two broke apart: the native path scores the Python optimum in
    f64; scores within ALIGN_SCORE_RTOL), ms a call both ways, and ``align_to_aho_batch``
    over the nativeness phase's 256 chains; then ``RecordStore`` native
    against mmap on a store of STORE_RECORDS records: equal records, and
    the ms of STORE_BATCH random ``get_obj`` both ways."""
    import numpy as np
    from hudiff_tpu_torch.data import store as RS
    from hudiff_tpu_torch.numbering import align as AL
    from hudiff_tpu_torch.sampling import humanize as HZ
    items = sorted(aligned)
    native_s = python_s = 0.0
    differ, ties, worst, failed_one_way = [], [], 0.0, 0
    for seq, ct in items:
        t0 = time.perf_counter()
        a = AL.align_to_aho(seq, ct)
        t1 = time.perf_counter()
        b = AL.align_to_aho_python(seq, ct)
        python_s += time.perf_counter() - t1
        native_s += t1 - t0
        if (a is None) != (b is None):
            failed_one_way += 1
        elif a is not None:
            rel = abs(a[1] - b[1]) / max(abs(b[1]), 1.0)
            worst = max(worst, rel)
            if a[0] != b[0]:
                tie = abs(alignment_path_score(a[0], ct) - b[1]) / max(abs(b[1]), 1.0)
                (ties if tie <= ALIGN_SCORE_RTOL else differ).append((seq[:12], ct, a[1], b[1]))
    rs = np.random.RandomState(SEED + 31)
    grids, _ = _germline_batch(_germline_library(), 'heavy', NATIVENESS_N, rs)
    chains = [HZ._TOK.idx2seq(g) for g in grids]
    t0 = time.perf_counter()
    batch = AL.align_to_aho_batch(chains, 'H')
    batch_s = time.perf_counter() - t0
    one = [AL.align_to_aho(s, 'H') for s in chains]
    path = os.path.join(root, 'store')
    recs = [{'i': i, 'h': rs.randint(0, 23, 152).astype(np.int8),
             'l': rs.randint(0, 23, 139).astype(np.int8), 'name': f'r{i}'}
            for i in range(STORE_RECORDS)]
    with RS.RecordStoreWriter(path) as w:
        for r in recs:
            w.put_obj(r)
    readers = {'native': RS.RecordStore(path), 'mmap': RS.RecordStore(path, native=False)}
    equal = all(readers['native'].get(i) == readers['mmap'].get(i) for i in range(STORE_RECORDS))
    ids = rs.randint(0, STORE_RECORDS, (20, STORE_BATCH))
    batch_ms = {}
    for name, rd in readers.items():
        times = []
        for row in ids:
            t0 = time.perf_counter()
            got = [rd.get_obj(int(i)) for i in row]
            times.append((time.perf_counter() - t0) * 1e3)
        batch_ms[name] = statistics.median(times)
        equal = equal and all(g['i'] == int(i) for g, i in zip(got, row))
        rd.close()
    n = len(items)
    emit({'phase': 'native_aligner', 'calls': n,
          'native_ms_per_call': native_s / n * 1e3, 'python_ms_per_call': python_s / n * 1e3,
          'batch_chains': len(chains), 'batch_ms': batch_s * 1e3,
          'batch_ms_per_chain': batch_s / len(chains) * 1e3,
          'batch_equals_single_calls': batch == one,
          'aligned_strings_differ': len(differ), 'differ_examples': differ[:5],
          'ties_broken_apart': len(ties), 'tie_examples': ties[:5],
          'failed_one_way': failed_one_way, 'max_score_rel_err': worst,
          'score_rtol': ALIGN_SCORE_RTOL,
          'record_store': {'records': STORE_RECORDS, 'equal': equal,
                           'batch': STORE_BATCH, 'ms_per_batch': batch_ms}})
    if differ or failed_one_way or worst > ALIGN_SCORE_RTOL or batch != one or not equal:
        fail('native_aligner: the native aligner or record store disagrees with its plain '
             'version')


def eval_phases(torch, dev, ab_ckpt, nano_ckpt):
    """The tenth slice: ``released_payloads``, ``nativeness``, ``eval_ab``,
    ``eval_nano`` and ``native_aligner`` on the germline-tuned models.
    Returns the kernels line's K1/K2 launch keys of the two eval phases."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build', 'eval')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    paths = released_payloads_phase(torch, dev, ab_ckpt, nano_ckpt, root)
    aligned = set()
    nativeness_phase(torch, dev, paths, aligned)
    ab = eval_ab_phase(torch, dev, paths, root, aligned)
    nano = eval_nano_phase(torch, dev, paths, root, aligned)
    native_aligner_phase(torch, aligned, root)
    torch.cuda.empty_cache()
    return {k: {'launches_eval_ab': ab[k], 'launches_eval_nano': nano[k]} for k in ('K1', 'K2')}


def nano_entries(nano):
    """The kernels line's nano keys for K1-K4: launches per forward, per
    humanization round and per train step of the nano path, and each
    kernel's readings at its nano shapes."""
    att = nano['attention']
    k1, k1_f32 = att[('K1', MAIN_B, 'bfloat16')], att[('K1', MAIN_B, 'float32')]
    k3, k3_f32 = att[('K3', NANO_TRAIN_B, 'bfloat16')], att[('K3', NANO_TRAIN_B, 'float32')]
    k2, k2_f32 = nano['K2'][(MAIN_B, 'bfloat16')], nano['K2'][(MAIN_B, 'float32')]
    k2_train = nano['K2'][(NANO_TRAIN_B, 'bfloat16')]
    k4, k4_f32 = nano['K4'][(NANO_TRAIN_B, 'bfloat16')], nano['K4'][(NANO_TRAIN_B, 'float32')]
    out = {}
    for k, rec, rec_f32, shape in (
            ('K1', k1, k1_f32, f'B={MAIN_B} L=152 H=8 D=64 bf16'),
            ('K2', k2, k2_f32, f'B={MAIN_B} L=152 D=512 H=256 GELU bf16, mean over the '
                               f'{k2["calls"]} nano_conv blocks'),
            ('K3', k3, k3_f32, f'B={NANO_TRAIN_B} L=152 H=8 D=64 bf16, given K1\'s residuals'),
            ('K4', k4, k4_f32, f'B={NANO_TRAIN_B} L=152 D=512 H=256 GELU bf16, mean over '
                               f'the {k4["calls"]} nano_conv blocks')):
        n = rec.get('calls', 1)
        out[k] = {'nano_launches_per_forward': nano['per_forward'][k],
                  'nano_launches_round': nano['round'].get(k, 0),
                  'nano_launches_per_step': nano['per_step'][k],
                  'nano_launches_pretrain': nano['pretrain'][k],
                  'nano_max_abs_err': rec['max_abs_err'],
                  'nano_excess_over_rtol': rec['excess_over_rtol'],
                  'nano_max_abs_err_f32': rec_f32['max_abs_err'],
                  'nano_ms': rec['ms'] / n, 'nano_plain_ms': rec['plain_ms'] / n,
                  'nano_bound_ms': rec['bound_ms'] / n, 'nano_shape': shape}
    out['K2'].update(nano_stage_excess={k: k2[k] for k in STAGE_KEYS},
                     nano_B512_excess_over_rtol=k2_train['excess_over_rtol'],
                     nano_B512_excess_block_f32_ln=k2_train['excess_block_f32_ln'],
                     nano_conv_ms_per_forward=k2['ms'])
    out['K4'].update(nano_grad_rel_err=k4['grad_rel_err'],
                     nano_grad_rel_err_f32=k4_f32['grad_rel_err'],
                     nano_conv_ms_per_step=k4['ms'])
    return out


def _rotated_bhld(torch, q, k, v, cos, sin, heads):
    """RoPE applied to q and k, and q, k, v as contiguous [B, H, L, D]: the
    input of scaled_dot_product_attention for the same function as K5."""
    from hudiff_tpu_torch.ops.rope import apply_rope
    B, L, A = q.shape
    hd = A // heads

    def bhld(t):
        return t.reshape(B, L, heads, hd).transpose(1, 2).contiguous()

    rot = lambda t: apply_rope(t.reshape(B, L, heads, hd), cos, sin).reshape(B, L, A)  # noqa: E731
    return bhld(rot(q)), bhld(rot(k)), bhld(v)


def k5_phase(torch, gen, dev):
    """K5 against its plain version and against K1 on the merged input
    (one body: the same bits expected) at L = 291, B = 16 and 64, f32 and
    bf16; times beside the plain version and scaled_dot_product_attention
    on pre-rotated q/k/v."""
    import torch.nn.functional as F
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops.rope import rope_tables
    heads, hd, L = 8, 64, C.PAIR_LEN
    cos, sin = rope_tables(hd, L, device=dev)
    scale = 1.0 / hd ** 0.5
    out = {}
    for B in (MAIN_B, BIG_B):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            q, k, v = (torch.randn(B, L, heads * hd, generator=gen).to(dev, dtype)
                       for _ in range(3))
            got = FA.rope_attention(q, k, v, cos, sin, scale, heads)
            ref = FA.rope_attention_reference(q, k, v, cos, sin, scale, heads)
            k1 = FA.rope_attention_qkv(FA.merge_qkv_heads(q, k, v, heads), cos, sin, scale,
                                       heads)
            res_ref = FA.rope_attention_reference(q, k, v, cos, sin, scale, heads,
                                                  residuals=True)
            torch.cuda.synchronize()
            errs, ok = check_err(torch, 'K5', got, ref)
            vs_k1, ok_k1 = check_err(torch, 'K5', got, k1)
            rec = {'phase': 'K5', 'B': B, 'L': L, 'dtype': name, **errs,
                   'max_abs_diff_vs_K1': vs_k1['max_abs_err'],
                   'identical_to_K1': torch.equal(got, k1),
                   **residual_check(
                       torch, name, got,
                       FA.rope_attention_forward(q, k, v, cos, sin, scale, heads,
                                                 residuals=True),
                       res_ref, out_f32_controls(torch, q, k, v, cos, sin, scale, heads,
                                                 res_ref[0]))}
            del res_ref
            if not (ok and ok_k1 and rec['residuals_ok']):
                emit(rec)
                fail(f'K5 disagrees with its plain version or with K1 ({name}, B={B})')
            qr, kr, vr = _rotated_bhld(torch, q, k, v, cos, sin, heads)
            # read q, k, v and the tables once, write out once; QK^T and PV
            nbytes = 4 * q.numel() * q.element_size() + 2 * cos.numel() * 4
            flops = 4.0 * B * heads * L * L * hd
            rec.update(
                ms=time_ms(torch, lambda: FA.rope_attention(q, k, v, cos, sin, scale, heads)),
                plain_ms=time_ms(torch, lambda: FA.rope_attention_reference(
                    q, k, v, cos, sin, scale, heads), reps=3),
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qr, kr, vr, scale=scale)))
            rec['bound_ms'], rec['bound_by'] = bound_ms(nbytes, flops, name)
            emit(rec)
            out[(B, name)] = rec
    return out


def k6_phase(torch, gen, dev):
    """K6 against its plain version at L = 291, B = 16 and 128, f32 and
    bf16, with a repeated call that must give the same bits (no atomics);
    times beside the plain version and the backward alone of
    scaled_dot_product_attention on pre-rotated q/k/v with the same dO."""
    import torch.nn.functional as F
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops.rope import rope_tables
    heads, hd, L = 8, 64, C.PAIR_LEN
    cos, sin = rope_tables(hd, L, device=dev)
    scale = 1.0 / hd ** 0.5
    out = {}
    for B in (MAIN_B, TRAIN_B):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            q, k, v, do = (torch.randn(B, L, heads * hd, generator=gen).to(dev, dtype)
                           for _ in range(4))
            o_bf, o32, lse = FA.rope_attention_forward(q, k, v, cos, sin, scale, heads, True)
            res = dict(out=o32, lse=lse)
            got = FA.rope_attention_backward(q, k, v, cos, sin, do, scale, heads, **res)
            again = FA.rope_attention_backward(q, k, v, cos, sin, do, scale, heads, **res)
            alone = FA.rope_attention_backward(q, k, v, cos, sin, do, scale, heads)
            ref = FA.rope_attention_backward_reference(q, k, v, cos, sin, do, scale, heads)
            twin = FA.rope_attention_backward_reference(q, k, v, cos, sin, do, scale, heads,
                                                        o32, lse)
            rounded = torch.stack(FA.rope_attention_backward(
                q, k, v, cos, sin, do, scale, heads, out=o_bf.float(),
                lse=lse)) if dtype == torch.bfloat16 else None
            torch.cuda.synchronize()
            errs, ok = backward_checks(torch, 'K6', *(torch.stack(t) for t in (
                got, again, alone, ref, twin)))
            rec = {'phase': 'K6', 'B': B, 'L': L, 'dtype': name, **errs,
                   **delta_reading(torch, 'K6', rounded, torch.stack(ref))}
            if not ok:
                emit(rec)
                fail(f'K6 disagrees with its plain versions or repeats apart ({name}, B={B})')
            del got, again, alone, ref, twin, rounded, o_bf
            qr, kr, vr = (t.requires_grad_()
                          for t in _rotated_bhld(torch, q, k, v, cos, sin, heads))
            o = F.scaled_dot_product_attention(qr, kr, vr, scale=scale)
            dO = do.reshape(B, L, heads, hd).transpose(1, 2).contiguous()
            rec['library_ms'] = time_ms(torch, lambda: torch.autograd.grad(
                o, (qr, kr, vr), dO, retain_graph=True))
            del o, qr, kr, vr, dO
            rec['ms'] = time_ms(torch, lambda: FA.rope_attention_backward(
                q, k, v, cos, sin, do, scale, heads, **res))
            rec['ms_standalone'] = time_ms(torch, lambda: FA.rope_attention_backward(
                q, k, v, cos, sin, do, scale, heads))
            rec['plain_ms'] = time_ms(torch, lambda: FA.rope_attention_backward_reference(
                q, k, v, cos, sin, do, scale, heads), reps=2, windows=3)
            # read q, k, v and dO once, write dq, dk, dv once; five 2 L^2 D products
            nbytes = 7 * q.numel() * q.element_size() + 2 * cos.numel() * 4
            flops = 5 * 2.0 * B * heads * L * L * hd
            rec['bound_ms'], rec['bound_by'] = bound_ms(nbytes, flops, name)
            emit(rec)
            out[(B, name)] = rec
            del q, k, v, do
            torch.cuda.empty_cache()
    return out


def attention_api_phase(torch, gen, dev):
    """One full-width RoPE attention layer through the public entry point
    ``rope_attention``, as a user builds it: x [128, 291, 768], separate
    q, k, v Linear 768 -> 512 and an out Linear 512 -> 768 over f32
    parameters, loss = mean(y^2), the backward through autograd (K5
    forward, K6 backward). In f32 the parameters' gradients are held
    against the same layer through the plain attention (torch autograd
    through ``rope_attention_reference``); in bf16 (the parameters cast per
    call) the loss and gradients must be finite, warm steps are timed, and
    the launch counters, set to 0 before a profiled window of steps, must
    equal the K5 and K6 kernels torch.profiler saw."""
    import torch.nn.functional as F
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops.rope import rope_tables
    heads, hd, L, dm, att = 8, 64, C.PAIR_LEN, 768, 512
    cos, sin = rope_tables(hd, L, device=dev)
    scale = 1.0 / hd ** 0.5
    torch.manual_seed(SEED)
    lin = torch.nn.ModuleDict({'q': torch.nn.Linear(dm, att), 'k': torch.nn.Linear(dm, att),
                               'v': torch.nn.Linear(dm, att),
                               'o': torch.nn.Linear(att, dm)}).to(dev)
    x32 = torch.randn(TRAIN_B, L, dm, generator=gen).to(dev)

    def step(x, attn=FA.rope_attention):
        """One forward and backward; returns the loss and the gradients."""
        lin.zero_grad(set_to_none=True)
        cast = {n: (m.weight.to(x.dtype), m.bias.to(x.dtype)) for n, m in lin.items()}
        q, k, v = (F.linear(x, *cast[n]) for n in 'qkv')
        y = F.linear(attn(q, k, v, cos, sin, scale, heads), *cast['o'])
        loss = y.float().square().mean()
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in lin.named_parameters()}

    loss_k, g_k = step(x32)
    loss_p, g_p = step(x32, FA.rope_attention_reference)
    rel = {n: ((g_k[n] - g_p[n]).abs().max() / g_p[n].abs().max()).item() for n in g_p}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    del g_k, g_p
    x = x32.to(torch.bfloat16)
    step(x)
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        loss, grads = step(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    finite = bool(torch.isfinite(loss).item()) and all(
        bool(torch.isfinite(g).all().item()) for g in grads.values())

    def window():
        reset_counters()
        for _ in range(n):
            step(x)
        torch.cuda.synchronize()

    counted, (groups, seen, top), first = profiled(torch, window, n)
    busy = sum(groups.values())
    rec = {'phase': 'attention_api', 'B': TRAIN_B, 'L': L, 'd_model': dm, 'att': att,
           'heads': heads, 'f32_loss_rel_err': loss_rel, 'f32_max_grad_rel_err': rel[worst],
           'f32_worst_param': worst, 'f32_grad_rtol': ATTN_API_F32_RTOL,
           'bf16_finite': finite, 'steps': n, 'wall_ms_per_step': wall_ms,
           'device_busy_ms_per_step': busy,
           'device_idle_share': (1 - busy / wall_ms) if busy else 'not measured',
           'device_ms_per_step_by_group': groups, 'top': top[:8],
           'counted_launches': counted, 'profiled_launches': seen, 'profiler': first}
    emit(rec)
    if not (finite and rel[worst] <= ATTN_API_F32_RTOL and loss_rel <= ATTN_API_F32_RTOL):
        fail('the RoPE attention layer through rope_attention fails its checks')
    if counted != seen or seen['K5'] != n or seen['K6'] != 3 * n:
        fail(f'launch counters {counted} != kernels the profiler saw {seen}')
    return {'launches': counted, 'steps': n}


def k7_phase(torch, gen, dev):
    """K7 through ``fused_attention`` ([B, H, L, D]) against its plain
    version and through ``attention`` ([B, L, H, D], the same bits
    expected) at L = 291, 8 heads x 64, B = 16 and 64, f32 and bf16; times
    beside the plain version and scaled_dot_product_attention, which
    computes the same function on the same inputs. Then both entry points
    once with the counters set to 0, and the refusal of a CUDA input that
    needs a gradient (K7 has no backward)."""
    import torch.nn.functional as F
    from hudiff_tpu_torch import constants as C
    from hudiff_tpu_torch.ops import fused_attention as FA
    heads, hd, L = 8, 64, C.PAIR_LEN
    scale = 1.0 / hd ** 0.5
    out = {}

    def t(x):
        return x.transpose(1, 2)

    for B in (MAIN_B, BIG_B):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            q, k, v = (torch.randn(B, heads, L, hd, generator=gen).to(dev, dtype)
                       for _ in range(3))
            got = FA.fused_attention(q, k, v, scale)
            ref = t(FA.attention_reference(t(q), t(k), t(v), scale))
            blhd = FA.attention(*(t(x).contiguous() for x in (q, k, v)), scale)
            torch.cuda.synchronize()
            errs, ok = check_err(torch, 'K7', got, ref)
            rec = {'phase': 'K7', 'B': B, 'L': L, 'dtype': name, **errs,
                   'blhd_identical': torch.equal(t(blhd), got)}
            if not (ok and rec['blhd_identical']):
                emit(rec)
                fail(f'K7 disagrees with its plain version or across layouts ({name}, B={B})')
            nbytes = 4 * q.numel() * q.element_size()
            flops = 4.0 * B * heads * L * L * hd
            rec.update(
                ms=time_ms(torch, lambda: FA.fused_attention(q, k, v, scale)),
                plain_ms=time_ms(torch, lambda: t(FA.attention_reference(
                    t(q), t(k), t(v), scale)), reps=3),
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale)))
            rec['bound_ms'], rec['bound_by'] = bound_ms(nbytes, flops, name)
            emit(rec)
            out[(B, name)] = rec
    q, k, v = (torch.randn(MAIN_B, L, heads, hd, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    reset_counters()
    FA.attention(q, k, v, scale)
    FA.fused_attention(t(q).contiguous(), t(k).contiguous(), t(v).contiguous(), scale)
    torch.cuda.synchronize()
    launched = counters()
    try:
        FA.attention(q.clone().requires_grad_(), k, v, scale)
        refused = False
    except RuntimeError:
        refused = True
    emit({'phase': 'K7_entry_points', 'B': MAIN_B, 'launches': launched,
          'refuses_grad': refused})
    if launched['K7'] != 2 or not refused:
        fail(f'K7 entry points: launches {launched}, refused under autograd: {refused}')
    return {'records': out, 'launches': launched['K7']}


def k8_check_inputs(torch, B, dev, dtype):
    """x ~ N(0, 1), column-blocked weights ~ N(0, 1/fan_in) and biases ~
    N(0, 0.01), numpy seed SEED, at the probe's widths: inputs on which
    attention is peaked, so that QK^T, the rotation and the softmax move y.
    (On the probe's own weights y is almost all bias, within 0.05.)"""
    import numpy as np
    rs = np.random.RandomState(SEED)
    dm, att = 768, 512
    draws = (rs.randn(B, 291, dm), rs.randn(dm, 3 * att) / np.sqrt(dm),
             rs.randn(3 * att) * 0.1, rs.randn(att, dm) / np.sqrt(att), rs.randn(dm) * 0.1)
    return [torch.tensor(a, dtype=torch.float32).to(dev, dtype) for a in draws]


def k8_phase(torch, dev):
    """K8 at the probe's shapes (B = 64, L = 291, d_model 768, att 512, 8
    heads). On ``k8_check_inputs``, in f32 and bf16: against its plain
    version, against the production split (cuBLAS projections around K1) on
    the head-major permutation of the same weights, and a repeated call for
    the same bits. Then the probe's CLI ``main()`` with the counters set to
    0 (the probe's seed-0 numpy weights in bf16): its fused_ms, current_ms,
    speedup and rel_err are K8's numbers. On the probe's inputs, the plain
    version, the same layer composed of torch.matmul, RoPE in torch, SDPA
    and torch.matmul, and a profile of three calls (each kernel's device
    time; the counters must equal the kernels seen)."""
    import contextlib
    import io
    import torch.nn.functional as F
    from hudiff_tpu_torch.ops.rope import rope_tables
    from hudiff_tpu_torch.tools import fused_layer_probe as FL
    heads, B, L, att = FL.HEADS, 64, FL.L, FL.ATT
    out = {}
    cos, sin = rope_tables(att // heads, L, device=dev)
    scale = (att // heads) ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split('.')[-1]
        x, wqkv, bqkv, wout, bout = k8_check_inputs(torch, B, dev, dtype)
        w_hm, b_hm = FL.column_blocked_to_head_major(wqkv, bqkv, heads)
        before = FL.launches
        y = FL.fused_layer(x, wqkv, bqkv, wout, bout, cos, sin, scale, heads)
        per_call = FL.launches - before
        again = FL.fused_layer(x, wqkv, bqkv, wout, bout, cos, sin, scale, heads)
        ref = FL.fused_layer_reference(x, wqkv, bqkv, wout, bout, cos, sin, scale, heads)
        cur = FL.current_layer(x, w_hm, b_hm, wout, bout, cos, sin, scale, heads)
        torch.cuda.synchronize()
        diff = (y.float() - ref.float()).abs()
        peak = ref.float().abs().max().item()
        held = (diff - (BF16_RTOL * ref.float().abs() if dtype == torch.bfloat16 else 0)).max()
        rel = ((y.float() - cur.float()).abs().max() / cur.float().abs().max()).item()
        # the plain version against the production split: how far two routes
        # to the same function lie apart without K8 (reported, not held)
        floor = ((ref.float() - cur.float()).abs().max() / cur.float().abs().max()).item()
        # what the check can see: the plain version without the rotation
        # and with a uniform softmax (scale 0), as fractions of max |ref|
        moved = {}
        for what, tables, s in (('without_rope', (torch.ones_like(cos), torch.zeros_like(sin)),
                                 scale), ('uniform_softmax', (cos, sin), 0.0)):
            other = FL.fused_layer_reference(x, wqkv, bqkv, wout, bout, *tables, s, heads)
            moved[what] = ((other.float() - ref.float()).abs().max() / peak).item()
            del other
        rec = {'phase': 'K8', 'inputs': 'k8_check_inputs', 'B': B, 'L': L,
               'd_model': FL.D_MODEL, 'att': att, 'heads': heads, 'dtype': name,
               'max_abs_err': diff.max().item(), 'max_abs_ref': peak,
               'held_over_max_ref': held.item() / peak, 'tol_over_max_ref': K8_TOL[name],
               'rel_err_vs_current': rel, 'rel_err_tol': K8_REL_ERR[name],
               'plain_rel_err_vs_current': floor, 'plain_moves_over_max_ref': moved,
               'repeat_identical': torch.equal(y, again), 'launches_per_call': per_call}
        if dtype == torch.bfloat16:
            rec.update(excess_over_rtol=held.item(), rtol=BF16_RTOL)
        ok = held.item() <= K8_TOL[name] * peak and bool(torch.isfinite(y).all().item())
        emit(rec)
        if not (ok and rel <= K8_REL_ERR[name] and rec['repeat_identical'] and per_call == 2):
            fail(f'K8 fails its checks ({name})')
        out[name] = rec
        del x, y, again, ref, cur, diff
        torch.cuda.empty_cache()

    reset_counters()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        FL.main([])
    launched = counters()
    probe = json.loads(buf.getvalue().strip().splitlines()[-1])
    rec = {'phase': 'K8_probe_cli', **probe, 'launches': launched,
           'rel_err_tol': K8_REL_ERR['bfloat16']}
    if launched['K8'] <= 0 or not probe['rel_err'] <= K8_REL_ERR['bfloat16']:
        emit(rec)
        fail(f'the probe CLI: launches {launched}, rel_err {probe["rel_err"]}')
    out['launches'] = launched['K8']

    x, wqkv, bqkv, wout, bout, cos, sin, scale = FL.probe_inputs(B, dev, torch.bfloat16)

    def fused():
        return FL.fused_layer(x, wqkv, bqkv, wout, bout, cos, sin, scale, heads)

    def composed():
        q, k, v = (torch.matmul(x, wqkv) + bqkv).split(att, dim=-1)
        o = F.scaled_dot_product_attention(
            *_rotated_bhld(torch, q, k, v, cos, sin, heads), scale=scale)
        return torch.matmul(o.transpose(1, 2).reshape(*x.shape[:2], att), wout) + bout

    rec['ms'] = probe['fused_ms']
    rec['plain_ms'] = time_ms(torch, lambda: FL.fused_layer_reference(
        x, wqkv, bqkv, wout, bout, cos, sin, scale, heads), reps=2, windows=3)
    rec['library_ms'] = time_ms(torch, composed)
    rec['library'] = 'composition: torch.matmul, RoPE in torch, SDPA, torch.matmul'
    # read x and the weights once, write y once; the two projections and
    # QK^T, PV
    nbytes = (2 * x.numel() + wqkv.numel() + bqkv.numel() + wout.numel()
              + bout.numel()) * x.element_size() + 2 * cos.numel() * 4
    flops = (2.0 * B * L * FL.D_MODEL * 3 * att + 4.0 * B * heads * L * L * (att // heads)
             + 2.0 * B * L * att * FL.D_MODEL)
    rec['bound_ms'], rec['bound_by'] = bound_ms(nbytes, flops, 'bfloat16')

    # device time of each of the two kernels over three calls, between
    # stretches of cuBLAS work: in a window that starts or ends with them,
    # the profiler missed one or two of the K8 kernels (on an H100 it saw 4
    # and 5 of 6)
    def cublas_work():
        for _ in range(50):
            torch.matmul(x, wqkv)

    def window():
        cublas_work()
        torch.cuda.synchronize()
        reset_counters()
        for _ in range(3):
            fused()
        cublas_work()
        torch.cuda.synchronize()

    counted, (_, seen, top), rec['profiler'] = profiled(torch, window, 3)
    rec['kernels'] = [{'kernel': t['kernel'][:60], 'calls': t['calls'],
                       'ms_per_call': t['ms_per_repeat']}
                      for t in top if 'fused_layer_' in t['kernel']]
    emit(rec)
    if counted != seen or seen['K8'] != 6:
        fail(f'K8: launch counters {counted} != kernels the profiler saw {seen}')
    out['probe'] = rec
    k8_build_records(torch, rec, L)
    return out


def k8_build_records(torch, probe, L):
    """K8's kernels as built and as they ran, one record each: the device ms
    of each kernel (the probe phase's profiler window), the shared memory a
    block and the blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers and spills (nvcc -Xptxas -v), and the HGMMA (wgmma) and
    UTMALDG (TMA load) instructions of each kernel in the built library. The
    bf16 kernels rest on wgmma: the phase fails without HGMMA in them."""
    from hudiff_tpu_torch.ops import _build
    from hudiff_tpu_torch.tools import fused_layer_probe as FL
    emit({'phase': 'K8_kernel_ms', 'B': 64, 'L': L, 'dtype': 'bfloat16',
          'kernels': probe['kernels'], 'ms': probe['ms'], 'bound_ms': probe['bound_ms']})
    emit({'phase': 'K8_occupancy', 'L': L,
          'sms': torch.cuda.get_device_properties(0).multi_processor_count,
          'bfloat16': FL.kernel_occupancy(L, torch.bfloat16),
          'float32': FL.kernel_occupancy(L, torch.float32)})
    regs = ptxas_registers({'fused_layer': _build.BUILD_LOGS['fused_layer']}
                           if 'fused_layer' in _build.BUILD_LOGS else {})
    emit({'phase': 'K8_registers',
          'kernels': [{'kernel': k, 'registers': r, 'spill_store_bytes': st,
                       'spill_load_bytes': ld} for k, r, st, ld in regs.get('fused_layer', [])]
          or 'not measured (library built by an earlier process)'})
    sass = sass_counts(_build.library_path('fused_layer'))
    bf16 = {k: sass.get(k) for k in FL.KERNEL_NAMES[torch.bfloat16]}
    emit({'phase': 'K8_sass', 'kernels': sass})
    if any(c is None or c['HGMMA'] == 0 for c in bf16.values()):
        fail(f'K8: the bf16 kernels hold no wgmma (HGMMA) instruction: {bf16}')


def later_kernels(results, api):
    """The kernels line's entries for K5-K8."""
    k5, k5_f32 = results['K5'][(MAIN_B, 'bfloat16')], results['K5'][(MAIN_B, 'float32')]
    k6, k6_f32 = results['K6'][(TRAIN_B, 'bfloat16')], results['K6'][(TRAIN_B, 'float32')]
    k7 = results['K7']['records'][(MAIN_B, 'bfloat16')]
    k7_f32 = results['K7']['records'][(MAIN_B, 'float32')]
    k8, k8_f32 = results['K8']['bfloat16'], results['K8']['float32']
    probe = results['K8']['probe']

    def entry(rec, rec_f32, timed=None, **kw):
        timed = timed or rec
        return {**kw, 'max_abs_err': rec['max_abs_err'],
                'excess_over_rtol': rec['excess_over_rtol'],
                'max_abs_err_f32': rec_f32['max_abs_err'], 'ms': timed['ms'],
                'plain_ms': timed['plain_ms'], 'bound_ms': timed['bound_ms'],
                'bound_by': timed['bound_by'], 'library_ms': timed['library_ms']}

    return [
        entry(k5, k5_f32, name='K5 fused RoPE attention (separate q, k, v)', route='cuda',
              source='hudiff_tpu_torch/csrc/rope_attention.cu',
              replaces='hudiff_tpu/ops/pallas_attention.py:76',
              launches=api['launches']['K5'], launches_per_step=api['launches']['K5'] / api['steps'],
              max_abs_diff_vs_K1=k5['max_abs_diff_vs_K1'],
              shape=f'B={MAIN_B} L=291 H=8 D=64 bf16'),
        entry(k6, k6_f32, name='K6 fused RoPE attention backward (separate dq, dk, dv)',
              route='cuda', source='hudiff_tpu_torch/csrc/rope_attention_bwd.cu',
              replaces='hudiff_tpu/ops/pallas_attention.py:100',
              launches=api['launches']['K6'], launches_per_step=api['launches']['K6'] / api['steps'],
              ms_standalone=k6['ms_standalone'],
              shape=f'B={TRAIN_B} L=291 H=8 D=64 bf16, one call given K5\'s residuals (three '
                    'kernels); ms_standalone runs K5 for them first'),
        entry(k7, k7_f32, name='K7 softmax attention without RoPE ([B, H, L, D])', route='cuda',
              source='hudiff_tpu_torch/csrc/rope_attention.cu',
              replaces='hudiff_tpu/ops/pallas_attention.py:443',
              launches=results['K7']['launches'], shape=f'B={MAIN_B} H=8 L=291 D=64 bf16'),
        entry(k8, k8_f32, probe, name='K8 fused attention layer (qkv projection, RoPE '
                                      'attention, out projection)', route='cuda',
              source='hudiff_tpu_torch/csrc/fused_layer.cu',
              replaces='tools/fused_layer_probe.py:34', launches=results['K8']['launches'],
              launches_per_call=k8['launches_per_call'], library=probe['library'],
              current_ms=probe['current_ms'], speedup=probe['speedup'],
              rel_err_vs_current=probe['rel_err'], kernel_ms=probe['kernels'],
              shape='B=64 L=291 d_model=768 att=512 H=8 bf16, one call (two kernels); '
                    'errors on k8_check_inputs, times on the probe\'s weights')]


if __name__ == '__main__':
    sys.exit(main())
