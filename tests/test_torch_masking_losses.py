"""Port ops/masking.py and ops/losses.py against the JAX package.

Masks: ``mask_from_scores`` fed the uniform scores ``jax.random.uniform``
drew gives exactly the JAX package's ``random_subset_mask``; masks drawn
from torch's generator are held to the OA-ARDM invariants (torch cannot
replay JAX's draws). Losses: the same numpy logits, targets and masks
through both packages, f32, atol 1e-6 (the same reductions in other
orders).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hudiff_tpu.ops import losses as JL
from hudiff_tpu.ops import masking as JM
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.ops import losses as L
from hudiff_tpu_torch.ops import masking as M

CDR_ROW = np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX])


@pytest.mark.parametrize('window', [None, 150])
def test_mask_from_jax_scores_matches_jax_mask_exactly(window):
    B, Lg = 6, C.PAIR_LEN
    key = jax.random.PRNGKey(11)
    D = window or Lg
    counts = np.array([1, 2, D // 2, D - 1, D, 7])
    ref = np.asarray(JM.random_subset_mask(key, B, Lg, jnp.asarray(counts), window=window))
    scores = np.array(jax.random.uniform(key, (B, Lg)))
    out = M.mask_from_scores(torch.from_numpy(scores), torch.from_numpy(counts), window)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.sum(-1).numpy(), counts)


def test_corrupt_invariants():
    rs = np.random.RandomState(0)
    B, Lg = 64, C.PAIR_LEN
    tokens = torch.from_numpy(rs.randint(0, C.N_AA, (B, Lg)))
    tokens[:, 5] = C.IDX_PAD
    protected = M.pair_protected_mask(tokens, torch.from_numpy(CDR_ROW), protect_pads=True)
    assert protected[:, 5].all() and protected[:, CDR_ROW != 0].all()
    cor = M.corrupt(torch.Generator().manual_seed(3), tokens, protected)
    # the same seed replays corrupt's draws: the counts first, then the scores
    gen = torch.Generator().manual_seed(3)
    counts = M.sample_mask_counts(gen, B, Lg)
    full = M.random_subset_mask(gen, B, Lg, counts)
    assert ((counts >= 2) & (counts <= Lg)).all()           # D - t + 1, t in [1, D-1]
    np.testing.assert_array_equal(full.sum(-1).numpy(), counts.numpy())
    np.testing.assert_array_equal(cor.mask.numpy(), (full & ~protected).numpy())
    assert not (cor.mask & protected).any()                 # protected never masked
    assert ((cor.src == C.IDX_MSK) == cor.mask).all()       # <msk> exactly on the mask
    assert (cor.src[~cor.mask] == tokens[~cor.mask]).all()
    np.testing.assert_array_equal(cor.num_masked.numpy(), cor.mask.sum(-1).numpy())


def _loss_inputs(seed, B=4):
    rs = np.random.RandomState(seed)
    logits = rs.randn(B, C.PAIR_LEN, C.N_TOKENS).astype(np.float32)
    targets = rs.randint(0, C.N_AA, (B, C.PAIR_LEN))
    mask = rs.rand(B, C.PAIR_LEN) < 0.5 + 0.5 * rs.rand(B, 1)
    mask[0] = False                                   # an empty row: t clamps at 1
    cdr = np.broadcast_to(CDR_ROW != 0, mask.shape)
    return logits, targets, mask & ~cdr, cdr


def _check(out, ref):
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-6,
                                   err_msg=k)


def _both(args):
    return ([torch.from_numpy(np.ascontiguousarray(a)) for a in args],
            [jnp.asarray(a) for a in args])


@pytest.mark.parametrize('reweight', [True, False])
@pytest.mark.parametrize('name', ['pair_oardm_loss', 'heavy_oardm_loss'])
def test_merged_losses_match(name, reweight):
    logits, targets, mask, cdr = _loss_inputs(1)
    if name == 'heavy_oardm_loss':
        logits, targets, mask, cdr = (a[:, :C.HEAVY_LEN] for a in (logits, targets, mask, cdr))
    t, j = _both((logits, targets, mask, cdr))
    _check(getattr(L, name)(*t, reweight=reweight), getattr(JL, name)(*j, reweight=reweight))


@pytest.mark.parametrize('reweight', [True, False])
def test_split_loss_matches(reweight):
    t, j = _both(_loss_inputs(2))
    _check(L.pair_oardm_split_loss(*t, l_weight=3.0, reweight=reweight),
           JL.pair_oardm_split_loss(*j, l_weight=3.0, reweight=reweight))


def test_split_loss_reweights_both_chains_by_the_combined_count():
    """The quirk kept from the reference: each chain's Hoogeboom weight is
    its own padded length over the COMBINED H+L masked count."""
    logits, targets, mask, cdr = _loss_inputs(3)
    t, _ = _both((logits, targets, mask, cdr))
    ce = L.token_ce(t[0], t[1])
    tot = t[2].sum(-1).clamp(min=1).float()[:, None]
    h = L.masked_mean(ce[:, :C.HEAVY_LEN] * C.HEAVY_LEN / tot, t[2][:, :C.HEAVY_LEN])
    out = L.pair_oardm_split_loss(*t)
    np.testing.assert_allclose(out['h_ce'].item(), h.item(), rtol=1e-6)


@pytest.mark.parametrize('reconstruct', [False, True])
def test_nano_finetune_ce_matches(reconstruct):
    logits, targets, mask, cdr = (a[:, :C.HEAVY_LEN] for a in _loss_inputs(4))
    t, j = _both((logits, targets, mask, cdr))
    _check(L.nano_finetune_ce(t[0], t[1], t[3], t[2], reconstruct=reconstruct),
           JL.nano_finetune_ce(j[0], j[1], j[3], j[2], reconstruct=reconstruct))


def test_token_ce_and_accuracy_match():
    logits, targets, mask, _ = _loss_inputs(5)
    t, j = _both((logits, targets, mask))
    np.testing.assert_allclose(L.token_ce(t[0], t[1]).numpy(),
                               np.asarray(JL.token_ce(j[0], j[1])), rtol=0, atol=1e-6)
    np.testing.assert_allclose(L.masked_accuracy(*t).item(),
                               float(JL.masked_accuracy(*j)), rtol=0, atol=1e-6)
