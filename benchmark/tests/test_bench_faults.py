"""Each fault that a cell can have (``benchmark/faults.py``), planted under a
run that skips the look for a chip, turns ``correct`` false; the same run
without it stays correct, at a size the CPU can hold (``bench_tiny``),
held to the cells' limits."""
import pytest

from bench_tiny import run, tiny_cell

from benchmark import faults as FL

HUMANIZE = ['ab_humanize_packed', 'nb_humanize_single']
TRAIN, FINETUNE = 'ab_pretrain_b128', 'nb_finetune_b512'


@pytest.mark.parametrize('name', HUMANIZE + [TRAIN, FINETUNE])
def test_sound_run_is_correct(name):
    assert run(tiny_cell(name))['correct'] is True


@pytest.mark.parametrize('name', HUMANIZE)
def test_altered_token_is_caught(name):
    with FL.altered_token():
        r = run(tiny_cell(name))
    assert r['correct'] is False and r['check']['gap_max']['value'] > 1.0


@pytest.mark.parametrize('fault', ['dropped_candidate', 'skipped_filter'])
def test_filter_fault_is_caught(fault):
    with FL.FAULTS[fault]():
        r = run(tiny_cell('nb_humanize_single'))
    assert r['correct'] is False and r['check']['filter_faults']['value'] >= 1


@pytest.mark.parametrize('cell, fault, number', [
    (TRAIN, 'unchanged_state', 'change_gap_p95'), (TRAIN, 'half_batch', 'loss_gap'),
    (TRAIN, 'no_dropout', 'dropout_share_gap'),
    (FINETUNE, 'unchanged_state', 'change_gap_median'),
    (FINETUNE, 'half_batch_finetune', 'dropout_share_gap'),
    (FINETUNE, 'no_dropout', 'dropout_share_gap')])
def test_training_fault_is_caught(cell, fault, number):
    with FL.FAULTS[fault]():
        r = run(tiny_cell(cell))
    assert r['correct'] is False
    assert r['check'][number]['value'] > r['check'][number]['limit']
