# Copied from hudiff_tpu/training/logger.py.
"""Run directories, file+stream logging, global seeding, the source
snapshot, per-iteration JSONL metrics and the parameter count.

``MetricsWriter`` writes the JSONL rows the JAX package's writes
(``{"step": it, "<prefix>/<name>": value, ...}``); the JSONL file is the
record, and there is no TensorBoard mirror.
"""
from __future__ import annotations

import json
import logging
import os
import random
import shutil
import time
from typing import Dict, Optional

import numpy as np


def get_new_log_dir(root: str = './logs', prefix: str = '', tag: str = '') -> str:
    fn = time.strftime('%Y_%m_%d__%H_%M_%S', time.localtime())
    if prefix:
        fn = prefix + '_' + fn
    if tag:
        fn = fn + '_' + tag
    log_dir = os.path.join(root, fn)
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def seed_all(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)


def get_logger(name: str, log_dir: Optional[str] = None,
               log_name: str = 'log.txt') -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    if logger.handlers:
        return logger
    fmt = logging.Formatter('[%(asctime)s::%(name)s::%(levelname)s] %(message)s')
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir is not None:
        fh = logging.FileHandler(os.path.join(log_dir, log_name))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def snapshot_source(log_dir: str) -> None:
    """Copy the port's source into the run dir."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(log_dir, 'src_snapshot', 'hudiff_tpu_torch')
    if not os.path.exists(dst):
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns('__pycache__'))


class MetricsWriter:
    """JSONL scalar writer: one row per ``write``."""

    def __init__(self, log_dir: str, filename: str = 'metrics.jsonl'):
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, 'a')

    def write(self, step: int, scalars: Dict[str, float], prefix: str = '') -> None:
        row = {'step': int(step)}
        for k, v in scalars.items():
            row[f'{prefix}/{k}' if prefix else k] = float(v)
        self._f.write(json.dumps(row) + '\n')
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def count_parameters(model) -> int:
    return sum(p.numel() for p in model.parameters())
