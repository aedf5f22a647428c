# Copied from hudiff_tpu/training/logger.py (run dirs, logging, seeding).
"""Run directories, file+stream logging and global seeding."""
from __future__ import annotations

import logging
import os
import random
import time
from typing import Optional

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
