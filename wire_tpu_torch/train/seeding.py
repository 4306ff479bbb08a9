"""Global determinism helper (port of wire_tpu/train/seeding.py): seeds
Python's, numpy's and torch's streams and returns a ``torch.Generator``
seeded alike, which stands where wire_tpu returns its root PRNG key."""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 0) -> torch.Generator:
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
