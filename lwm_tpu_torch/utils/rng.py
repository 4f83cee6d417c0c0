"""Seeds of the trainer (`lwm_tpu/utils/rng.py:47-62`).

JAX threads explicit PRNG keys; the port seeds Python's, numpy's and
torch's global generators once and hands the weight init its own
`torch.Generator`. A JAX init and a torch init from one seed draw different
numbers: to start both packages from the same weights, save them once and
load them with `--load_checkpoint=params::PATH`.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def init_generator(seed, device):
    """The generator `LLaMAForCausalLM.init_weights` draws from, on `device`."""
    return torch.Generator(device=torch.device(device)).manual_seed(seed)
