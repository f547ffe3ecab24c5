"""Shared set-up for the orthosfm_torch parity tests (tests/test_torch_*.py).

The Tier-1 gate runs several pytest workers on one machine, so each test
process caps torch's intra-op threads. The helpers convert the JAX package's
inputs and outputs to torch through numpy, casting floats to f32.
"""

import numpy as np
import torch

torch.set_num_threads(2)


def t(x, dtype=None):
    """A torch (CPU) tensor holding a copy of the array x."""
    a = np.array(x)
    if dtype is None and a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a if dtype is None else a.astype(dtype))


def n(x):
    """A numpy copy of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
