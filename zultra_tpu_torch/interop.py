"""Stage state carried between the JAX package and the port.

The system has no weights; what crosses between the two packages is the
state one stage hands the next: window stacks (uint8), match tables
(uint16 lengths/offsets), greedy token marks (bool), histograms and code
lengths (int32), and plan dicts (packed uint32 token words). The port
computes in int32/int64 tensors because PyTorch's unsigned types are
thin; these helpers convert at the numpy boundary in both directions, so
a test can feed one package's stage output into the other's next stage.
"""

from __future__ import annotations

import numpy as np
import torch

# numpy dtype -> the port's tensor dtype
_TO_TORCH = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint16): torch.int32,
    np.dtype(np.int16): torch.int32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.int64): torch.int64,
}

# state keys whose numpy form (the JAX package's dtype) differs from the
# port's tensor dtype
NUMPY_DTYPES = {
    "lens": np.uint16,
    "offs": np.uint16,
    "words": np.uint32,
}


def state_from_numpy(state: dict, device) -> dict:
    """{name: numpy array} -> {name: tensor on ``device``} in the port's
    dtypes (uint16 and uint32 widen to int32 and int64)."""
    out = {}
    for name, arr in state.items():
        arr = np.asarray(arr)
        dtype = _TO_TORCH.get(arr.dtype)
        if dtype is None:
            raise TypeError(f"{name}: no port dtype for numpy {arr.dtype}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dtype)
    return out


def state_to_numpy(state: dict) -> dict:
    """{name: tensor} -> {name: numpy array}, narrowing the keys in
    NUMPY_DTYPES back to the JAX package's unsigned dtypes (values are
    range-checked, never wrapped)."""
    out = {}
    for name, t in state.items():
        arr = t.detach().cpu().numpy()
        want = NUMPY_DTYPES.get(name)
        if want is not None:
            info = np.iinfo(want)
            if arr.size and (arr.min() < info.min or arr.max() > info.max):
                raise ValueError(f"{name}: values outside {np.dtype(want).name}")
            arr = arr.astype(want)
        out[name] = arr
    return out
