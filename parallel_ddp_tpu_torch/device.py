"""Where the port's entry points put the tensors they make.

The port runs on the card.  An entry point that builds tensors from
non-tensor input (lists, numpy arrays) and is given no `device` puts them on
`default_device()`, which raises when no CUDA device is visible: it never
falls back to the CPU.  A caller who wants the CPU says so (`device="cpu"`,
or by passing CPU tensors): a tensor that is passed in keeps its device.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """`cuda:0`, or a RuntimeError when no CUDA device is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: parallel_ddp_tpu_torch runs on the GPU "
            "by default; pass device=\"cpu\" (or CPU tensors) to run on the CPU")
    return torch.device("cuda:0")


def as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """`a` as a tensor: a tensor keeps its device unless `device` names
    another; anything else goes to `device`, or to `default_device()`."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=dtype, device=device)
    return torch.as_tensor(a, dtype=dtype,
                           device=default_device() if device is None else device)
