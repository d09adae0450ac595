"""Device choice for the package's entry points.

Every entry point takes ``device`` (default ``"cuda"``). A CUDA device that
is not there is an error, never a silent move to the CPU; ``"cpu"`` runs the
plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
from . import errors


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise errors.IncorrectUseError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions")
    elif dev.type != "cpu":
        raise errors.IncorrectUseError(f"unsupported device {device!r}")
    return dev


def upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on `dev` (on the CPU, sharing its memory).
    To a card it goes through pinned memory without a synchronise, so a
    loop that launches work on the card keeps launching."""
    t = torch.from_numpy(arr)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def to_host(t: torch.Tensor):
    """A tensor's values on the host: from a card, one blocking
    device-to-host read. A 0-d tensor comes back as a Python number
    (item(), the cheaper read), any other as a numpy array. Every such read
    of the codec paths goes through here, counted as d2h.calls."""
    trace.count("d2h.calls")
    return t.item() if t.dim() == 0 else t.cpu().numpy()
