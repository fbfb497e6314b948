"""The device an entry point runs on.

Every entry point that takes `device` (`Scene`, `build_sample_scene`,
`ModelTables`, `PhysicsTables`, `MotionTables`) runs on the card unless the
caller asks for another device: the default is "cuda", and a CUDA device
that is not there is an error naming the argument, never a silent move to
the CPU. Tests and CPU runs pass `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` (None: the card) as a torch.device; a CUDA device with no
    card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r}: no CUDA device is available (pass "
            "device='cpu' to run on the CPU)")
    return dev
