"""What every traffic kind shares (`kinds/<kind>.py`): the frame's result
on the host, state copies and the window's record.

A traffic kind is how a cell drives the program, frame after frame; its
module `kinds/<kind>.py` defines `Kind`, found by the `kind` of the
traffic file, so that a new kind is a new file. A `Kind` is built from
(scene, cell, inputs, device) and gives `warm()`, `window(seconds)`,
`run_frames(state, n, starts)` (the traced frames) and `end_to_end(window)`
on the program's side, and, as static methods, what the check asks of the
reference: `reference_output(scene, state, pose, positions, normals)`, the
reference's answer to a frame, and `output_numbers([(program's, the
reference's), ...])`, the compared numbers of those answers. It may also
give `raster_bound_s(starts)` (the traced frames' raster bound) and
`reference_start(reference)` (a start state other than the seeked one).

Each kind is closed-loop: the next frame is asked for when the last one
is done, and a frame is done when its result has reached the host.

Every kind keeps the state each frame started from (a copy on the card:
the check replays sampled frames from it) and the frame's result.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .scenes import PROGRAM


def to_host_u8(image):
    """An image [..., H, W, 3] in [0, 1] as 8-bit RGB on the host, as a
    viewer or a video writer receives it (the program's CLI's conversion:
    x * 255 truncated)."""
    return (image.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu()


def clone_state(state):
    from importlib import import_module
    tree_map = import_module(f"{PROGRAM}.utils.graph").tree_map
    return tree_map(torch.clone, state)


@dataclass
class Window:
    frames: int                 # frames completed
    seconds: float              # the window's length on the host clock
    frame_times: list = field(default_factory=list)   # s, play only
    states: list = field(default_factory=list)   # state before frame i
    outputs: list = field(default_factory=list)  # host result of frame i


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def kind_class(name: str):
    """The `Kind` of traffic kind `name` (`kinds/<name>.py`)."""
    from importlib import import_module
    return import_module(f"{__package__}.kinds.{name}").Kind
