"""A run's inputs, made from its seed: the character as a PMX file, the
dance as a VMD file, the sky as an HDR file and the part textures.

The configuration fixes each of them by a block that names its generator,
`<module>.<function>` of `gen/<module>.py` (a new generator is a new
file), and gives the generator's keyword arguments: the
character (its mesh, bones, bodies), the part textures, the motion (its
length and key spacing) and the sky. A generator that takes `rng` gets the
seed's generator: the seed draws the dance's curves and, after them, the
frame playback starts at (from the traffic's `start_frame` range). The files
are written under the run's TMPDIR and read back by the program's own
readers (and by the reference's); the textures go to both sides as arrays.
"""

from __future__ import annotations

import importlib
import inspect
import os
import shutil
import tempfile
from dataclasses import dataclass

import numpy as np

from .reference.formats.hdr import write_hdr
from .reference.formats.writers import write_pmx


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of `seed` (any whole number, negative or above 2**63
    too) for one use of it (`stream`)."""
    return np.random.default_rng([seed % 2 ** 64, stream])


def generate(block: dict, rng: np.random.Generator):
    """What the block's `generator` makes from the block's other keys (an
    unknown key is the generator's TypeError), with `rng` where the
    generator takes one."""
    kwargs = {k: v for k, v in block.items() if k != "generator"}
    module, name = block["generator"].rsplit(".", 1)
    fn = getattr(importlib.import_module(f"{__package__}.gen.{module}"), name)
    if "rng" in inspect.signature(fn).parameters:
        kwargs["rng"] = rng
    return fn(**kwargs)


@dataclass
class Inputs:
    directory: str          # where the files lie
    pmx: str
    vmd: str
    hdr: str | None
    textures: list | None   # [h, w, 3] float32 arrays on the 8-bit grid
    start_frame: int
    triangles: np.ndarray   # [T, 3] the mesh as written

    def remove(self) -> None:
        shutil.rmtree(self.directory, ignore_errors=True)


def make_inputs(config: dict, traffic: dict, seed: int) -> Inputs:
    rng = rng_of(seed)
    pm = generate(config["character"], rng)
    vmd = generate(config["motion"], rng)
    lo, hi = traffic["start_frame"]
    start = int(rng.integers(lo, hi))
    directory = tempfile.mkdtemp(prefix="port_bench_inputs_")
    paths = {k: os.path.join(directory, f"sample.{k}")
             for k in ("pmx", "vmd", "hdr")}
    with open(paths["pmx"], "wb") as f:
        f.write(write_pmx(pm))
    with open(paths["vmd"], "wb") as f:
        f.write(vmd)
    sky = config.get("sky")
    if sky:
        write_hdr(paths["hdr"], generate(sky, rng))
    textures = (generate(config["textures"], rng)
                if config.get("textures") else None)
    return Inputs(directory, paths["pmx"], paths["vmd"],
                  paths["hdr"] if sky else None, textures, start,
                  np.asarray(pm.triangles, np.int32))
