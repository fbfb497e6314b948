"""Model families, the port's index of them.

Everything the original app can load, plus the procedural flagship, as the
reference's `simple_mmd_renderer_tpu/models/__init__.py` lists them, each
pointing at the port's own function:

- PMX 2.0 (`load_pmx`) — the primary MMD model format
- PMD 1.0 (`load_pmd`) — the legacy format, converted to the same arrays
- VMD motions (`load_vmd`) incl. camera tracks
- `sample_character` / `sample_motion` — the procedural Miku-scale benchmark
  character (no assets ship with the repo)

`build_model` turns any of the model families into the static rig program
the pose/physics/render stages execute (`core.model.ModelTables` moves it
to a device).
"""

from ..app.sample import sample_character, sample_motion
from ..core.model import ModelStatic, build_model
from ..formats.pmd import load_pmd, parse_pmd
from ..formats.pmx import PmxModel, load_pmx, parse_pmx
from ..formats.vmd import VmdMotion, load_vmd, parse_vmd

__all__ = [
    "ModelStatic", "PmxModel", "VmdMotion", "build_model",
    "load_pmd", "load_pmx", "load_vmd",
    "parse_pmd", "parse_pmx", "parse_vmd",
    "sample_character", "sample_motion",
]
