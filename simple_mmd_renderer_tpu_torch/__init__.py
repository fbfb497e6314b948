"""PyTorch + CUDA port of simple_mmd_renderer_tpu for NVIDIA Hopper.

The JAX package `simple_mmd_renderer_tpu` is the reference; this package
mirrors its layout (`core/`, `formats/`, `models/`, `ops/`, `render/`,
`utils/`) and function names. Plain tensor code is PyTorch; the
reference's Pallas kernels on the main path are hand-written CUDA kernels
under `csrc/`, built with nvcc at first use (`ops/_build.py`). Every
kernel wrapper runs its plain PyTorch version for CPU tensors and launches
the kernel for CUDA tensors.

This package imports neither JAX nor anything of `simple_mmd_renderer_tpu`:
it keeps its own copies of the host modules it needs (`formats/pmx.py`,
`formats/pmd.py`, `formats/vmd.py`, `formats/vpd.py`, `formats/writers.py`,
`utils/io.py`, `config.py`, `app/sample.py` and the dataclasses of
`core/model.py`). Its entry points
run on the card unless the caller passes `device="cpu"`
(`utils/device.py`).

Float32 everywhere the reference is float32: TF32 is switched off for
matmuls and convolutions, so skinning, the physics incidence matmuls and the
camera matrices round like the reference.
"""

import torch

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
