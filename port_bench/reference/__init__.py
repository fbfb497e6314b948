"""The benchmark's plain reference of the renderer.

A frozen copy of the plain PyTorch paths of `simple_mmd_renderer_tpu_torch`
(its CPU path): the PMX/VMD/HDR readers and writers, the model, motion and
physics tables, the step (motion sampling, morphs, FK, CCD IK, physics,
skinning) and the render (shadow map, the ground's PCF, the tiled raster's
plain versions with the MSAA resolve, textures, skybox, shading). Every
hand-written kernel's dispatch runs its plain version on every device, and
nothing is captured into a CUDA graph. It imports nothing of the program, so
no later change to the program changes it.

Float32 throughout with TF32 off, as the program's configuration states;
`tf32(True)` switches matmuls and convolutions to TF32 for the control.
"""

import contextlib

import torch

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def tf32(on: bool):
    """Matmuls and convolutions in TF32 (`on`) or float32 for the body."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
