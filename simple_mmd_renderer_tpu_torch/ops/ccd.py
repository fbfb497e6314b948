"""The CCD solve of one IK group on the card (`csrc/ccd.cu`).

`core.pose._solve_ik_group` is the dispatcher: a CPU tensor runs the plain
loop `pose.solve_ik_group_plain`, a CUDA tensor launches `smr_ccd` here,
once a group, one block with a thread a chain (captured or eager alike:
the kernel runs every iteration with converged chains frozen, so the eager
call reads nothing on the host). Both give the same bits on the card.

The plain loop's 4x4 products (`@`) and its einsum go through cuBLAS,
which picks its kernel, and with it the order of each dot product's
roundings, by the batch (the group's chains G): on the H100 the product
is one chain of FMAs at G >= 2 and two halves at G = 1, and the einsum
(a batched gemv) takes four different orders between G = 1 and 4096.
`orders(device, g)` finds them on the device: it runs the plain loop's own
calls at batch g on fixed samples, and `smr_ccd_orders` writes the codes of
the candidate orders (`dot4`, `dot3` in the source) that reproduce every
answer; the solve reads them there, and stops the card (a trap, so the
next synchronisation raises) where no candidate does. Found once per device
and batch, with no host read, so the first call may come in a capture's
eager warm-up (`utils/graph.CapturedStep`), and not inside the capture.

The kernel solves the group in one block, its chains in lockstep, as the
plain loop's batched operations do (`csrc/ccd.cu`), so chains that read
each other's bones through an append parent get the plain loop's bits too.
"""

from __future__ import annotations

import torch

from . import _build

# launches of the CUDA kernel since the last reset (a plain counter: a run
# shows the step went through the kernel)
launches = 0

# the samples `orders` runs at a batch: wrong candidates agree with cuBLAS
# on one sample's products often, on all of them practically never
SAMPLES = 16

# (device, g) -> int32 [2] on the device: the 4x4 product's and the
# einsum's order codes
_orders: dict = {}


def _samples(g: int, device):
    """SAMPLES fixed pairs of [g, 4, 4] matrices and [g, 3] vectors (no
    generator: the values come from `sin` of their indices), each its own
    allocation, as the plain loop's operands are."""
    out = []
    for s in range(SAMPLES):
        i = torch.arange(g * 16, dtype=torch.float32, device=device)
        a = torch.sin(i * 0.7311 + (1.37 * s + 0.1)) * 3.0
        b = torch.sin(i * 1.9107 + (0.59 * s + 0.7)) * 3.0
        j = torch.arange(g * 3, dtype=torch.float32, device=device)
        v = torch.sin(j * 2.3013 + (0.83 * s + 0.3))
        out.append((a.reshape(g, 4, 4), b.reshape(g, 4, 4), v.reshape(g, 3)))
    return out


def _find_orders(g: int, device) -> torch.Tensor:
    a_s, b_s, ab_s, v_s, av_s = [], [], [], [], []
    for a, b, v in _samples(g, device):
        a_s.append(a)
        b_s.append(b)
        ab_s.append(a @ b)
        v_s.append(v)
        av_s.append(torch.einsum("gji,gj->gi", a[:, :3, :3], v))
    codes = torch.empty((2,), dtype=torch.int32, device=device)
    stack = [torch.stack(t) for t in (a_s, b_s, ab_s, v_s, av_s)]
    rc = _build.entry("smr_ccd_orders")(
        *[t.data_ptr() for t in stack], SAMPLES * g, codes.data_ptr(),
        _build.stream_ptr(device))
    _build.check(rc, "smr_ccd_orders")
    return codes


def orders(device, g: int) -> torch.Tensor:
    """int32 [2] on `device`: the order codes of cuBLAS's 4x4 product and
    einsum at batch g (-1 where no candidate reproduces it). Found at the
    first call for the batch, which may not come inside a capture."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    key = (device, g)
    codes = _orders.get(key)
    if codes is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"ccd: the cuBLAS orders at batch {g} are found outside a "
                "capture: run the step once before capturing it")
        codes = _orders[key] = _find_orders(g, device)
    return codes


def primitive(which: str, x, y=None, code: int = 0):
    """One of the kernel's primitives on CUDA tensors, for the checks
    against torch: "sum3" ([n, 3] -> [n]), "sum4" ([n, 4] -> [n]), "norm3"
    ([n, 3] -> [n]), "cross" ([n, 3] x [n, 3]), "mm4" ([n, 4, 4] @ [n, 4,
    4] in order `code`), "rotate_t" ([n, 4, 4]'s 3x3 block transposed
    times [n, 3], order `code`)."""
    kinds = ("sum3", "sum4", "norm3", "cross", "mm4", "rotate_t")
    k = kinds.index(which)
    x = x.contiguous()
    y = x if y is None else y.contiguous()
    n = x.shape[0]
    shape = {0: (n,), 1: (n,), 2: (n,), 3: (n, 3), 4: (n, 4, 4),
             5: (n, 3)}[k]
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    rc = _build.entry("smr_ccd_primitive")(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), n, k, code,
        _build.stream_ptr(x.device))
    _build.check(rc, "smr_ccd_primitive")
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def solve_ik_group_cuda(static, world, total_rot, total_trans, pre_ik_rot,
                        ik_rot, seg, anim_rot, anim_trans, morph_rot,
                        morph_trans, actives=None):
    """One launch of `smr_ccd` for the IK group `seg` (an `IKSegment` or
    its crowd view) on the pose's fields -> (world, total_rot,
    total_trans, pre_ik_rot, ik_rot), new tensors (the inputs are left as
    they are). `actives` (bool [seg.loop * G], or None) receives each
    iteration's active chains."""
    g = seg.links.shape[0]
    if actives is not None and actives.numel() != seg.loop * g:
        raise ValueError(f"ccd: actives has {actives.numel()} flags, the "
                         f"group needs {seg.loop * g}")
    out = [t.clone(memory_format=torch.contiguous_format)
           for t in (world, total_rot, total_trans, pre_ik_rot, ik_rot)]
    launch(static, out, seg, [t.contiguous() for t in (
        anim_rot, anim_trans, morph_rot, morph_trans)], actives)
    return tuple(out)


# floats of the kernel's scratch a chain (`kWs` in the source)
WS = 16


def launch(static, fields, seg, inputs, actives=None, clocks=None) -> None:
    """`smr_ccd` on contiguous tensors, in place: `fields` (world,
    total_rot, total_trans, pre_ik_rot, ik_rot), `inputs` (anim_rot,
    anim_trans, morph_rot, morph_trans). `clocks` (int64 [6], or None)
    receives the block's %globaltimer (ns) and clock64 (cycles) at its
    start, after the pre-loop FK and at its end."""
    global launches
    g = seg.links.shape[0]
    tables = [static.bone_parent, static.append_parent, static.append_ratio,
              static.append_rotate, static.append_translate,
              static.is_ik_link, static.local_offset]
    group = [seg.links, seg.link_parent_safe, seg.link_has_parent,
             seg.targets, seg.goal_bones, seg.angle_limit, seg.limits_min,
             seg.limits_max, seg.codes]
    codes = orders(fields[0].device, g)
    ws = torch.empty((g, WS), dtype=torch.float32, device=fields[0].device)
    rc = _build.entry("smr_ccd")(
        *[t.data_ptr() for t in tables + list(inputs) + list(fields)
          + group], g, seg.n_links, seg.loop, codes.data_ptr(),
        _ptr(actives), ws.data_ptr(), _ptr(clocks),
        _build.stream_ptr(fields[0].device))
    _build.check(rc, "smr_ccd")
    launches += 1
