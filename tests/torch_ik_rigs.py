"""IK rigs for the CCD solve's checks (the plain loop on the CPU, the CUDA
kernel against it on the card), built with the port alone (no JAX, so the
card's tests can import it).

`arm_ik_character(density)` is the sample character of tests/test_torch_pose
with two more IK bones: the right arm reaches for a goal through three
links (elbow, the append-rotated twist bone, arm), the left arm through two
(elbow, arm), each a group of one chain beside the legs' group of two and
the toes'. `ik_rig(variant, ...)` builds its tables with variant
`variant` (0 to N_VARIANTS - 1, or "cross") of the links: every link slot (legs 2,
right arm 3, left arm 2) gets its own fix type, limited flag, Euler order
and limits (`_slot`), so that
across the variants each of the six Euler orders and each fix type occurs
limited and unlimited, in one-chain and two-chain groups, with the mirror
rule's pinned axis (limited, fix X/Y/Z) among them. `cross_append_static()`
makes the legs' two chains read each other through append parents, which
the grouping of chains does not look at.
"""

import dataclasses

import numpy as np

from simple_mmd_renderer_tpu_torch.app.sample import (sample_character,
                                                      sample_motion)
from simple_mmd_renderer_tpu_torch.core import anim
from simple_mmd_renderer_tpu_torch.core.model import (EULER_ORDERS,
                                                      ModelTables,
                                                      build_model)
from simple_mmd_renderer_tpu_torch.formats import pmx as P

# link slots of the rig's IK groups with two or three links, in the order
# (group, link): legs 0-1, right arm 0-2, left arm 0-1
SLOTS = 7
N_VARIANTS = 6


def _slot(variant, s):
    """(fix type, limited, Euler order, limits min, limits max) of slot s."""
    fix = (variant + 2 * s) % 5
    limited = (variant + s) % 3 != 0
    order = EULER_ORDERS[(variant + s) % 6]
    lo = np.array([-1.1, -0.45, -0.8], np.float32) * (1 + 0.1 * s)
    hi = np.array([0.35, 0.9, 0.25], np.float32) * (1 + 0.05 * variant)
    return fix, limited, order, lo, hi


def arm_ik_character(density=0.5):
    pm = sample_character(density=density)
    names = [b.name for b in pm.bones]
    root = names.index("全ての親")
    for side, sx, chain in (("右", -1.0, ("ひじ", "腕捩", "腕")),
                            ("左", 1.0, ("ひじ", "腕"))):
        wrist = names.index(f"{side}手首")
        links = [names.index(f"{side}{n}") for n in chain]
        goal = dataclasses.replace(
            pm.bones[root], name=f"{side}手ＩＫ", name_en="",
            position=np.array([sx * 3.6, 12.6, -1.4], np.float32),
            parent=root, transform_level=1,
            flags=pm.bones[root].flags | P.BONE_HAS_IK, ik_target=wrist,
            ik_loop=30 if len(links) == 3 else 24, ik_angle=1.5,
            ik_links=[P.IKLink(b, False, np.zeros(3, np.float32),
                               np.zeros(3, np.float32)) for b in links])
        pm.bones.append(goal)
    return pm


def ik_static(variant=None, density=0.5):
    """The rig's ModelStatic; with `variant`, its IK groups of two or three
    links reshaped by the variant's slots (the toes' group is left as
    is)."""
    static = build_model(arm_ik_character(density))
    if variant is None:
        return static
    s = 0
    for seg in static.pre_segments:
        if seg.kind != "ik" or len(seg.iks[0].links) < 2:
            continue
        slots = [_slot(variant, s + k) for k in range(len(seg.iks[0].links))]
        s += len(slots)
        for ik in seg.iks:
            ik.fix_types = np.array([x[0] for x in slots], np.int32)
            ik.limited = np.array([x[1] for x in slots], bool)
            ik.orders = [x[2] for x in slots]
            ik.limits_min = np.stack([x[3] for x in slots])
            ik.limits_max = np.stack([x[4] for x in slots])
    assert s == SLOTS, s
    return static


def legs(static):
    """The legs' IK group of `static` (two chains of two links)."""
    (seg,) = [s for s in static.pre_segments if s.kind == "ik"
              and len(s.iks) == 2 and len(s.iks[0].links) == 2]
    return seg


def cross_append_static(density=0.5):
    """The rig with its legs' chains reading each other through append
    parents: the first chain's target (an ankle) appends the second
    chain's knee (its links[0]), rotation and translation at 0.5, which the
    loop's refresh writes before the target's FK; and the first chain's
    thigh (links[1]) appends the second's thigh's rotation at 0.3, which
    the same pre-loop FK phase writes."""
    static = ik_static(None, density)
    first, second = legs(static).iks
    for name in ("append_parent", "append_ratio", "append_rotate",
                 "append_translate"):
        setattr(static, name, np.array(getattr(static, name)))
    for bone, parent, ratio, trans in (
            (first.target, second.links[0], 0.5, True),
            (first.links[1], second.links[1], 0.3, False)):
        static.append_parent[bone] = parent
        static.append_ratio[bone] = ratio
        static.append_rotate[bone] = True
        static.append_translate[bone] = trans
    return static


def ik_rig(variant=None, density=0.5, device="cpu", n_frames=90,
           fps_keys=10):
    """(ModelTables, MotionTables) of `ik_static(variant, density)`, or of
    `cross_append_static(density)` where `variant` is "cross", on the
    sample dance."""
    static = (cross_append_static(density) if variant == "cross"
              else ik_static(variant, density))
    motion = anim.bind_motion(static, sample_motion(n_frames,
                                                    fps_keys=fps_keys))
    return (ModelTables(static, device=device),
            anim.MotionTables(motion, device=device))


def record_groups(monkeypatch, pose_mod):
    """Wrap the CCD dispatcher: -> the list it fills with the inputs of
    every IK group solved, (static, pose, seg, anim_rot, anim_trans,
    morph_rot, morph_trans)."""
    calls = []
    dispatch = pose_mod._solve_ik_group

    def spy(static, pose, seg, *args):
        calls.append((static, pose, seg) + tuple(args[:4]))
        return dispatch(static, pose, seg, *args)

    monkeypatch.setattr(pose_mod, "_solve_ik_group", spy)
    return calls


def frame_inputs(motion_tables, frame):
    """(anim_rot, anim_trans, morph_rates) of the motion at `frame`."""
    return anim.sample_motion(motion_tables, float(frame))
