"""The roofline arithmetic: published peaks of one H100 and the operations
and bytes a kernel's inputs need, copied from `chip_smoke.py` (`bound`,
`OPS_3D`, `appearance_ops`, `update_ops`, `ext_update_bytes`) and from the
port's `apply_cinv` bench, so that later changes to the program do not move
the yardstick.

A kernel's share of its roofline is the least time the card could take for
the work (the larger of bytes over the memory bandwidth and operations over
the peak of the unit used) divided by the kernel's measured device time.
Bytes: each input byte read once, each output byte written once.
Operations: what these inputs need, counted from the plain twins'
arithmetic (one add, multiply, compare, select, popcount, sqrt or
transcendental each)."""

from __future__ import annotations

# Published peaks of one H100 SXM at its full power limit (NVIDIA's data
# sheet, dense): device memory bytes/s, float32 operations/s outside the
# tensor cores.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

# Operations of the 3-D update functions per unit of work (chip_smoke.py):
#   pair: one observation scored against one valid lane, without the
#         appearance term; lane: a valid lane's scoring geometry; update: the
#         EKF update of one matched lane; init: one new landmark; cull: the
#         field-of-view test and count of one valid unmatched lane; obs: the
#         association decision and weight term of one valid observation.
OPS_3D = {
    "pinhole_3d": {"pair": 19, "lane": 118, "update": 279, "init": 102, "cull": 38, "obs": 12},
    "stereo_3d": {"pair": 31, "lane": 201, "update": 429, "init": 216, "cull": 38, "obs": 12},
    "equirect_3d": {"pair": 23, "lane": 149, "update": 314, "init": 102, "cull": 27, "obs": 12},
}

# apply_cinv: 46 operations a 3x3 block (24 multiplies, 14 adds and
# subtracts, 2 negations, 3 divisions, the |det| test, counted from the
# kernel's arithmetic); bytes a block: the upper triangle of C (6 floats),
# u and y (3 floats each).
CINV_OPS = 46
CINV_BYTES = (6 + 3 + 3) * 4


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops, peak_ops=PEAK_F32):
    """(seconds, "bytes" | "operations"): the least time the card could
    take to move n_bytes and do ops operations, and which of the two binds."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def appearance_ops(width: int) -> int:
    """Operations per pair of the appearance term: `width` descriptor words
    xor-ed, popcounted and summed, then the scaling and the subtraction."""
    return 3 * width + 3 if width else 0


def score_ops(model: str, width: int, lanes: int, n_obs: int) -> int:
    """Operations of `score_3d`: every observation against every valid lane,
    plus each valid lane's geometry once."""
    c = OPS_3D[model]
    return (c["pair"] + appearance_ops(width)) * n_obs * lanes + c["lane"] * lanes


def update_ops(model: str, width: int, lanes: int, n_valid_obs: int, P: int, n_update: int,
               n_init: int) -> int:
    """Operations of the whole-frame update that scores the frame itself:
    the valid observations against every valid lane, the lanes' geometry,
    then association, apply and cull."""
    c = OPS_3D[model]
    pair = c["pair"] + appearance_ops(width)
    rest = (c["obs"] * n_valid_obs * P + c["update"] * n_update + c["init"] * n_init
            + c["cull"] * (lanes - n_update))
    return pair * n_valid_obs * lanes + c["lane"] * lanes + rest


def share_pct(bound_s: float, measured_s: float) -> float | None:
    """A roofline share in %, or None where nothing was measured."""
    if measured_s <= 0.0:
        return None
    return 100.0 * bound_s / measured_s
