"""A large panoramic world and a 360° rig's outbound walk through it, made
on the card from the seed.

The walk starts at the origin and moves `step_m` a frame (a rig carried at
walking pace and read at its frame rate) along a path of gentle turns: its
heading is a sum of two slow sines of amplitudes `turn_rad`, so it never
turns back and no place is revisited. `landmarks` points line the path as
a corridor or a street would: spread evenly along its length at
`landmarks_per_m`, each at a lateral offset of `lateral_m` to either side
of the path and at a height of `height_m` about the rig, and each with its
own random descriptor of W words.

Each frame sees its Z nearest landmarks between `min_range_m` and the
filter's range gate `max_range_m`, projected through the equirect_3d model
of the image size with `pixel_noise` pixels of noise, each described by
its landmark's descriptor with `desc_flips` bits flipped; a frame with
fewer in range leaves its last slots invalid (z, descriptor 0, landmark
-1). The odometry of frame t is the true motion from frame t - 1, with
`odom_noise` (metres, radians) added; frame 0's is zero. Every draw is made
for the whole run at once, so the frames come out the same whatever the
chunks the geometry is worked in (`chunk` frames at a time, against the
landmarks within reach of the chunk: a few hundred MB at most)."""

from __future__ import annotations

import math

import torch

from slambench.reference.frozen.core import geometry

# frames of path laid before the walk's start (its first landmarks lie
# behind the rig)
_LEAD_M = 24.0


class PanoField:
    """Every frame's odometry [T, 6] float32, observations z [T, Z, 2]
    float32, desc [T, Z, W] int32, valid [T, Z] bool and the landmark each
    observation is of (`landmark` [T, Z] int64, -1 where invalid), on
    `device`; the landmarks' positions `points` [N, 3] and descriptors
    `table` [N, W]; `path_m` the walk's length over the T frames."""

    def __init__(self, p: dict, seed: int, device, frames: int, Z: int, W: int, image_size,
                 max_range_m: float, chunk: int = 1024):
        g = torch.Generator(device=device).manual_seed(seed)
        f64 = dict(device=device, dtype=torch.float64)
        H, Wi = (int(v) for v in image_size)
        n = int(p["landmarks"])
        step = float(p["step_m"])
        length = n / float(p["landmarks_per_m"])
        if frames * step + 2 * _LEAD_M > length:
            raise ValueError(f"pano_field: {frames} frames of {step} m pass the end of the "
                             f"world's {length:.0f} m")
        # the path, a pose every step_m from _LEAD_M behind the start to past the world's end
        lead = int(math.ceil(_LEAD_M / step))
        k = torch.arange(-lead, int(math.ceil(length / step)) + lead + 1, **f64)
        s = k * step
        (a1, a2), (w1, w2) = p["turn_rad"], p["turn_wavelength_m"]
        heading = a1 * torch.sin(2 * math.pi * s / w1) + a2 * torch.sin(2 * math.pi * s / w2)
        heading = torch.where(s < 0, torch.zeros_like(s), heading)
        dx, dy = step * torch.cos(heading), step * torch.sin(heading)
        x = torch.cumsum(dx, 0) - dx
        y = torch.cumsum(dy, 0) - dy
        x, y = x - x[lead], y - y[lead]
        # the landmarks, sorted along the path
        sl = torch.sort(torch.rand(n, generator=g, **f64) * length - _LEAD_M).values
        at = torch.clamp(torch.round(sl / step).long() + lead, 0, k.shape[0] - 1)
        lo_l, hi_l = (float(v) for v in p["lateral_m"])
        side = torch.where(torch.rand(n, generator=g, **f64) < 0.5, -1.0, 1.0)
        lat = side * (lo_l + (hi_l - lo_l) * torch.rand(n, generator=g, **f64))
        lo_h, hi_h = (float(v) for v in p["height_m"])
        hgt = lo_h + (hi_h - lo_h) * torch.rand(n, generator=g, **f64)
        hd = heading[at]
        pts = torch.stack([x[at] - lat * torch.sin(hd), y[at] + lat * torch.cos(hd), hgt], 1)
        self.points = pts.to(torch.float32)
        table = torch.randint(-2**31, 2**31, (n, W), generator=g, device=device,
                              dtype=torch.int64)
        self.table = table.to(torch.int32)

        # the frames' poses [T, 7] and their draws
        fi = torch.arange(frames, device=device) + lead
        se2 = torch.stack([x[fi], y[fi], heading[fi]], 1)
        poses = geometry.se2_to_se3(se2)
        noise_px = torch.tensor(p["pixel_noise"], **f64)
        px = torch.randn(frames, Z, 2, generator=g, **f64) * noise_px
        flips = int(p["desc_flips"])
        fw = torch.randint(0, W, (flips, frames, Z, 1), generator=g, device=device)
        fb = torch.randint(0, 32, (flips, frames, Z, 1), generator=g, device=device,
                           dtype=torch.int32)
        sig_t, sig_r = (float(v) for v in p["odom_noise"])
        onoise = torch.cat([torch.randn(frames, 3, generator=g, **f64) * sig_t,
                            torch.randn(frames, 3, generator=g, **f64) * sig_r], 1)

        rel = geometry.se3_log(geometry.se3_between(poses[:-1], poses[1:]))
        odom = torch.zeros(frames, 6, **f64)
        odom[1:] = rel + onoise[1:]
        self.odom = odom.to(torch.float32)
        self.path_m = float(frames * step)

        # the selection, in chunks of frames against the landmarks in reach
        # (products and sums alone, which round alike in any batch; the
        # projection's transcendentals run once on the whole run below)
        rmin, rmax = float(p["min_range_m"]), float(max_range_m)
        reach = rmax + 2.0 * max(abs(lo_l), abs(hi_l), abs(lo_h), abs(hi_h)) + 2.0
        pick = torch.full((frames, Z), -1, dtype=torch.int64, device=device)
        pc = torch.zeros(frames, Z, 3, **f64)
        for c0 in range(0, frames, chunk):
            c1 = min(c0 + chunk, frames)
            j0 = int(torch.searchsorted(sl, torch.tensor(c0 * step - reach, **f64)))
            j1 = int(torch.searchsorted(sl, torch.tensor((c1 - 1) * step + reach, **f64)))
            q = poses[c0:c1].double()
            p_cam = geometry.quat_rotate(geometry.quat_conjugate(q[:, None, 3:]),
                                         pts[None, j0:j1] - q[:, None, :3])   # [C, M, 3]
            r2 = (p_cam[..., 0] * p_cam[..., 0] + p_cam[..., 1] * p_cam[..., 1]
                  + p_cam[..., 2] * p_cam[..., 2])
            key = torch.where((r2 > rmin * rmin) & (r2 < rmax * rmax), r2,
                              torch.full_like(r2, math.inf))
            kk, order = torch.sort(key, dim=1, stable=True)
            take = min(Z, order.shape[1])
            ok = torch.isfinite(kk[:, :take])
            sel = order[:, :take]
            got = torch.gather(p_cam, 1, sel[..., None].expand(-1, -1, 3))
            pick[c0:c1, :take] = torch.where(ok, sel + j0, torch.full_like(sel, -1))
            pc[c0:c1, :take] = torch.where(ok[..., None], got, torch.zeros_like(got))
        valid = pick >= 0
        r = torch.linalg.vector_norm(pc, dim=-1) + 1e-9
        u = (torch.atan2(pc[..., 1], pc[..., 0]) + math.pi) / (2 * math.pi) * Wi
        v = (math.pi / 2 - torch.asin(torch.clamp(pc[..., 2] / r, -1, 1))) / math.pi * H
        zw = torch.where(valid[..., None], torch.stack([u, v], -1), torch.zeros_like(pc[..., :2]))
        z = torch.where(valid[..., None], zw + px, zw)
        z[..., 0] = torch.where(valid, torch.remainder(z[..., 0], Wi), z[..., 0])
        desc = torch.where(valid[..., None], self.table[pick.clamp(min=0)],
                           torch.zeros(1, dtype=torch.int32, device=device))
        for i in range(flips):
            flip = torch.zeros_like(desc).scatter_(2, fw[i], torch.bitwise_left_shift(
                torch.ones_like(fb[i]), fb[i]))
            desc = torch.where(valid[..., None], torch.bitwise_xor(desc, flip), desc)
        self.z = z.to(torch.float32)
        self.desc = desc
        self.valid = valid
        self.landmark = pick
