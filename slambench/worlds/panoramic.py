"""The panoramic world's observations, made on the card from the seed: a
copy of the port's `data/panoramic.make_panoramic_world` (a camera walking
a circle inside a flattened shell of landmarks, looking outward) and of
`eval/kernel_inputs.panoramic_observations` (each frame the Z nearest
landmarks beyond `min_range_m`, projected through the equirect_3d model of
the image size with pixel noise; each landmark carries a fixed descriptor,
observed with `desc_flips` bits flipped), rewritten in PyTorch. The walk
repeats round the circle; every frame draws its own pixel noise, bit flips
and odometry noise."""

from __future__ import annotations

import math

import torch

from slambench.reference.frozen.core import geometry


class PanoWalk:
    """Every frame's odometry [T, 6] and observations (z [T, Z, 2], desc
    [T, Z, W] int32, valid [T, Z]) on `device`, from the traffic's
    parameters `p` and the configuration's Z, W and image size."""

    def __init__(self, p: dict, seed: int, device, frames: int, Z: int, W: int, image_size):
        g = torch.Generator(device=device).manual_seed(seed)
        H, Wi = (int(v) for v in image_size)
        n, r0 = int(p["landmarks"]), float(p["radius_m"])
        dirs = torch.randn(n, 3, generator=g, device=device, dtype=torch.float64)
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
        dirs[:, 2] *= 0.4  # flattened vertically, most near the horizon
        dist = torch.rand(n, generator=g, device=device, dtype=torch.float64) * 1.5 * r0 + 1.5 * r0
        lm = (dirs * dist[:, None]).to(torch.float32)
        T = int(p["lap_frames"])
        th = torch.arange(T, device=device, dtype=torch.float32) * (2 * math.pi / T)
        se2 = torch.stack([0.3 * r0 * torch.cos(th), 0.3 * r0 * torch.sin(th), th + math.pi / 2], 1)
        poses = geometry.se2_to_se3(se2)                                       # [T, 7]
        nxt = torch.roll(poses, -1, 0)
        rel = geometry.se3_log(geometry.se3_between(poses, nxt))               # step t -> t+1
        # the Z nearest landmarks beyond min_range of each pose of the lap
        p_cam = geometry.quat_rotate(geometry.quat_conjugate(poses[:, None, 3:]),
                                     lm[None] - poses[:, None, :3]).double()   # [T, n, 3]
        rng = torch.linalg.vector_norm(p_cam, dim=-1)
        key = torch.where(rng > float(p["min_range_m"]), rng, torch.full_like(rng, float("inf")))
        pick = torch.sort(key, dim=1, stable=True).indices[:, :Z]              # [T, Z]
        pc = torch.gather(p_cam, 1, pick[..., None].expand(-1, -1, 3))
        r = torch.linalg.vector_norm(pc, dim=-1) + 1e-9
        u = (torch.atan2(pc[..., 1], pc[..., 0]) + math.pi) / (2 * math.pi) * Wi
        v = (math.pi / 2 - torch.asin(torch.clamp(pc[..., 2] / r, -1, 1))) / math.pi * H
        zw = torch.stack([u, v], -1)
        valid = torch.gather(key, 1, pick) < float("inf")
        table = torch.randint(-2**31, 2**31, (n, W), generator=g, device=device, dtype=torch.int64)
        table = table.to(torch.int32)

        lap = torch.arange(frames, device=device) % T
        noise_px = torch.tensor(p["pixel_noise"], device=device, dtype=torch.float64)
        z = zw[lap] + torch.randn(frames, Z, 2, generator=g, device=device,
                                  dtype=torch.float64) * noise_px
        z[..., 0] = torch.remainder(z[..., 0], Wi)   # the azimuth wraps round the image
        desc = table[pick[lap]]                                                # [F, Z, W]
        for _ in range(int(p["desc_flips"])):
            w = torch.randint(0, W, (frames, Z, 1), generator=g, device=device)
            bit = torch.randint(0, 32, (frames, Z, 1), generator=g, device=device,
                                dtype=torch.int32)
            flip = torch.zeros_like(desc).scatter_(2, w, torch.bitwise_left_shift(
                torch.ones_like(bit), bit))
            desc = torch.bitwise_xor(desc, flip)
        self.z = z.to(torch.float32)
        self.desc = desc
        self.valid = valid[lap]
        sig_t, sig_r = (float(v) for v in p["odom_noise"])
        step = rel[(lap - 1) % T]
        onoise = torch.cat([torch.randn(frames, 3, generator=g, device=device) * sig_t,
                            torch.randn(frames, 3, generator=g, device=device) * sig_r], 1)
        self.odom = step + onoise
        self.odom[0] = 0.0
