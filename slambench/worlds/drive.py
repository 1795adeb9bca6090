"""The KITTI 00-class street world and its stereo frames, made on the card
from the seed: a copy of the port's `data/synth_vision.make_drive_world`
(a rounded-square circuit with facade landmarks on both sides, each with a
stable 3-blob texture) with its circuit sized by the traffic, and of
`VisionWorld._render_pose`'s splat renderer, rewritten in PyTorch.

The frames are quantised to 8 bits and scaled to [0, 1] float32, as the
port's KITTI loader (`data/kitti.py`) reads the PNGs that
`write_kitti_format` writes. The splat sums in float64 before the
quantisation, so the order of the device's atomic adds cannot change a
pixel: the same seed gives the same frames."""

from __future__ import annotations

import math

import torch

from slambench.reference.frozen.core import geometry

# body (x-forward, z-up, yaw) -> optical (z-forward, y-down) quaternion
_Q_BC = (-0.5, 0.5, -0.5, 0.5)
_PATCH_R = 12  # splat window radius, as the port's renderer


class DriveWorld:
    """Landmarks [N, 3], ground-truth poses [T, 7], noisy odometry [T, 6]
    and textures, all on `device`, from the traffic's parameters `p`."""

    def __init__(self, p: dict, seed: int, device, frames: int):
        self.p = p
        self.device = device
        g = torch.Generator(device=device).manual_seed(seed)
        f32 = torch.float32
        rc = float(p["corner_radius_m"])
        lap_m = float(p["lap_frames"]) * float(p["speed_m"])
        # perimeter = 4 * side + 2 pi rc with side = 2 half - 2 rc
        self.half = (lap_m + 8 * rc - 2 * math.pi * rc) / 8
        self.rc, self.side = rc, 2 * self.half - 2 * rc
        self.lap_m = 4 * self.side + 2 * math.pi * rc
        n = int(round(float(p["landmarks_per_m"]) * self.lap_m))

        def u(*shape, lo=0.0, hi=1.0):
            r = torch.rand(*shape, generator=g, device=device, dtype=torch.float64)
            return r * (hi - lo) + lo

        s_lm = u(n, hi=self.lap_m)
        lat = u(n, lo=p["lateral_m"][0], hi=p["lateral_m"][1]) * torch.where(
            u(n) < 0.5, -1.0, 1.0)
        hgt = u(n, lo=p["height_m"][0], hi=p["height_m"][1])
        c_lm, yaw_lm = self.center(s_lm)
        normal = torch.stack([-torch.sin(yaw_lm), torch.cos(yaw_lm)], dim=1)
        self.landmarks = torch.cat([c_lm + normal * lat[:, None], hgt[:, None]], 1).to(f32)
        self.sizes = u(n, lo=1.6, hi=3.0).to(f32)
        self.sat = u(n, 2, 2, lo=-6.0, hi=6.0).to(f32)
        self.sat_amp = u(n, 2, lo=0.35, hi=0.9).to(f32)

        s = torch.arange(frames, device=device, dtype=torch.float64) * float(p["speed_m"])
        xy, yaw = self.center(s)
        half_yaw = yaw / 2
        q_yaw = torch.stack([torch.zeros_like(yaw), torch.zeros_like(yaw), torch.sin(half_yaw),
                             torch.cos(half_yaw)], 1).to(f32)
        q = geometry.quat_multiply(q_yaw, torch.tensor(_Q_BC, device=device))
        t = torch.cat([xy.to(f32), torch.full((frames, 1), float(p["camera_height_m"]),
                                               device=device)], 1)
        self.gt_pose = torch.cat([t, q], 1)
        rel = geometry.se3_log(geometry.se3_between(self.gt_pose[:-1], self.gt_pose[1:]))
        sig_t, sig_r = (float(v) for v in p["odom_noise"])
        noise = torch.cat([torch.randn(frames - 1, 3, generator=g, device=device) * sig_t,
                           torch.randn(frames - 1, 3, generator=g, device=device) * sig_r], 1)
        self.odom = torch.zeros(frames, 6, device=device)
        self.odom[1:] = rel + noise

    def center(self, s: torch.Tensor):
        """(xy [n, 2], heading [n]) of the circuit's centre line at arc
        length s: straights and quarter arcs in turn, rotated a quarter turn
        after each arc (make_drive_world's `center`)."""
        s = torch.remainder(s, self.lap_m)
        arc = math.pi * self.rc / 2
        period = self.side + arc
        k2 = torch.floor(s / period)                 # which straight-and-arc pair
        r = s - k2 * period
        on_arc = r >= self.side
        a = torch.where(on_arc, (r - self.side) / self.rc, torch.zeros_like(r))
        straight = torch.stack([-self.half + self.rc + r, torch.full_like(r, -self.half)], 1)
        c = torch.tensor([self.half - self.rc, -self.half + self.rc], dtype=s.dtype,
                         device=s.device)
        curve = c + self.rc * torch.stack([torch.sin(a), -torch.cos(a)], 1)
        p = torch.where(on_arc[:, None], curve, straight)
        rot = k2 * (math.pi / 2)
        cr, sr = torch.cos(rot), torch.sin(rot)
        xy = torch.stack([cr * p[:, 0] - sr * p[:, 1], sr * p[:, 0] + cr * p[:, 1]], 1)
        return xy, rot + a

    def _render(self, poses: torch.Tensor) -> torch.Tensor:
        """8-bit-quantised frames [B, H, W] (float32 in [0, 1]) at camera
        poses [B, 7]."""
        p = self.p
        H, W = (int(v) for v in p["image_size"])
        fx, fy, cx, cy = (float(v) for v in p["intrinsics"])
        B = poses.shape[0]
        dev = self.device
        p_cam = geometry.quat_rotate(geometry.quat_conjugate(poses[:, None, 3:]),
                                     self.landmarks[None] - poses[:, None, :3])   # [B, N, 3]
        z = p_cam[..., 2]
        vis = (z > 0.25) & (z < float(p["max_render_range_m"]))
        zs = torch.where(vis, z, torch.ones_like(z))
        u = fx * p_cam[..., 0] / zs + cx
        v = fy * p_cam[..., 1] / zs + cy
        m = _PATCH_R
        vis &= (u >= -m) & (u < W + m) & (v >= -m) & (v < H + m)
        b, j = torch.nonzero(vis, as_tuple=True)
        uj, vj = u[b, j], v[b, j]
        # centre blob + two satellite blobs per visible landmark
        us = torch.cat([uj, uj + self.sat[j, 0, 0], uj + self.sat[j, 1, 0]]).double()
        vs = torch.cat([vj, vj + self.sat[j, 0, 1], vj + self.sat[j, 1, 1]]).double()
        amp = torch.cat([torch.ones_like(uj), self.sat_amp[j, 0], self.sat_amp[j, 1]]).double()
        sig = self.sizes[j].repeat(3).double()
        bb = b.repeat(3)
        off = torch.arange(-m, m + 1, device=dev)
        gx = torch.round(us).long()[:, None] + off[None, :]            # [n, S]
        gy = torch.round(vs).long()[:, None] + off[None, :]
        dx, dy = gx - us[:, None], gy - vs[:, None]
        val = amp[:, None, None] * torch.exp(
            -(dx[:, None, :] ** 2 + dy[:, :, None] ** 2) / (2.0 * sig[:, None, None] ** 2))
        ok = ((gy >= 0) & (gy < H))[:, :, None] & ((gx >= 0) & (gx < W))[:, None, :]
        flat = (bb[:, None, None] * (H * W) + gy.clamp(0, H - 1)[:, :, None] * W
                + gx.clamp(0, W - 1)[:, None, :])
        img = torch.zeros(B * H * W, dtype=torch.float64, device=dev)
        img.index_add_(0, flat[ok], val[ok])
        img = torch.floor(img.clamp(0.0, 1.0) * 255.0)      # the PNG's uint8, truncated
        return (img.to(torch.float32) / 255.0).view(B, H, W)

    def render_stereo(self, first: int, count: int, batch: int = 8):
        """Frames first..first+count-1 as host float32 arrays [count, H, W]
        (left, right), rendered on the card in batches."""
        import numpy as np

        H, W = (int(v) for v in self.p["image_size"])
        left = np.empty((count, H, W), np.float32)
        right = np.empty((count, H, W), np.float32)
        base = torch.tensor([float(self.p["baseline_m"]), 0.0, 0.0], device=self.device)
        for i in range(0, count, batch):
            pose = self.gt_pose[first + i:first + min(i + batch, count)]
            rpose = pose.clone()
            rpose[:, :3] = geometry.se3_apply(pose, base)
            n = pose.shape[0]
            left[i:i + n] = self._render(pose).cpu().numpy()
            right[i:i + n] = self._render(rpose).cpu().numpy()
        return left, right
