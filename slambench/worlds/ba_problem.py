"""The joint bundle-adjustment problem of the JAX package's bench at the
EuRoC-config scale, copied from `eval/kernel_inputs.ba_bench_problem` and
drawn on the device from the seed: C cameras along x from 0 to 5 m facing
+z, points uniform in +-10 m around (0, 0, 15), `obs_per_cam` random points
per camera, their pinhole projections with `noise_px` of pixel noise."""

from __future__ import annotations

import torch


def make(p: dict, seed: int, device) -> dict:
    """The BAProblem fields (cam_pose, points, obs_cam, obs_pt, obs_uv) as
    tensors on `device`, from the traffic's parameters `p`: cameras,
    points, obs_per_cam, noise_px, camera [fx, fy, cx, cy, W, H]."""
    g = torch.Generator(device=device).manual_seed(seed)
    C, Pts, opc = int(p["cameras"]), int(p["points"]), int(p["obs_per_cam"])
    fx, fy, cx, cy = (float(v) for v in p["camera"][:4])
    f64 = torch.float64
    pts = (torch.rand(Pts, 3, generator=g, device=device, dtype=f64) * 20.0 - 10.0
           + torch.tensor([0.0, 0.0, 15.0], dtype=f64, device=device))
    poses = torch.zeros(C, 7, dtype=f64, device=device)
    poses[:, 6] = 1.0
    poses[:, 0] = torch.linspace(0.0, 5.0, C, dtype=f64, device=device)
    obs_cam = torch.arange(C, dtype=torch.int32, device=device).repeat_interleave(opc)
    obs_pt = torch.randint(0, Pts, (C * opc,), generator=g, device=device, dtype=torch.int64)
    q = pts[obs_pt] - poses[obs_cam.long(), :3]            # identity rotations
    z = torch.clamp(q[:, 2], min=1e-3)
    uv = torch.stack([fx * q[:, 0] / z + cx, fy * q[:, 1] / z + cy], dim=1)
    uv = uv + float(p["noise_px"]) * torch.randn(uv.shape, generator=g, device=device, dtype=f64)
    f32 = torch.float32
    return dict(cam_pose=poses.to(f32), points=pts.to(f32), obs_cam=obs_cam,
                obs_pt=obs_pt.to(torch.int32), obs_uv=uv.to(f32))
