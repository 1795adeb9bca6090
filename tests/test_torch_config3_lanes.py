"""Config 3 from images grows non-finite landmark lanes: the reference's
fused route does the same on the same inputs (slow; not in Tier-1).

`chip_smoke.py` phase 11b runs configs/kitti_00.yaml at full width (P=2048)
over 20 frames of the drive world written in the KITTI layout, and by frame
20 some valid `lm_mean` lanes are not finite, captured and eager alike.
Here, on the CPU, at the config's L = 10240, Z = 128, 512 features and
376 x 1241 images, with P cut from 2048 to 128 (what the CPU carries):

1. The port's eager system and the JAX system's XLA route (use_pallas=False)
   over the same 20 frames under JAX's draws, the number of valid lanes
   whose mean is not finite counted per frame. The two routes part from
   frame 2 (the float32 det Q flips of tests/test_torch_stereo.py), so the
   runs are compared by whether and when lanes go non-finite, not lane by
   lane: the port's first at frame 17, the XLA route's none.
2. The replay that settles it: the map pass of the port's first particle
   with a non-finite lane, at that frame, on exactly the port's inputs
   (its post-proposal pose, score_3d's scores, the map), through JAX's
   fused route, the Pallas kernel `measurement_update_3d` in interpret
   mode, which is the route configs/kitti_00.yaml selects and the port's
   kernels follow: the same lanes go non-finite. The lane lies behind the
   camera, where float32 flips the sign of det Q (float64 keeps it
   positive), so it outscores a new landmark and absorbs most of the
   frame's observations; a hundred sequential float32 updates of one lane
   at the clamped depth then overflow. The port's update in float64 (the
   witness) and JAX's XLA map pass, whose algebra differs, stay finite on
   the same inputs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core import config as jcm
from parakeet_slam_tpu.core.state import Observation as JObservation
from parakeet_slam_tpu.core.state import ParticleState as JState
from parakeet_slam_tpu.filter.fastslam2 import make_filter as j_make_filter
from parakeet_slam_tpu.kernels import ekf_update_3d as j_k3
from parakeet_slam_tpu.system import SLAMSystem as JSystem
from parakeet_slam_tpu_torch import cli, system
from parakeet_slam_tpu_torch.core import config as pcm
from parakeet_slam_tpu_torch.data.synth_vision import make_drive_world, write_kitti_format
from parakeet_slam_tpu_torch.filter import fastslam as p_fastslam
from parakeet_slam_tpu_torch.kernels import ekf_update_3d as k3
from test_torch_stereo import _float64_update, _system_draws

P = 128
FRAMES = 20
WORLD_STEPS = 24  # phase 11b's world: its 20 frames and 4 profiled ones

pytestmark = pytest.mark.slow


def _bad(mean, valid):
    m, v = np.asarray(mean), np.asarray(valid)
    return (~np.isfinite(m).all(-1)) & v


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both systems over the 20 frames: (per-frame non-finite valid lanes of
    the port and of JAX's XLA route, the port's map-pass inputs at its
    first frame with such lanes, the frame)."""
    world = make_drive_world(num_steps=WORLD_STEPS)
    path = write_kitti_format(world, str(tmp_path_factory.mktemp("kitti")))
    over = {"data.path": path, "filter.num_particles": P}
    cfg = pcm.load_config("configs/kitti_00.yaml", over)
    left, right, _, odom = cli.load_image_dataset(cfg, FRAMES)
    draws = _system_draws(0, FRAMES, P, 6)

    calls = []
    update = k3.measurement_update_3d

    def record(*args, **kw):
        calls[:] = [([a.clone() if torch.is_tensor(a) else a for a in args], kw)]
        return update(*args, **kw)

    p_sys = system.SLAMSystem(cfg, device="cpu")
    port, first = [], None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_fastslam.ekf_update_3d, "measurement_update_3d", record)
        for t in range(FRAMES):
            p_sys.process_stereo_frame(left(t), right(t), odom[t], motion_noise=draws[t][0],
                                       resample_u0=draws[t][1])
            port.append(int(_bad(p_sys.state.lm_mean, p_sys.state.lm_valid).sum()))
            if port[-1] and first is None:
                first = (t, calls[0])

    jcfg = jcm.load_config("configs/kitti_00.yaml", over)
    j_sys = JSystem(dataclasses.replace(jcfg, filter=dataclasses.replace(jcfg.filter,
                                                                         use_pallas=False)))
    ref = []
    for t in range(FRAMES):
        j_sys.process_stereo_frame(np.asarray(left(t), np.float32),
                                   np.asarray(right(t), np.float32), odom[t])
        ref.append(int(_bad(j_sys.state.lm_mean, j_sys.state.lm_valid).sum()))
    print(f"non-finite valid lm_mean lanes a frame, P={P}: port {port}, JAX XLA route {ref}")
    return port, ref, first


def test_port_goes_non_finite_where_the_xla_route_does_not(runs):
    port, ref, first = runs
    assert first is not None and first[0] == 17 and port[17] == 11
    assert ref == [0] * FRAMES


def test_the_fused_route_goes_non_finite_on_the_same_map_pass(runs):
    _, _, (frame, (args, kw)) = runs
    # the port's map pass at that frame: its first particle with a bad lane
    out = k3.measurement_update_3d_reference(*args, **kw)
    bad = _bad(out[1], out[4])
    p = int(np.flatnonzero(bad.any(1))[0])
    per = (0, 1, 2, 3, 4, 5, 6, 10, 11)  # the per-particle arguments
    one = [a[p:p + 1] if i in per else a for i, a in enumerate(args)]
    lanes = np.flatnonzero(bad[p])
    port32 = k3.measurement_update_3d_reference(*one, **kw)
    port64 = _float64_update(*one, **kw)
    jargs = [a.numpy().view(np.uint32) if i in (4, 8) else a.numpy() for i, a in enumerate(one)]
    fused = j_k3.measurement_update_3d(*(jax.numpy.asarray(a) for a in jargs), **kw,
                                       interpret=True)
    got = {name: np.flatnonzero(_bad(o[1], o[4])[0]) for name, o in (
        ("port float32", port32), ("port float64", port64), ("JAX fused (Pallas)", fused))}
    # why: the lanes lie behind the camera, where float32 flips det Q
    c = k3.Consts(kw["model"], kw["par"], kw["r_var"], kw["desc_weight"])
    depth, det = {}, {}
    for dt in (torch.float32, torch.float64):
        R, t = k3._cam(k3.camera_rows(one[0].to(dt)), lanes=True)
        m, S = k3._planes(one[2].to(dt), one[3].to(dt))
        pc = k3._cam_point(R, t, m)
        _, H = k3._zhat_jac(c, R, pc)
        _, Q = k3._innovation_cov(H, S, c.r_var)
        depth[dt], det[dt] = pc[2][0, lanes].numpy(), k3._inverse(Q, 3)[1][0, lanes].numpy()
    scored = one[9] & (one[10][0] >= kw["log_p0"])
    taken = np.bincount(one[11][0][scored].numpy(), minlength=args[2].shape[1])[lanes]
    # JAX's XLA map pass on the same inputs
    jcfg = jcm.load_config("configs/kitti_00.yaml", {
        "filter.num_particles": 1, "filter.use_pallas": False, "filter.fs2_association": "hoisted"})
    jslam = j_make_filter(jcfg.filter, jcfg.frontend)
    pose, log_w, mean, cov, desc_l, valid_l, count, z, desc, valid, ll, ix = (
        jax.numpy.asarray(a) for a in jargs)
    st, _ = jslam.measurement_core(
        JState(pose=pose, log_w=log_w, lm_mean=mean, lm_cov=cov, lm_sig=jax.numpy.zeros(
            valid_l.shape + (0,)), lm_desc=desc_l, lm_valid=valid_l, lm_count=count),
        JObservation(z=z, sig=jax.numpy.zeros((z.shape[0], 0)), desc=desc, valid=valid),
        weight_matched=False, scores=(ix, ll))
    got["JAX XLA"] = np.flatnonzero(_bad(st.lm_mean, st.lm_valid)[0])
    print(f"frame {frame}, particle {p}: non-finite lanes {got}; depth {depth[torch.float64]}, "
          f"det Q float32 {det[torch.float32]} float64 {det[torch.float64]}, observations "
          f"taken {taken}")
    np.testing.assert_array_equal(got["port float32"], lanes)
    np.testing.assert_array_equal(got["JAX fused (Pallas)"], lanes)
    assert got["port float64"].size == 0 and got["JAX XLA"].size == 0
    assert (depth[torch.float64] < 0).all() and (det[torch.float32] <= 0).all()
    assert (det[torch.float64] > 0).all() and (taken > 50).all()
