"""The port's checkpoint store and the online system's snapshot / resume,
against the JAX package on the same inputs.

- `utils/checkpoint.py`: the reference's `TestCheckpoint` cases (round trip,
  shape mismatch rejected, latest selection, `resume_or_init`), and the
  reference's key strings letter for letter;
- `SLAMSystem.save_checkpoint` files beside the JAX system's for the same
  run: the same keys, dtypes and shapes in `.state.npz` and `.kf.npz`, apart
  from the RNG leaf (`generator.get_state()` here, a threefry key there);
- `tests/test_checkpoint_resume.py`'s three cases on the port alone: a
  resumed run equals the uninterrupted one bit for bit from every cut 1-9,
  and automatic snapshots are written;
- a JAX snapshot carried across by `from_reference` and continued by the
  port under JAX's own draws: estimates within atol=1e-3 of JAX's
  uninterrupted run (a filter run, float sums in another order), keyframe
  frames and closures equal;
- the generator guard: a snapshot whose RNG state does not fit (another
  device type, a JAX key) raises ValueError naming the RNG;
- `dist/multihost.py`'s single-process paths and its rank-0 snapshots.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core import config as jcm
from parakeet_slam_tpu.core.state import make_particle_state as j_make_particle_state
from parakeet_slam_tpu.data.panoramic import make_panoramic_world
from parakeet_slam_tpu.system import SLAMSystem as JSystem
from parakeet_slam_tpu.utils import checkpoint as j_ckpt
from parakeet_slam_tpu_torch import system
from parakeet_slam_tpu_torch.backend.graph import make_pose_graph
from parakeet_slam_tpu_torch.core import config as pcm
from parakeet_slam_tpu_torch.core.state import make_particle_state
from parakeet_slam_tpu_torch.dist import multihost
from parakeet_slam_tpu_torch.utils import checkpoint as ckpt

T_FRAMES = 10
CUT = 6


def _state(P, L, **kw):
    return make_particle_state(P, L, device="cpu", **kw)


# -- the store ----------------------------------------------------------------


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        state = _state(4, 8, sig_dim=2).replace(pose=torch.arange(12.0).reshape(4, 3))
        p = str(tmp_path / "ckpt_1.npz")
        ckpt.save_checkpoint(p, state, step=17)
        loaded, step = ckpt.load_checkpoint(p, _state(4, 8, sig_dim=2))
        assert step == 17
        assert torch.equal(loaded.pose, state.pose)
        assert torch.equal(loaded.lm_valid, state.lm_valid)
        assert all(getattr(loaded, f).dtype == getattr(state, f).dtype
                   for f in ("pose", "lm_desc", "lm_valid", "lm_count"))

    def test_shape_mismatch_rejected(self, tmp_path):
        p = str(tmp_path / "ckpt_1.npz")
        ckpt.save_checkpoint(p, _state(4, 8), 0)
        with pytest.raises(ValueError):
            ckpt.load_checkpoint(p, _state(8, 8))

    def test_latest_selection(self, tmp_path):
        for s in (1, 5, 3):
            ckpt.save_checkpoint(str(tmp_path / f"ckpt_{s:08d}.npz"), _state(2, 4), s)
        assert ckpt.latest_checkpoint(str(tmp_path)).endswith("ckpt_00000005.npz")

    def test_resume_or_init(self, tmp_path):
        template = _state(2, 4)
        _, step = multihost.resume_or_init(str(tmp_path), template, lambda: template)
        assert step == 0
        ckpt.save_checkpoint(str(tmp_path / "ckpt_00000009.npz"), template, 9)
        _, step = multihost.resume_or_init(str(tmp_path), template, lambda: template)
        assert step == 9


def test_keys_and_dtypes_match_the_reference(tmp_path):
    """The reference's own store on its own tree and the port's on the
    port's: the same keys in the same order, the same dtypes (descriptor
    words uint32, the graph's host-int cursors 0-d int32) and shapes."""
    P, L, W = 4, 8, 8
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (P, L, W), dtype=np.uint32)
    j_state = j_make_particle_state(P, L, lm_dim=3, sig_dim=0, desc_words=W, pose_dim=7)
    j_state = j_state.replace(lm_desc=jnp.asarray(words))
    from parakeet_slam_tpu.backend.graph import make_pose_graph as j_make_pose_graph

    j_tree = {"state": j_state, "graph": j_make_pose_graph(4, 16), "key": jax.random.PRNGKey(0)}
    p_state = _state(P, L, lm_dim=3, sig_dim=0, desc_words=W, pose_dim=7)
    p_state = p_state.replace(lm_desc=torch.from_numpy(words.view(np.int32).copy()))
    gen = torch.Generator().manual_seed(0)
    p_tree = {"state": p_state, "graph": make_pose_graph(4, 16, device="cpu"),
              "key": gen.get_state()}
    j_ckpt.save_checkpoint(str(tmp_path / "j.npz"), j_tree, step=3)
    ckpt.save_checkpoint(str(tmp_path / "p.npz"), p_tree, step=3)
    j, p = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    keys = [str(k) for k in p["__keys__"]]
    assert keys == [str(k) for k in j["__keys__"]]
    assert keys == [
        "['graph']/.poses", "['graph']/.node_valid", "['graph']/.edge_ij", "['graph']/.edge_rel",
        "['graph']/.edge_info", "['graph']/.edge_valid", "['graph']/.n_nodes",
        "['graph']/.n_edges", "['key']", "['state']/.pose", "['state']/.log_w",
        "['state']/.lm_mean", "['state']/.lm_cov", "['state']/.lm_sig", "['state']/.lm_desc",
        "['state']/.lm_valid", "['state']/.lm_count"]
    assert p["__step__"].dtype == j["__step__"].dtype and int(p["__step__"]) == 3
    for i, k in enumerate(keys):
        if k == ckpt.KEY_LEAF:
            continue
        a, b = p[f"leaf_{i}"], j[f"leaf_{i}"]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # and back: the reference's file loads into the port's tree (the RNG
    # leaf aside), descriptor words viewed back to int32
    loaded, _ = ckpt.load_checkpoint(str(tmp_path / "p.npz"), p_tree)
    assert torch.equal(loaded["state"].lm_desc, p_state.lm_desc)
    assert loaded["graph"].n_nodes == 0 and isinstance(loaded["graph"].n_edges, int)
    assert torch.equal(loaded["key"], gen.get_state())


# -- the online system ----------------------------------------------------------


def _cfg(cm, **kw):
    """tests/test_checkpoint_resume.py's configuration, from either package."""
    return cm.SLAMConfig(
        filter=cm.FilterConfig(
            num_particles=8, max_landmarks=64, max_observations=8, lm_dim=3, obs_dim=2,
            pose_dim=7, sig_dim=0, desc_words=8, measurement_model="equirect_3d",
            motion_model="se3_odometry", motion_noise=(0.02, 0.01), meas_noise=(2.0, 2.0),
            new_landmark_loglik=-12.0, max_range=60.0,
        ),
        frontend=cm.FrontendConfig(detector="fast", max_features=16, fast_threshold=0.12,
                                   camera="equirect", image_size=(64, 128)),
        backend=cm.BackendConfig(max_keyframes=16, keyframe_translation=0.6),
        **kw,
    )


@pytest.fixture(scope="module")
def world():
    w = make_panoramic_world(num_landmarks=60, num_steps=T_FRAMES, image_size=(64, 128), seed=3)
    return w, [w.render(t) for t in range(T_FRAMES)]


def _draws(key, n, P, dim):
    """The JAX system's per-frame draws from `key` on: k_step, key =
    split(key); then k_motion, k_resample = split(k_step), normal(k_motion,
    (P, dim)) and uniform(k_resample, (), 0, 1/P)."""
    out = []
    for _ in range(n):
        k_step, key = jax.random.split(key)
        k1, k2 = jax.random.split(k_step)
        out.append((np.array(jax.random.normal(k1, (P, dim))),
                    float(jax.random.uniform(k2, (), minval=0.0, maxval=1.0 / P))))
    return out


def _run(sys_, images, odom, frames, draws=None):
    out = []
    for t in frames:
        kw = {} if draws is None else dict(motion_noise=draws[t][0], resample_u0=draws[t][1])
        out.append(sys_.process_frame(images[t], odom[t], **kw).numpy())
    return out


def _kf_set(s):
    return [(k.index, k.frame, k.pose.tobytes(), k.points_kf.tobytes(), k.desc.tobytes(),
             k.valid.tobytes(), [(a, v.tobytes()) for a, v in k.anchors]) for k in s.keyframes]


# The reference's configuration, and the same with closure matches pending
# at every cut (a frame gap of 2) and a keyframe store that starts at 3 rows,
# so that it grows inside flag windows and the pending tables differ in K
# (saved padded with -1 rows, loaded back to their own K).
VARIANTS = {"reference": (20, 64), "closures pending": (2, 3)}
_UNINTERRUPTED = {}


def _variant(name, monkeypatch, world):
    """(config, uninterrupted system, its estimates) of one variant, with
    the variant's store size patched in for the rest of the test."""
    gap, rows = VARIANTS[name]
    monkeypatch.setattr(system, "KF_STORE_ROWS", rows)
    cfg = _cfg(pcm)
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend,
                                                               loop_min_frame_gap=gap))
    if name not in _UNINTERRUPTED:
        w, images = world
        a = system.SLAMSystem(cfg, device="cpu")
        est = _run(a, images, w.odom, range(T_FRAMES))
        a.flush_flags()
        _UNINTERRUPTED[name] = (a, est)
    return (cfg, *_UNINTERRUPTED[name])


def test_resume_bit_identical(world, monkeypatch, tmp_path):
    w, images = world
    cfg, a, est_a = _variant("reference", monkeypatch, world)
    b1 = system.SLAMSystem(cfg, device="cpu")
    _run(b1, images, w.odom, range(CUT))
    prefix = str(tmp_path / "snap")
    b1.save_checkpoint(prefix)
    b2 = system.SLAMSystem(cfg, device="cpu")
    b2.load_checkpoint(prefix)
    est_b = _run(b2, images, w.odom, range(CUT, T_FRAMES))
    np.testing.assert_array_equal(np.stack(est_a[CUT:]), np.stack(est_b))
    b2.flush_flags()  # as the uninterrupted run was
    assert b2.frame_idx == a.frame_idx
    assert len(b2.keyframes) == len(a.keyframes)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("cut", range(1, T_FRAMES))
def test_resume_any_frame_same_keyframes(world, monkeypatch, tmp_path, cut, variant):
    """From a snapshot at any frame (inside a flag window or at its
    boundary) the resumed run equals the uninterrupted one bit for bit:
    estimates, keyframes with their anchors, closures, the pose graph, the
    filter state and the generator's state."""
    w, images = world
    cfg, a, est_a = _variant(variant, monkeypatch, world)
    b1 = system.SLAMSystem(cfg, device="cpu")
    _run(b1, images, w.odom, range(cut))
    prefix = str(tmp_path / f"snap{cut}")
    b1.save_checkpoint(prefix)
    pending = [tuple(f.shape) for _, _, f, _ in b1._closure_pending]
    b2 = system.SLAMSystem(cfg, device="cpu")
    b2.load_checkpoint(prefix)
    assert [tuple(f.shape) for _, _, f, _ in b2._closure_pending] == pending
    for (_, _, f1, r1), (_, _, f2, r2) in zip(b1._closure_pending, b2._closure_pending):
        assert torch.equal(f1, f2) and torch.equal(r1, r2)
    est_b = _run(b2, images, w.odom, range(cut, T_FRAMES))
    b2.flush_flags()
    np.testing.assert_array_equal(np.stack(est_a[cut:]), np.stack(est_b), err_msg=f"cut={cut}")
    assert _kf_set(b2) == _kf_set(a), f"cut={cut}: keyframe sets differ"
    assert b2.loop_closures == a.loop_closures
    for f in ("poses", "edge_ij", "edge_rel", "edge_info", "edge_valid", "node_valid"):
        assert torch.equal(getattr(b2.graph, f), getattr(a.graph, f)), f
    assert (b2.graph.n_nodes, b2.graph.n_edges) == (a.graph.n_nodes, a.graph.n_edges)
    for f in ("pose", "log_w", "lm_mean", "lm_cov", "lm_desc", "lm_valid", "lm_count"):
        assert torch.equal(getattr(b2.state, f), getattr(a.state, f)), f
    assert torch.equal(b2.generator.get_state(), a.generator.get_state())


def test_pending_closure_tables_padded_on_disk(world, monkeypatch, tmp_path):
    """In the closure variant a snapshot at frame 5 holds match tables
    dispatched against stores of 3 and 6 rows: on disk they are padded to 6
    with -1 rows, as the reference pads them."""
    w, images = world
    cfg, _, _ = _variant("closures pending", monkeypatch, world)
    s = system.SLAMSystem(cfg, device="cpu")
    _run(s, images, w.odom, range(5))
    ks = sorted({f.shape[0] for _, _, f, _ in s._closure_pending})
    assert len(ks) > 1, ks
    s.save_checkpoint(str(tmp_path / "snap"))
    data = np.load(tmp_path / "snap.kf.npz")
    assert data["cp_fwd"].shape[1] == ks[-1]
    for i, (_, _, f, _) in enumerate(s._closure_pending):
        assert (data["cp_fwd"][i, f.shape[0]:] == -1).all()
        assert (data["cp_rev"][i, f.shape[0]:] == -1).all()


def test_auto_checkpoint_written(world, tmp_path):
    w, images = world
    s = system.SLAMSystem(_cfg(pcm, checkpoint_every=1, checkpoint_dir=str(tmp_path)),
                          device="cpu")
    _run(s, images, w.odom, range(6))
    snaps = sorted(tmp_path.glob("ckpt_*.state.npz"))
    assert snaps, "auto-checkpointing wrote nothing"
    # each one loads into a fresh system
    last = str(snaps[-1])[: -len(".state.npz")]
    r = system.SLAMSystem(_cfg(pcm), device="cpu")
    r.load_checkpoint(last)
    assert r.frame_idx == int(last.rsplit("_", 1)[1]) and r.keyframes


@pytest.fixture(scope="module")
def jax_run(world, tmp_path_factory):
    """The JAX system's uninterrupted run, and a snapshot of a second JAX
    run after CUT frames."""
    w, images = world
    j = JSystem(_cfg(jcm))
    est = [np.asarray(j.process_frame(images[t], w.odom[t])) for t in range(T_FRAMES)]
    j.flush_flags()
    j1 = JSystem(_cfg(jcm))
    for t in range(CUT):
        j1.process_frame(images[t], w.odom[t])
    prefix = str(tmp_path_factory.mktemp("jax") / "snap")
    j1.save_checkpoint(prefix)
    return j, est, prefix


def test_snapshot_files_match_the_reference(world, jax_run, tmp_path):
    """The port's snapshot of the same run (under JAX's draws) beside the
    JAX system's: the same keys, dtypes and shapes in both files, the RNG
    leaf aside."""
    w, images = world
    _, _, j_prefix = jax_run
    p = system.SLAMSystem(_cfg(pcm), device="cpu")
    draws = _draws(jax.random.PRNGKey(0), CUT, 8, p.slam.noise_dim)
    _run(p, images, w.odom, range(CUT), draws)
    prefix = str(tmp_path / "snap")
    p.save_checkpoint(prefix)
    js, ps = np.load(j_prefix + ".state.npz"), np.load(prefix + ".state.npz")
    keys = [str(k) for k in ps["__keys__"]]
    assert keys == [str(k) for k in js["__keys__"]]
    for i, k in enumerate(keys):
        if k != ckpt.KEY_LEAF:
            assert (ps[f"leaf_{i}"].dtype, ps[f"leaf_{i}"].shape) == \
                   (js[f"leaf_{i}"].dtype, js[f"leaf_{i}"].shape), k
    i_key = keys.index(ckpt.KEY_LEAF)
    assert ps[f"leaf_{i_key}"].dtype == np.uint8 and js[f"leaf_{i_key}"].dtype == np.uint32
    jk, pk = np.load(j_prefix + ".kf.npz"), np.load(prefix + ".kf.npz")
    assert sorted(pk.files) == sorted(jk.files)
    for k in jk.files:
        assert (pk[k].dtype, pk[k].shape) == (jk[k].dtype, jk[k].shape), k
    for k in ("n", "frame_idx", "has_kf", "kf_frame", "anchor_kf", "anchor_start", "p_frame",
              "p_flag", "p_valid", "valid", "desc", "p_desc", "loop_closures", "cp_kidx"):
        np.testing.assert_array_equal(pk[k], jk[k], err_msg=k)


def test_jax_snapshot_continued_by_the_port(world, jax_run, tmp_path):
    """JAX runs CUT frames and saves; `from_reference` carries the snapshot
    across; the port loads it and runs the remaining frames under the draws
    JAX derives from its saved key. The estimates stay within 1e-3 of JAX's
    uninterrupted run, keyframe frames and closures equal."""
    w, images = world
    j, j_est, j_prefix = jax_run
    p = system.SLAMSystem(_cfg(pcm), device="cpu")
    prefix = str(tmp_path / "carried")
    ckpt.from_reference(j_prefix, prefix, p.generator)
    p.load_checkpoint(prefix)
    assert p.frame_idx == CUT
    data = np.load(j_prefix + ".state.npz")
    keys = [str(k) for k in data["__keys__"]]
    key = jnp.asarray(data[f"leaf_{keys.index(ckpt.KEY_LEAF)}"])
    draws = _draws(key, T_FRAMES - CUT, 8, p.slam.noise_dim)
    est = [p.process_frame(images[t], w.odom[t], motion_noise=n, resample_u0=u).numpy()
           for t, (n, u) in zip(range(CUT, T_FRAMES), draws)]
    p.flush_flags()
    np.testing.assert_allclose(np.stack(est), np.stack(j_est[CUT:]), atol=1e-3)
    assert [k.frame for k in p.keyframes] == [k.frame for k in j.keyframes]
    assert len(p.keyframes) >= 2
    assert p.loop_closures == [tuple(int(x) for x in c) for c in j.loop_closures]


def test_rng_that_does_not_fit_raises(world, jax_run, tmp_path):
    """A reference snapshot loaded without `from_reference`, and one whose
    generator state has another size (a card's Philox state is 16 bytes, the
    CPU's mt19937 5056), raise ValueError naming the RNG; nothing is
    re-seeded quietly."""
    _, _, j_prefix = jax_run
    p = system.SLAMSystem(_cfg(pcm), device="cpu")
    before = p.generator.get_state()
    with pytest.raises(ValueError, match="RNG state.*from_reference"):
        p.load_checkpoint(j_prefix)
    prefix = str(tmp_path / "philox")
    ckpt.from_reference(j_prefix, prefix, p.generator)
    data = dict(np.load(prefix + ".state.npz"))
    keys = [str(k) for k in data["__keys__"]]
    data[f"leaf_{keys.index(ckpt.KEY_LEAF)}"] = np.zeros(16, np.uint8)
    np.savez(prefix + ".state.npz", **data)
    with pytest.raises(ValueError, match="RNG state"):
        p.load_checkpoint(prefix)
    assert torch.equal(p.generator.get_state(), before) and p.frame_idx == 0


# -- dist/multihost.py ------------------------------------------------------------


def test_multihost_single_process_and_rank0_snapshots(tmp_path, monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert multihost.initialize_multihost() is False
    assert multihost.initialize_multihost("localhost:1", num_processes=1) is False
    assert multihost.process_index() == 0
    cb = multihost.snapshot_every(str(tmp_path), 3)
    for step in range(1, 8):
        cb(_state(2, 4), step)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_00000003.npz",
                                                         "ckpt_00000006.npz"]
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    multihost.snapshot_every(str(tmp_path), 1)(_state(2, 4), 9)
    assert not (tmp_path / "ckpt_00000009.npz").exists()
