"""Resampling payload gather: copy whole particle states by index.

After systematic index selection every surviving particle's ENTIRE state,
pose plus its whole landmark map, is copied to its new slot: a
bandwidth-bound gather with no arithmetic. `gather_state` launches the
hand-written kernel `csrc/gather_rows.cu` (one launch for every leaf) on
CUDA tensors and its plain twin `gather_state_reference` (`index_select`
per leaf) on CPU tensors. Port of
`parakeet_slam_tpu/kernels/resample_pallas.py::gather_state`.

Both reset the weights to 0, as `kernels/resample.py::gather_particles` of
the reference does after its gather.
"""

from __future__ import annotations

import ctypes

import torch

from parakeet_slam_tpu_torch.core.state import ParticleState
from parakeet_slam_tpu_torch.kernels import _build

# log_w is not gathered: it is reset to 0.
_LEAVES = ("pose", "lm_mean", "lm_cov", "lm_sig", "lm_desc", "lm_valid", "lm_count")


def gather_state_reference(state: ParticleState, idx: torch.Tensor) -> ParticleState:
    idx = idx.long()
    out = {f: torch.index_select(getattr(state, f), 0, idx) for f in _LEAVES}
    return state.replace(log_w=torch.zeros_like(state.log_w), **out)


def gather_state(state: ParticleState, idx: torch.Tensor) -> ParticleState:
    """Gathered state (new tensors) with out[i] = state[idx[i]] for every
    leaf and log_w = 0. idx [P] integer, every entry in [0, P)."""
    if state.pose.device.type == "cpu":
        return gather_state_reference(state, idx)
    if state.pose.device.type != "cuda":
        raise ValueError(f"gather_state: unsupported device {state.pose.device}")
    P = state.num_particles
    dev = state.pose.device
    if idx.shape != (P,) or idx.device != dev:
        raise ValueError(f"gather_state: idx must be [{P}] on {dev}, got {tuple(idx.shape)} on {idx.device}")
    idx32 = idx.to(torch.int32).contiguous()
    srcs, dsts, nbytes, out = [], [], [], {}
    for f in _LEAVES:
        a = getattr(state, f)
        if a.device != dev or a.shape[0] != P or not a.is_contiguous():
            raise ValueError(f"gather_state: leaf {f} must be contiguous [{P}, ...] on {dev}")
        o = torch.empty_like(a)
        out[f] = o
        row = a.numel() // P * a.element_size()
        if row == 0:  # zero-width leaf (desc_words=0)
            continue
        srcs.append(a.data_ptr())
        dsts.append(o.data_ptr())
        nbytes.append(row)
    n = len(srcs)
    lib = _build.library()
    err = lib.gather_rows_launch(
        (ctypes.c_void_p * n)(*srcs), (ctypes.c_void_p * n)(*dsts),
        (ctypes.c_longlong * n)(*nbytes), n, idx32.data_ptr(), P,
        _build.stream_ptr(idx32),
    )
    _build.check(err, "gather_rows")
    gather_state.launches += 1
    return state.replace(log_w=torch.zeros_like(state.log_w), **out)


gather_state.launches = 0
