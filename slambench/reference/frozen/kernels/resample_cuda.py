"""Resampling payload gather: copy whole particle states by index.

After systematic index selection every surviving particle's ENTIRE state,
pose plus its whole landmark map, is copied to its new slot: a
bandwidth-bound gather with no arithmetic. `gather_state` launches the
hand-written kernel `csrc/gather_rows.cu` (one launch for every leaf; the
work lists it walks are cut by `plan_gather`) on CUDA tensors and its plain
twin `gather_state_reference` (`index_select` per leaf) on CPU tensors. Port
of `parakeet_slam_tpu/kernels/resample_pallas.py::gather_state`.

Both reset the weights to 0, as `kernels/resample.py::gather_particles` of
the reference does after its gather.

The source window (`window=lo`, `out=`) is the ring gather's form
(`dist/sharded_filter.py::ring_gather_rows`): `state` is the block of global
rows [lo, lo + P_block) resident at one ring step, and only the rows of
`out` whose index falls inside it are written, each from row idx - lo; the
others are left as they are. Its twin is the reference's take of clamped
rows merged with `where` (`parakeet_slam_tpu/dist/sharded_filter.py:58-70`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slambench.reference.frozen.core.state import ParticleState
from slambench.reference.frozen.kernels import _build

# log_w is not gathered: it is reset to 0.
_LEAVES = ("pose", "lm_mean", "lm_cov", "lm_sig", "lm_desc", "lm_valid", "lm_count")


def gather_state_reference(state: ParticleState, idx: torch.Tensor, *, window: int | None = None,
                           out: ParticleState | None = None) -> ParticleState:
    idx = idx.long()
    if window is None:
        got = {f: torch.index_select(getattr(state, f), 0, idx) for f in _LEAVES}
        return state.replace(log_w=state.log_w.new_zeros(idx.shape[0]), **got)
    Pb = state.num_particles
    sel = (idx >= window) & (idx < window + Pb)
    rows = torch.clamp(idx - window, 0, Pb - 1)
    if out is None:
        out = _new_out(state, idx.shape[0], zeros=True)
    merged = {}
    for f in _LEAVES:
        a = torch.index_select(getattr(state, f), 0, rows)
        merged[f] = torch.where(sel.reshape((-1,) + (1,) * (a.dim() - 1)), a, getattr(out, f))
    return out.replace(**merged)


def _new_out(state: ParticleState, n: int, zeros: bool = False) -> ParticleState:
    """A state of n rows shaped as `state`'s (log_w 0; the other leaves 0
    or uninitialized)."""
    make = torch.zeros if zeros else torch.empty
    return state.replace(log_w=state.log_w.new_zeros(n), **{
        f: make((n,) + tuple(getattr(state, f).shape[1:]), dtype=getattr(state, f).dtype,
                device=getattr(state, f).device) for f in _LEAVES})


# The kernel streams rows in chunks of this many bytes through a ring of
# shared-memory stages of the same size (a multiple of 16).
_CHUNK = 16384


def plan_gather(row_bytes: tuple, shaped: tuple, P: int, chunk: int):
    """The kernel's two work lists for leaves of `row_bytes[k]` bytes a row.

    A leaf that is `shaped[k]` (base addresses and row length multiples of
    16 bytes) is cut into chunks: item (row r, piece c) covers bytes
    [c * chunk, min((c + 1) * chunk, row_bytes)) of row r, `per` = pieces of
    a row, P * per items. Any other leaf is copied by threads, `per` whole
    rows to an item (as many as fit in a sixteenth of a chunk, at least
    one: these rows are a few bytes, and many short items keep every block
    busy), ceil(P / per) items. Zero-width leaves are left out.

    Returns (bulk, small, n_bulk_items, n_small_items); `bulk` and `small`
    list (k, per, first) with `first` the leaf's first item in its list.
    """
    if chunk < 16 or chunk % 16:
        raise ValueError(f"plan_gather: chunk {chunk} must be a positive multiple of 16")
    if len(row_bytes) != len(shaped):
        raise ValueError(f"plan_gather: {len(row_bytes)} widths, {len(shaped)} flags")
    lists, counts = ([], []), [0, 0]
    for k, (nb, ok) in enumerate(zip(row_bytes, shaped)):
        if nb == 0:
            continue
        which = 0 if ok else 1
        per = -(-nb // chunk) if ok else max(1, chunk // 16 // nb)
        lists[which].append((k, per, counts[which]))
        counts[which] += P * per if ok else -(-P // per)
    return tuple(lists[0]), tuple(lists[1]), counts[0], counts[1]


@functools.lru_cache(maxsize=64)
def _launch_plan(row_bytes: tuple, shaped: tuple, P: int, chunk: int):
    """plan_gather's answer as the launch takes it: the leaves' order (bulk
    first), then the widths, `per`, `first` and the counts as C values."""
    bulk, small, n_bulk_items, n_small_items = plan_gather(row_bytes, shaped, P, chunk)
    order = bulk + small
    n = len(order)
    return (
        tuple(k for k, _, _ in order),
        (ctypes.c_longlong * n)(*(row_bytes[k] for k, _, _ in order)),
        (ctypes.c_int * n)(*(per for _, per, _ in order)),
        (ctypes.c_int * n)(*(first for _, _, first in order)),
        len(bulk), len(small), n_bulk_items, n_small_items,
    )


def gather_state(state: ParticleState, idx: torch.Tensor, *, window: int | None = None,
                 out: ParticleState | None = None) -> ParticleState:
    """Gathered state with out[i] = state[idx[i]] for every leaf and log_w =
    0. idx [N] integer, every entry in [0, P); the result has N rows (new
    tensors).

    With `window=lo` (the module docstring) `state` holds global rows [lo,
    lo + P): output row i becomes state[idx[i] - lo] where idx[i] lies in
    that window and is left as it was elsewhere. The rows are written into
    `out` (N rows, contiguous; allocated when None, its rows outside the
    window then undefined on the card and 0 in the twin), which is
    returned with its own log_w (0 when allocated here)."""
    if window is not None and window < 0:
        raise ValueError(f"gather_state: window {window} < 0")
    if out is not None and window is None:
        raise ValueError("gather_state: out= is the source window's (give window=)")
    if True:  # frozen reference: the plain twin on every device
        return gather_state_reference(state, idx, window=window, out=out)
    if state.pose.device.type != "cuda":
        raise ValueError(f"gather_state: unsupported device {state.pose.device}")
    P = state.num_particles
    dev = state.pose.device
    if idx.dim() != 1 or idx.shape[0] < 1 or idx.device != dev:
        raise ValueError(f"gather_state: idx must be [N >= 1] on {dev}, got {tuple(idx.shape)} "
                         f"on {idx.device}")
    N = idx.shape[0]
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.long()
    idx = idx.contiguous()
    if out is None:
        out = _new_out(state, N)
    srcs, dsts, nbytes = [], [], []
    for f in _LEAVES:
        a, o = getattr(state, f), getattr(out, f)
        if a.device != dev or a.shape[0] != P or not a.is_contiguous():
            raise ValueError(f"gather_state: leaf {f} must be contiguous [{P}, ...] on {dev}")
        if o.device != dev or o.shape != (N,) + a.shape[1:] or o.dtype != a.dtype \
                or not o.is_contiguous():
            raise ValueError(f"gather_state: out leaf {f} must be contiguous "
                             f"{(N,) + tuple(a.shape[1:])} {a.dtype} on {dev}")
        srcs.append(a.data_ptr())
        dsts.append(o.data_ptr())
        nbytes.append(a.numel() // P * a.element_size())
    shaped = tuple((s | d | nb) % 16 == 0 for s, d, nb in zip(srcs, dsts, nbytes))
    order, *table = _launch_plan(tuple(nbytes), shaped, N, _CHUNK)
    n = len(order)
    err = _build.library().gather_rows_launch(
        (ctypes.c_void_p * n)(*(srcs[k] for k in order)),
        (ctypes.c_void_p * n)(*(dsts[k] for k in order)),
        *table, _CHUNK, idx.data_ptr(), idx.dtype == torch.int64, N, P,
        -1 if window is None else window, _build.stream_ptr(idx),
    )
    _build.check(err, "gather_rows")
    gather_state.launches += 1
    return out


gather_state.launches = 0
