"""The filter step as one CUDA graph: the port's counterpart of the
reference's `@jax.jit` on `step` (and, with a device-side frame counter, of
the `lax.scan` in `filter/runner.py`).

`CapturedStep(fn, state, inputs, graph=...)` runs `fn(state, inputs) ->
(new_state, outputs)` over buffers that it owns. `state` and `inputs` are
trees of tensors (dataclasses such as `ParticleState` or `Observation`,
tuples, lists, dicts). On the card (`graph=True`) the first call runs `fn`
eagerly on a side stream (the warm-up: the kernel library builds, cuBLAS and
cuSOLVER set up their handles and workspaces, the models' constants reach
the device); the second captures one call into a `torch.cuda.CUDAGraph`,
and every call from then on replays it: one graph launch a frame, whatever
number of kernels the step runs, and the hand kernels among them. A capture
that fails raises; nothing falls back to the eager step. On the CPU
(`graph=False`) every call runs `fn` eagerly under the same buffer rules, so
that the tests exercise them.

The rules, the same in both modes:
  - `state` holds the static state. `fn` reads it, and each call ends with
    the new state copied into it (inside the graph), so the state lives in
    one place: write into its leaves (`copy_into`), never rebind them.
  - `inputs` holds the static inputs. The caller writes the frame's inputs
    into them (`copy_into`) before a call; `fn` may write into them too (a
    frame counter, an output row at that counter).
  - `outputs` are static as well: the next call overwrites them. They are
    views into one byte buffer, so that `take()` copies all of them out in
    one device copy: call it for what is kept past the frame.
  - The kernel wrappers count their launches in Python, so a capture, which
    launches nothing, counts once and a replay, which runs no Python, not at
    all. The capture's counts are taken back and added once per replay; so
    are the program tracer's counts made inside the capture (the bytes of
    the sharded step's collectives: `utils/trace.recording`).
  - The random draws stay outside: the caller draws them, or injects them,
    and writes them into the inputs.

Several steps may share one memory pool (`pool=`, from
`torch.cuda.graph_pool_handle()`): they replay one after another on one
stream, so a graph's intermediates may take the memory of another's.

Collectives inside (the sharded programs of `dist/`): NCCL's all-gathers,
all-reduces and batched sends and receives are captured into the graph and
replayed with it. The warm-up call runs them eagerly first, so that NCCL
sets up each communicator and each point-to-point connection outside the
capture (it cannot inside one). Every rank of the group must make the same
calls in the same order, eager and replayed alike: each rank captures at
the same call and replays in lockstep with the others. While a process
group is up the capture runs in `capture_error_mode="thread_local"`:
ProcessGroupNCCL's watchdog thread queries the events of earlier
collectives while the capture runs, and under the default "global" mode
such a query from another thread invalidates the capture. gloo cannot be
captured: on the CPU the sharded programs run with `graph=False`.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from parakeet_slam_tpu_torch.kernels import (ekf_update, ekf_update_3d, horn, match,
                                             propose_3d, resample_cuda, schur)
from parakeet_slam_tpu_torch.utils import trace


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in leaves(v)]
    return []


def tree_map(fn, tree):
    """The tree with every tensor t replaced by fn(t)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def clone(tree):
    """A copy of every tensor of the tree (what a caller keeps past a frame)."""
    return tree_map(torch.clone, tree)


def copy_into(dst, src) -> None:
    """Write the tensors of `src` into those of `dst`, tree for tree (a
    tensor that is already the destination is left alone)."""
    d, s = leaves(dst), leaves(src)
    if len(d) != len(s):
        raise ValueError(f"copy_into: {len(s)} tensors into {len(d)}")
    for a, b in zip(d, s):
        if a is not b:
            if a.shape != b.shape:
                raise ValueError(f"copy_into: {tuple(b.shape)} into {tuple(a.shape)}")
            a.copy_(b)


def counted_wrappers() -> list:
    """The kernel wrappers that count their launches (the module attributes
    of this moment: a wrapper replaced by its twin counts nothing)."""
    fns = (ekf_update.measurement_update_2d, ekf_update_3d.score_3d,
           ekf_update_3d.measurement_update_3d, resample_cuda.gather_state,
           match.hamming_top2, match.l2_top2, schur.apply_cinv, horn.rotation_fit,
           propose_3d.propose_3d)
    return [f for f in fns if hasattr(f, "launches")]


class CapturedStep:
    """One step function over static buffers, replayed as a CUDA graph on
    the card (see the module docstring). After the capture: `capture_s` and
    `instantiate_s` (seconds on the host's clock), `pool_bytes` (the device
    memory the capture reserved: what its pool grew by) and
    `launches_per_replay` ({wrapper name: launches})."""

    def __init__(self, fn, state, inputs, *, graph: bool, pool=None):
        devices = {t.device for t in leaves(state) + leaves(inputs)}
        if graph and any(d.type != "cuda" for d in devices):
            raise ValueError(f"CapturedStep: a graph needs CUDA buffers, got {devices}")
        if len(devices) > 1:
            raise ValueError(f"CapturedStep: buffers on more than one device: {devices}")
        self.fn, self.state, self.inputs, self.graph = fn, state, inputs, graph
        self.pool = pool
        self.device = devices.pop() if devices else None
        self.outputs = None
        self._packed = None
        self._graph = None
        self._counts = {}
        self._tallies = {}
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0

    def _run(self):
        """fn once on the static buffers, its new state written back."""
        new_state, out = self.fn(self.state, self.inputs)
        copy_into(self.state, new_state)
        return out

    def _store(self, out):
        if self.outputs is None:
            self._pack(out)
        copy_into(self.outputs, out)

    def _pack(self, out):
        """The static outputs: views shaped as `out` into one byte buffer,
        each at an offset aligned to 16 bytes."""
        self._spec, size = [], 0
        for t in leaves(out):
            self._spec.append((size, t.dtype, t.shape, t.numel() * t.element_size()))
            size += -(-self._spec[-1][3] // 16) * 16
        self._packed = torch.empty(size, dtype=torch.uint8, device=self.device)
        self.outputs = self._unpack(self._packed, out)

    def _unpack(self, buf, tree):
        """`tree` with its tensors replaced by their views into `buf`."""
        views = iter([buf[o:o + n].view(dtype).view(shape) for o, dtype, shape, n in self._spec])
        return tree_map(lambda _: next(views), tree)

    def take(self):
        """A copy of the outputs of the last call, made by one device copy."""
        return self._unpack(self._packed.clone(), self.outputs)

    def __call__(self):
        """One step from the static inputs; returns the static outputs."""
        if not self.graph:
            self._store(self._run())
            return self.outputs
        if self.outputs is None:  # the warm-up, eager
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._store(self._run())
            main.wait_stream(side)
            return self.outputs
        if self._graph is None:
            with trace.span("capture"):
                self._capture()
            trace.count("captures")
            trace.count("capture_ms", (self.capture_s + self.instantiate_s) * 1e3)
        self._graph.replay()
        for f, n in self._counts.items():
            f.launches += n
        if self._tallies:
            trace.add(self._tallies)
        return self.outputs

    def _capture(self):
        wrappers = counted_wrappers()
        before = [f.launches for f in wrappers]
        # Dead graphs go now: one that the collector destroys while a
        # capture is under way (a step and its filter hold each other, so
        # only the cycle collector frees them) invalidates the capture.
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        # kept past its capture, so that capture and instantiation time apart
        g = torch.cuda.CUDAGraph(keep_graph=True)
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        distributed = torch.distributed.is_available() and torch.distributed.is_initialized()
        try:
            with trace.recording() as self._tallies, torch.cuda.graph(
                    g, pool=self.pool,
                    capture_error_mode="thread_local" if distributed else "global"):
                copy_into(self.outputs, self._run())
        except RuntimeError as e:
            raise RuntimeError(f"CapturedStep: the step could not be captured: {e}") from e
        finally:
            if collecting:
                gc.enable()
            self._counts = {f: f.launches - n for f, n in zip(wrappers, before)
                            if f.launches != n}
            for f, n in zip(wrappers, before):
                f.launches = n
        t1 = time.perf_counter()
        g.instantiate()
        torch.cuda.synchronize(self.device)
        self.capture_s, self.instantiate_s = t1 - t0, time.perf_counter() - t1
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._graph = g

    @property
    def launches_per_replay(self) -> dict:
        return {f.__name__: n for f, n in self._counts.items()}
