"""The landmark-block inverse-apply (`kernels/schur.py`) on the CPU: the plain
twin on the solver's edge blocks held against the JAX package's XLA path and
its Pallas kernel in interpret mode, through strided, transposed, offset and
broadcast operands as the element-stride kernel reads them. Floats within
rtol=1e-5, atol=1e-6 (XLA's and Pallas's own rounding; the twin and the
kernel are bit-equal on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.kernels import schur as j_schur
from parakeet_slam_tpu_torch.eval import kernel_inputs
from parakeet_slam_tpu_torch.kernels import schur


def _edge_blocks(n, seed):
    """SPD blocks with every seventh block damped by 1e12 (an invalid
    point), every seventh from the second |det| < eps and every seventh
    from the third negative definite."""
    C, u = kernel_inputs.schur_blocks(n, seed)
    eye = np.eye(3, dtype=np.float32)
    C[::7] = 1e-3 * C[::7] + (1e12 + 1e-6) * eye
    C[1::7] = 1e-5 * eye
    C[2::7] = -C[2::7]
    return C, u


def _jax(C, u):
    C, u = jnp.asarray(np.ascontiguousarray(C)), jnp.asarray(np.ascontiguousarray(u))
    return np.asarray(j_schur.apply_cinv_xla(C, u)), np.asarray(j_schur.apply_cinv(C, u,
                                                                                  interpret=True))


@pytest.mark.parametrize("n", [3, 257, 1001])
@pytest.mark.parametrize("layout", ["contiguous", "strided C", "broadcast u"])
def test_edge_blocks_match_jax_in_every_layout(n, layout):
    C, u = _edge_blocks(n, seed=n)
    Ct, ut = torch.as_tensor(C), torch.as_tensor(u)
    if layout == "strided C":
        wide = torch.zeros(n, 4, 5)
        wide[:, :3, 1:4] = Ct
        Ct = wide[:, :3, 1:4]
    elif layout == "broadcast u":
        ut, u = ut[:1].expand(n, 3), np.broadcast_to(u[:1], (n, 3))
    y = schur.cinv_apply(Ct, ut).numpy()
    y_xla, y_pal = _jax(C, u)
    assert y.shape == (n, 3) and np.isfinite(y).all()
    for want in (y_xla, y_pal):
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-6)
    # |det| < eps: the clamp drops det's sign and divides by eps
    np.testing.assert_allclose(y[1], 1e-10 * u[1] / 1e-12, rtol=1e-4)


def _offset(t, elements):
    """A contiguous copy of t that starts `elements` floats into its buffer."""
    buf = torch.zeros(t.numel() + elements)
    buf[elements:] = t.reshape(-1)
    return buf[elements:].view(t.shape)


@pytest.mark.parametrize("case", [
    "contiguous",
    "N=1",
    "strided C",
    "transposed C",
    "broadcast u",
    "C 4 bytes off 16",
    "u 8 bytes off 16",
    "C 16 bytes off 16",
])
def test_every_layout_the_kernel_reads_matches_jax(case):
    """The kernel reads C and u through their element strides, whatever the
    layout; the twin, on the same views, equals JAX on contiguous copies."""
    n = 1 if case == "N=1" else 300
    C_np, u_np = kernel_inputs.schur_blocks(n, seed=1)
    C, u = torch.as_tensor(C_np), torch.as_tensor(u_np)
    if case == "strided C":
        wide = torch.zeros(n, 3, 4)
        wide[:, :, :3] = C
        C = wide[:, :, :3]
    elif case == "transposed C":
        C = C.transpose(1, 2)
    elif case == "broadcast u":
        u = u[:1].expand(n, 3)
    elif case == "C 4 bytes off 16":
        C = _offset(C, 1)
    elif case == "u 8 bytes off 16":
        u = _offset(u, 2)
    elif case == "C 16 bytes off 16":
        C = _offset(C, 4)
    y = schur.cinv_apply(C, u)
    # the symmetric C's transpose is C, so every view holds the same blocks
    assert torch.equal(y, schur.apply_cinv_reference(C.contiguous(), u.contiguous()))
    y_xla, y_pal = _jax(C.numpy(), u.numpy())
    for want in (y_xla, y_pal):
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-6)


def test_kernel_entry_refuses_what_it_does_not_take():
    C, u = (torch.as_tensor(a) for a in kernel_inputs.schur_blocks(10, seed=2))
    before = schur.apply_cinv.launches
    with pytest.raises(ValueError, match="CUDA"):
        schur.apply_cinv(C, u)
    with pytest.raises(ValueError, match="expected"):
        schur.cinv_apply(C, u[:5])
    assert schur.apply_cinv.launches == before
