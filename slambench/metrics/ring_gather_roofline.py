"""The ring gather's share of its roofline on rank 0 over the traced
frames, in %: the bytes that rank 0's ring gather sends a frame (the
program's counter `dist.ring_bytes`, S - 1 packed blocks of its rows of
the state) over the device time of NCCL's send/receive kernels a frame
(`ncclDevKernel_SendRecv`, names holding "SendRecv"), divided by the
link's peak in one direction.

The peak: on the four-card H100 machine `nvidia-smi topo -m` fails to
read the matrix ("Failed to run topology matrix"), and `nvidia-smi nvlink
--status` reads 18 active NVLink links on each card at 26.562 GB/s each,
a rate each way (NVIDIA's H100 SXM data sheet gives 900 GB/s over 18
links, both directions together): 18 x 26.5625 = 478.125 GB/s each way. A
ring step sends one block to the next rank while receiving one from the
previous, so the sends are held to one direction's peak.

None on a program without the counter, or with no send/receive kernel in
the traced frames."""

LINK_PEAK_BYTES_PER_S = 18 * 26.5625e9


def share(ring_bytes_per_frame: float, sendrecv_ms_per_frame: float) -> float | None:
    if not ring_bytes_per_frame or not sendrecv_ms_per_frame:
        return None
    return 100.0 * ring_bytes_per_frame / (sendrecv_ms_per_frame / 1e3) / LINK_PEAK_BYTES_PER_S


def read(run):
    if run.stretch is None or "dist.ring_bytes" not in run.counters:
        return None
    return share(run.counters["dist.ring_bytes"], run.counters.get("ring_kernel_ms_per_frame"))
