"""dense_bwd_roofline: K6's share of its roofline, x 100: the least time
of the fused backward's work (``benchmark/kernel_roofline.bwd_work``, from
the cell's inputs and the reference's covered pixels; it follows no
kernel's layout) over the device ms a step in the two launches of
``csrc/fused_bwd.cu`` (the partial rows over the dense bins and their
reduction onto the faces), from a complete traced window. Nothing where no
step ran them (another engine)."""

from benchmark import kernel_roofline

# K6's launches by symbol.
KERNELS = frozenset({"fused_bwd_partial_kernel", "fused_bwd_reduce_kernel"})


def read(data):
    return kernel_roofline.share(data, KERNELS, kernel_roofline.bwd_work)
