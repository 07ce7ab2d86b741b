"""dense_fwd_roofline: K5's share of its roofline, x 100: the least time
of the forward raster's work (``benchmark/kernel_roofline.fwd_work``, from
the cell's inputs and the reference's covered pixels; it follows no
kernel's layout) over the device ms a step in the launches of
``csrc/raster_fwd_dense.cu`` (the cull boxes and the culled walk over the
dense bins), from a complete traced window. Nothing where no step ran
them (another engine)."""

from benchmark import kernel_roofline

# K5's launches by symbol: the box launch is the CSR forward's too.
KERNELS = frozenset({"cull_boxes_kernel", "raster_fwd_dense_kernel"})


def read(data):
    return kernel_roofline.share(data, KERNELS, kernel_roofline.fwd_work)
