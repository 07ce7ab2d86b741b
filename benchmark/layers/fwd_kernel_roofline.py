"""fwd_kernel_roofline: K7's share of its roofline, x 100: its least time
(``benchmark/kernel_roofline.py``, from the cell's inputs and the
reference's covered pixels) over the device ms a step in the launches of
``csrc/raster_fwd_csr.cu`` (the cull boxes and the strip walk), from a
complete traced window. Nothing where no step ran them (another engine)."""

from benchmark import kernel_roofline


def read(data):
    return kernel_roofline.share(data, kernel_roofline.FWD_KERNELS,
                                 kernel_roofline.fwd_work)
