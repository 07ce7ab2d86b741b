"""bwd_kernel_roofline: K8's share of its roofline, x 100: its least time
(``benchmark/kernel_roofline.py``, from the cell's inputs and the
reference's covered pixels) over the device ms a step in the two launches
of ``csrc/fused_bwd_csr.cu`` (the partial rows and their reduction), from a
complete traced window. Nothing where no step ran them (another engine)."""

from benchmark import kernel_roofline


def read(data):
    return kernel_roofline.share(data, kernel_roofline.BWD_KERNELS,
                                 kernel_roofline.bwd_work)
