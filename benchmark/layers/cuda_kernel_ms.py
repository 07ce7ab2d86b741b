"""cuda_kernel_ms: device ms a step in the port's own kernels (those of
``dirt_tpu_torch/csrc``), from a complete traced window."""


def read(data):
    window = data["window"]
    if not window.complete():
        return None
    return window.per_step_ms(window.seconds(program=True))
