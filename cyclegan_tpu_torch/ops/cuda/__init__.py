"""Hand-written CUDA kernels of the port and their Python wrappers.

``LAUNCHES`` counts, per kernel, the calls in which a wrapper launched its
kernel on the card (a call to a plain version on the CPU does not count),
so a run can show that the main path went through the kernels. The bf16
forms of K1-K5 count apart, under the kernel's name with ``_bf16``.
"""

F32_KERNELS = ("instance_norm", "instance_norm_backward", "epilogue",
               "epilogue_backward", "upsample", "upsample_int8")
BF16_KERNELS = ("instance_norm_bf16", "instance_norm_backward_bf16",
                "epilogue_bf16", "epilogue_backward_bf16", "upsample_bf16")
LAUNCHES = {name: 0 for name in F32_KERNELS + BF16_KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
