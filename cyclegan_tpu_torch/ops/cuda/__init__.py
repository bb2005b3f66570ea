"""Hand-written CUDA kernels of the port and their Python wrappers.

``LAUNCHES`` counts, per kernel, the calls in which a wrapper launched its
kernel on the card (a call to a plain version on the CPU does not count),
so a run can show that the main path went through the kernels.
"""

LAUNCHES = {"instance_norm": 0, "instance_norm_backward": 0, "epilogue": 0,
            "epilogue_backward": 0, "upsample": 0, "upsample_int8": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
