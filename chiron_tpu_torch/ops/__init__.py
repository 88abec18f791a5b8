"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper dispatches on the device of its input: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (built by ``_build``) or
raises.
"""
