"""repro_torch — ED-Batch's batched-execution path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The JAX package ``repro`` is the reference: every module here keeps the
name and place of its counterpart there, and the tests hold the two
together on the CPU. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
