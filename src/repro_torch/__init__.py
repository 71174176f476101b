"""PyTorch + CUDA port of the FHP bit-plane lattice gas.

The layout mirrors the JAX package ``repro``: ``core`` (rules, circuits,
counter RNG, bit planes, rule specs, the ensemble entry point),
``geometry`` and ``scenarios`` (workloads and observables), and
``kernels/fhp_step`` (the fused step kernel, hand-written in CUDA for the
H100, with its plain PyTorch version beside it).  State is held as
``torch.int32`` bit-views of the reference's uint32 words; ``core.carry``
converts between the two.
"""
