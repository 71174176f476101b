"""The fused, temporally blocked FHP step: CUDA kernel + plain version."""
