"""MLA decode's attention core as one split-KV CUDA kernel."""
