"""Core bit-plane lattice-gas algebra (PyTorch port of ``repro.core``)."""
