"""Checkpoint store: crc32-checked, atomically published trees of
tensors in the reference's on-disk format (see
:mod:`repro_torch.checkpoint.store`)."""
from repro_torch.checkpoint.store import (CheckpointError,  # noqa: F401
                                          CheckpointExistsError,
                                          CheckpointManager, ChecksumError,
                                          LeafMismatchError, ManifestError,
                                          latest_step, latest_valid_step,
                                          load_leaf, load_meta, restore,
                                          save, verify_checkpoint)
