from repro_torch.optim.adamw import AdamW, cosine_schedule  # noqa: F401
