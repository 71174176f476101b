"""Traffic model of the FHP hot path on the card's datasheet rates (see
:mod:`repro_torch.roofline.analysis`)."""
