"""Traffic model of the FHP hot path on the card's datasheet rates (see
:mod:`repro_torch.roofline.analysis`), and the roofline accounting of a
traced step (:mod:`repro_torch.roofline.trace`)."""
