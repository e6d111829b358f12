"""The train step: microbatched gradient accumulation and AdamW
(:mod:`repro_torch.train.step`)."""
