"""Optimizer: AdamW with float32 master weights and cosine LR
(:mod:`repro_torch.optim.adamw`), int8 error-feedback gradient
compression (:mod:`repro_torch.optim.compress`)."""
