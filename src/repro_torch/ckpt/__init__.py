"""Manifest checkpoints (:mod:`repro_torch.ckpt.manifest`)."""
