"""Cluster coordination: failure detection, elastic rescale, stragglers,
the restart supervisor (:mod:`repro_torch.runtime.coordinator`)."""
