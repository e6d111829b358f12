"""Offline half of the feature lifecycle — backfill bridge + training-set
export.

Two consumers of the same offline history (:class:`BackfillSource`):

* **Backfill** (:mod:`repro_torch.offline.backfill`): re-derives aged-out
  ring rows and bucket pre-aggregate states from per-table history and
  splices them into a migrating plane, so hot deployments that need state
  beyond the rings' retention horizon stay bit-exact instead of refusing
  or reporting ``exact=False``.
* **Export** (:mod:`repro_torch.offline.export`): point-in-time-correct
  training sets from the *same* :class:`~repro_torch.core.view.FeatureView`
  definitions that serve online, verified row for row against an online
  replay (:mod:`repro_torch.offline.check` runs that check).

The port of the reference package's ``repro.offline``.
"""

from repro_torch.offline.backfill import (
    BackfillAction,
    BackfillPlan,
    BackfillSource,
)
from repro_torch.offline.export import (
    ExportCheck,
    TrainingSet,
    export_training_set,
    sample_label_rows,
    verify_export,
)

__all__ = [
    "BackfillAction",
    "BackfillPlan",
    "BackfillSource",
    "ExportCheck",
    "TrainingSet",
    "export_training_set",
    "sample_label_rows",
    "verify_export",
]
