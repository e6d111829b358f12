"""Runnable example scenarios of the port, twins of the reference
package's ``examples/*.py``::

    python -m repro_torch.examples.quickstart         [--device D]
    python -m repro_torch.examples.recommendation     [--device D]
    python -m repro_torch.examples.multi_table_fraud  [--device D]
    python -m repro_torch.examples.sharded_serving    [--device D]
    python -m repro_torch.examples.multi_scenario     [--device D]
    python -m repro_torch.examples.fraud_detection    [--steps N] [--device D]
    python -m repro_torch.examples.train_lm           [--steps N] [--device D]

Each runs the reference example's steps at its sizes on ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions), keeps its
assertions, and returns its answers from ``main(device=...)``.  Nothing
runs at import.  The sharded examples need no forced host devices: the
shard axis is a tensor axis of one device's state.  The two training
twins take ``main(steps, ..., device=...)``.
"""
