"""Runnable example scenarios of the port, twins of the reference
package's ``examples/*.py``::

    python -m repro_torch.examples.quickstart         [--device D]
    python -m repro_torch.examples.recommendation     [--device D]
    python -m repro_torch.examples.multi_table_fraud  [--device D]
    python -m repro_torch.examples.sharded_serving    [--device D]
    python -m repro_torch.examples.multi_scenario     [--device D]

Each runs the reference example's steps at its sizes on ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions), keeps its
assertions, and returns its answers from ``main(device=...)``.  Nothing
runs at import.  The sharded examples need no forced host devices: the
shard axis is a tensor axis of one device's state.  The model-training
examples (fraud detection, LM training) wait for the training stack.
"""
