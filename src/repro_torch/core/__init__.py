"""Core of the online feature store: the feature IR, the layout planner,
ring and bucket storage, the online store and the sharded plane."""
