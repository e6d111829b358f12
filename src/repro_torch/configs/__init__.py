"""Model configurations (shapes only; weights are made at run time)."""
