"""Causal / sliding-window grouped-query attention (kernel B6)."""
