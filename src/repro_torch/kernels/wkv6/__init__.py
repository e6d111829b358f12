"""The RWKV6 (Finch) time-mix core: the WKV6 scan (kernel B7)."""
