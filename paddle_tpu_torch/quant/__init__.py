"""Quantization helpers (KV-arena dtypes only in this slice)."""
