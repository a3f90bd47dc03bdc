"""Mamba-2 SSD chunked scan: oracle, B10 and the public op."""
