"""Single-token decode attention: oracle, B9 and the public op."""
