"""GQA flash attention: oracle, B6 forward and the public op."""
