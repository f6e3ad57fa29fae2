"""Workload configs of the port (the paper's Table 1 workload)."""
