"""Fused adaptive filter-chain kernels (CUDA for sm_90a) and their twins.

``filter_chain`` holds the kernels' build, launch wrappers and plain
twins; ``ops`` the engine-facing wrappers (``ops.filter_chain``,
``ops.filter_chain_compact``); ``ref`` the dense oracle.
"""
