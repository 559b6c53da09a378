"""Attention ops: the Hopper kernels, their plain versions and the dispatch."""
