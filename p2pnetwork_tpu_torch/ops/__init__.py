"""Aggregation primitives of the port and the CUDA segment-sum kernel."""
