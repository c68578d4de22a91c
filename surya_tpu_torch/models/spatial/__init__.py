"""Spatial model families (QuadtreeCNN so far)."""
