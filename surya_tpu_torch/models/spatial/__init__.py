"""Spatial model families: the quadtree, the hierarchical and attention
quadtrees, and the standard (ResNet and comparative multimodal) ones."""
