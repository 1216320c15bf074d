"""Diffusion examples: inclusion, laminate, periodic_cell_load, unstructured."""
