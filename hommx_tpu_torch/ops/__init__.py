"""Operators: quadrature, elements, sparse formats, assembly, solvers."""
