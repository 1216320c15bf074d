"""The reference's example scripts (``examples/``) on the port.

Each script mirrors its counterpart in ``examples/``: the same
configuration, coefficients written as torch callables from the same
formulas, and the same printed lines.  Each has a
``run(..., device="cuda", out=".") -> dict`` that returns every number it
prints, and a ``main(argv=None)`` that takes the example's flags plus
``--device`` (default ``cuda``) and ``--out`` (the directory for its
PNGs)::

    python3 -m hommx_tpu_torch.examples.hmm --quick --device cpu
    python3 -m hommx_tpu_torch.examples.diffusion.laminate --quick
    python3 -m hommx_tpu_torch.examples.linear_elasticity.rotated_fibers --out /tmp/png

The dtype follows the device (float32 on the card, float64 on the CPU),
but for three solves that run in float64 everywhere, as in the JAX
examples, because float32 cannot meet their purpose: the periodic solves
of ``periodic_cell_load``, the 16³ multigrid step of ``high_res_micro``
(its PCG stalls short of the example's tolerance) and the heterogeneous
512² FEM of ``laminate`` (a float32 system moves u by 3e-3).
"""
