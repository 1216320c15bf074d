"""Helpers shared by the ``test_torch_*`` parity tests: build the port's
objects from the JAX package's arrays, so both sides see the same state."""

import numpy as np

import hommx_tpu_torch as ht
from hommx_tpu_torch.meshes.simplex import BoxStructure


def port_mesh(jmesh) -> ht.SimplexMesh:
    """The port's SimplexMesh carrying a JAX mesh's (vertices, cells)."""
    st = jmesh.structure
    structure = None
    if st is not None:
        structure = BoxStructure(
            np.asarray(st.lo), np.asarray(st.hi), tuple(st.shape),
            st.cells_per_box, st.diagonal,
        )
    return ht.SimplexMesh(jmesh.vertices, jmesh.cells, structure)
