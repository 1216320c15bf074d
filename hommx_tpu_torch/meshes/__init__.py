from hommx_tpu_torch.meshes.simplex import (  # noqa: F401
    BoxStructure,
    SimplexMesh,
    create_box,
    create_rectangle,
    create_unit_cube,
    create_unit_square,
)
