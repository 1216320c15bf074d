from hommx_tpu_torch.meshes.simplex import (  # noqa: F401
    BoxStructure,
    SimplexMesh,
    create_box,
    create_interval,
    create_rectangle,
    create_unit_cube,
    create_unit_square,
    mesh_from_delaunay,
    mesh_from_file,
    rescale_mesh,
    rescale_mesh_in_place,
)
