"""Import-path parity: ``cugraph.utilities``
(python/cugraph/cugraph/utilities/__init__.py), as
``cugraph_tpu.utilities``.  The functions live in
``cugraph_tpu_torch.utils``; this module only re-exports them."""

from cugraph_tpu_torch.utils import (  # noqa: F401
    MissingModule,
    create_directory_with_overwrite,
    create_random_bipartite,
    cupy_package,
    ensure_cugraph_obj,
    ensure_valid_dtype,
    get_traversed_cost,
    get_traversed_path,
    get_traversed_path_list,
    import_optional,
    is_cp_matrix_type,
    is_cugraph_graph_type,
    is_matrix_type,
    is_sp_matrix_type,
    renumber_vertex_pair,
    sample_groups,
)
