"""graph_build_s (s, host clock): from the call of the port's
``Graph.from_edgelist`` to the synchronised end of its first
``G.structure``: renumbering, dedupe and symmetrisation on the host, the
CSR and CSC on the device."""


def read(run):
    return run.graph_build_s
