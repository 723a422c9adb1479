"""Dataset registry (reference cugraph.datasets, python/cugraph/cugraph/
datasets/dataset.py:65).

Counterpart of ``cugraph_tpu.datasets``: nothing is downloaded.  The file
datasets read the CSVs that ship with this package under ``data/``
(``DATA_DIR``), byte-for-byte copies of the JAX package's; karate,
les_miserables, davis, florentine and petersen come from networkx, and
small_rmat and medium_rmat from the port's ``rmat``.  ``get_graph``
builds on the card unless ``create_using`` is an instance
(``Graph(device="cpu")``, say).
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


class Dataset:
    """One graph, loaded on first use (reference dataset.py:65)."""

    def __init__(self, name, loader, directed=False, weighted=False,
                 description=""):
        self.name = name
        self._loader = loader
        self._directed = directed
        self._weighted = weighted
        self.description = description
        self._edgelist = None

    def get_edgelist(self, download: bool = True, reader=None) -> pd.DataFrame:
        if self._edgelist is None:
            self._edgelist = self._loader()
        return self._edgelist.copy()

    def get_graph(self, download: bool = True, create_using=None,
                  ignore_weights: bool = False, store_transposed: bool = False):
        """The edge list in a Graph: ``Graph(directed=...)`` on the card for
        None, ``create_using()`` for a class, or the instance given."""
        from cugraph_tpu_torch.api.graph import Graph

        df = self.get_edgelist()
        if create_using is None:
            G = Graph(directed=self._directed)
        elif isinstance(create_using, type):
            G = create_using()
        else:
            G = create_using
        w = None
        if self._weighted and not ignore_weights and "wgt" in df.columns:
            w = df["wgt"].to_numpy().astype(np.float32)
        return G.from_edgelist(df["src"].to_numpy(), df["dst"].to_numpy(), w)

    def get_dask_edgelist(self, download: bool = True) -> pd.DataFrame:
        """Reference get_dask_edgelist (dataset.py:224): the same frame."""
        return self.get_edgelist(download=download)

    def get_dask_graph(self, download: bool = True, create_using=None,
                       ignore_weights: bool = False,
                       store_transposed: bool = False):
        """Reference get_dask_graph (dataset.py:332): the one-device
        Graph."""
        return self.get_graph(download=download, create_using=create_using,
                              ignore_weights=ignore_weights,
                              store_transposed=store_transposed)

    def unload(self):
        """Drop the cached edge list (reference dataset.py:154)."""
        self._edgelist = None

    def get_path(self):
        """The CSV's path for a file dataset, else None."""
        fname = getattr(self._loader, "_csv_name", None)
        return None if fname is None else os.path.join(DATA_DIR, fname)

    def is_directed(self):
        return self._directed

    def is_multigraph(self):
        return False

    def is_symmetric(self):
        return not self._directed

    def number_of_nodes(self):
        df = self.get_edgelist()
        return len(np.unique(np.concatenate([df["src"], df["dst"]])))

    def number_of_vertices(self):
        return self.number_of_nodes()

    def number_of_edges(self):
        return len(self.get_edgelist())


def _from_nx(factory, weighted=False):
    def load():
        Gnx = factory()
        src = np.array([u for u, v in Gnx.edges()])
        dst = np.array([v for u, v in Gnx.edges()])
        if isinstance(next(iter(Gnx.nodes()), 0), str):
            # node names become stable int ids, as in a CSV edge list
            names = {n: i for i, n in enumerate(sorted(Gnx.nodes()))}
            src = np.array([names[u] for u, v in Gnx.edges()])
            dst = np.array([names[v] for u, v in Gnx.edges()])
        out = {"src": src, "dst": dst}
        if weighted:
            out["wgt"] = np.array(
                [Gnx[u][v].get("weight", 1.0) for u, v in Gnx.edges()],
                dtype=np.float32)
        return pd.DataFrame(out)
    return load


def _rmat_loader(scale, edge_factor=16, seed=7):
    def load():
        from cugraph_tpu_torch.generators.rmat import rmat

        return rmat(scale, (2 ** scale) * edge_factor, seed=seed,
                    include_edge_weights=True).rename(
                        columns={"weights": "wgt"})
    return load


def _nx():
    import networkx as nx

    return nx


def _from_csv(fname, weighted=True, sep=" "):
    """A bundled public CSV: space-separated src dst wgt."""
    def load():
        df = pd.read_csv(os.path.join(DATA_DIR, fname), sep=sep,
                         header=None, names=["src", "dst", "wgt"])
        return df if weighted else df[["src", "dst"]]
    load._csv_name = fname
    return load


karate = Dataset(
    "karate", _from_nx(lambda: _nx().karate_club_graph(), weighted=True),
    weighted=True, description="Zachary karate club (34 v, 78 e)")
karate_undirected = karate
les_miserables = Dataset(
    "les_miserables",
    _from_nx(lambda: _nx().les_miserables_graph(), weighted=True),
    weighted=True, description="Les Misérables co-appearance")
davis = Dataset(
    "davis", _from_nx(lambda: _nx().davis_southern_women_graph()),
    description="Davis southern women bipartite")
florentine = Dataset(
    "florentine", _from_nx(lambda: _nx().florentine_families_graph()),
    description="Florentine families")
petersen = Dataset("petersen", _from_nx(lambda: _nx().petersen_graph()),
                   description="Petersen graph")
small_rmat = Dataset("small_rmat", _rmat_loader(10), weighted=True,
                     description="RMAT scale 10, ef 16 (synthetic)")
medium_rmat = Dataset("medium_rmat", _rmat_loader(14), weighted=True,
                      description="RMAT scale 14, ef 16 (synthetic)")
dolphins = Dataset("dolphins", _from_csv("dolphins.csv"), directed=True,
                   weighted=True,
                   description="Dolphin social network (62 v, 159 e)")
polbooks = Dataset("polbooks", _from_csv("polbooks.csv"), directed=True,
                   weighted=True,
                   description="Political books co-purchase (105 v)")
netscience = Dataset("netscience", _from_csv("netscience.csv"),
                     weighted=True,
                     description="Network-science co-authorship (1589 v)")
email_Eu_core = Dataset("email-Eu-core", _from_csv("email-Eu-core.csv"),
                        directed=True, weighted=True,
                        description="EU research institution email (1005 v)")
karate_asymmetric = Dataset("karate-asymmetric",
                            _from_csv("karate-asymmetric.csv"),
                            directed=True, weighted=True,
                            description="Karate club, asymmetric direction")
karate_disjoint = Dataset("karate-disjoint", _from_csv("karate-disjoint.csv"),
                          weighted=True,
                          description="Two disjoint karate clubs")
small_line = Dataset("small_line", _from_csv("small_line.csv"), weighted=True,
                     description="Path graph (10 v)")
small_tree = Dataset("small_tree", _from_csv("small_tree.csv"), weighted=True,
                     description="Small tree")
toy_graph = Dataset("toy_graph", _from_csv("toy_graph.csv"), directed=True,
                    weighted=True, description="6-vertex toy graph")
toy_graph_undirected = Dataset("toy_graph_undirected",
                               _from_csv("toy_graph_undirected.csv"),
                               weighted=True,
                               description="6-vertex toy graph, undirected")

ALL_DATASETS = [karate, les_miserables, davis, florentine, petersen,
                dolphins, polbooks, netscience, email_Eu_core,
                karate_asymmetric, karate_disjoint, small_line, small_tree,
                toy_graph, toy_graph_undirected, small_rmat, medium_rmat]


def get_all_datasets():
    return list(ALL_DATASETS)


_download_dir = None


def download_all(force: bool = False):
    """Reference dataset.py:447: every dataset is bundled or generated, so
    this loads each edge list (again, with ``force``)."""
    for ds in ALL_DATASETS:
        if force:
            ds.unload()
        ds.get_edgelist()


def set_download_dir(path):
    """Reference dataset.py:472: recorded; the bundled data never moves."""
    global _download_dir
    _download_dir = path


def get_download_dir():
    return _download_dir if _download_dir is not None else DATA_DIR


from cugraph_tpu_torch.datasets.readers import (  # noqa: E402
    read_csv_edgelist, read_mtx, write_csv_edgelist)
