"""The dimensionality-reduction callback protocol (reference
python/cugraph/cugraph/internals/internals.pyx ``GraphBasedDimRedCallback``).

Counterpart of ``cugraph_tpu.internals``: ``force_atlas2(callback=...)``
(``algos/layout.py``) calls the hooks with the positions on the host.
"""

from __future__ import annotations


class GraphBasedDimRedCallback:
    """Subclass and override any hook; each receives the positions, an
    [n_vertices, 2] float32 NumPy array."""

    def on_preprocess_end(self, positions):
        pass

    def on_epoch_end(self, positions):
        pass

    def on_train_end(self, positions):
        pass
