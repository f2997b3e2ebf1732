"""Fast-VAT core on PyTorch: the ``vat``, ``ivat``, ``flashvat``,
``approx``, ``svat``, ``bigvat`` and ``dvat`` rungs' modules, the sharded
flashvat engine on ``torch.distributed``, ``StreamingVAT``, the paper's
evaluation tools (``kmeans``, ``dbscan``, ``adjusted_rand_index``, ``pca``,
``tsne``), the pure-Python oracle ``naive``, and the diagnostics of
``core/diagnostics.py`` (``activation_report``, ``embedding_tendency``,
``router_tendency``, ``TendencyReport``).

The user-facing facade with automatic method selection is
``repro_torch.api.FastVAT``.  ``torch.distributed`` is part of torch, so
the distributed module needs no import guard.
"""
from repro_torch.core.approx_mst import (AnchorCells, ApproxStats,
                                         ApproxVATResult, MSTEdges,
                                         anchor_cells, approx_vat,
                                         boruvka_mst, knn_graph_anchored,
                                         mst_vat_order)
from repro_torch.core.bigvat import (BigVATResult, bigvat, bigvat_from,
                                     expand_image, nearest_prototype_assign,
                                     smoothed_image)
from repro_torch.core.cluster import (adjusted_rand_index, dbscan, kmeans,
                                      kmeans_from, pca)
from repro_torch.core.distributed import (DVATResult, dvat,
                                          pairwise_dist_sharded,
                                          vat_matrix_free_sharded)
from repro_torch.core.hopkins import hopkins, hopkins_draws, hopkins_from_draws
from repro_torch.core.ivat import (ivat, ivat_batch, ivat_batch_from_dist,
                                   ivat_batch_from_vat, ivat_from_vat)
from repro_torch.core.streaming import StreamingVAT
from repro_torch.core.svat import (SVATResult, maximin_sample,
                                   maximin_sample_from, svat, svat_from)
from repro_torch.core.tsne import tsne, tsne_from
from repro_torch.core.vat import (FlashVATResult, VATResult,
                                  block_structure_score, reorder,
                                  reorder_batch, vat, vat_batch,
                                  vat_batch_from_dist, vat_from_dist,
                                  vat_matrix_free, vat_matrix_free_batch,
                                  vat_order, vat_order_batch)

_DIAG_NAMES = ("activation_report", "embedding_tendency", "router_tendency",
               "TendencyReport")


def __getattr__(name):
    # Lazy: the diagnostics live in repro_torch.monitor.probes, which
    # imports repro_torch.core primitives — an eager import would cycle.
    if name in _DIAG_NAMES:
        from repro_torch.core import diagnostics
        return getattr(diagnostics, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "vat", "vat_from_dist", "vat_order", "reorder", "VATResult",
    "vat_batch", "vat_batch_from_dist", "vat_order_batch", "reorder_batch",
    "vat_matrix_free", "vat_matrix_free_batch", "FlashVATResult",
    "block_structure_score", "ivat", "ivat_from_vat", "ivat_batch",
    "ivat_batch_from_dist", "ivat_batch_from_vat", "hopkins",
    "hopkins_draws", "hopkins_from_draws", "expand_image",
    "approx_vat", "ApproxVATResult", "ApproxStats", "MSTEdges",
    "boruvka_mst", "mst_vat_order", "knn_graph_anchored", "anchor_cells",
    "AnchorCells",
    "svat", "svat_from", "maximin_sample", "maximin_sample_from",
    "SVATResult", "dvat", "DVATResult", "pairwise_dist_sharded",
    "vat_matrix_free_sharded",
    "bigvat", "bigvat_from", "BigVATResult", "nearest_prototype_assign",
    "smoothed_image", "StreamingVAT",
    "kmeans", "kmeans_from", "dbscan", "adjusted_rand_index", "pca",
    "tsne", "tsne_from", *_DIAG_NAMES,
]
