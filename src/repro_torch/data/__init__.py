"""Datasets of the paper's evaluation, generated in place from a seed
(``synth.py``).  The training corpus of ``repro.data`` comes with the
training stack."""
from repro_torch.data.synth import DATASETS, make_big_blobs, make_dataset

__all__ = ["DATASETS", "make_dataset", "make_big_blobs"]
