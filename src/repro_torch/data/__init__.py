"""Datasets generated in place from a seed: the paper's evaluation sets
(``synth.py``) and the synthetic token corpus the model zoo reads
(``tokens.py``)."""
from repro_torch.data.synth import DATASETS, make_big_blobs, make_dataset
from repro_torch.data.tokens import SyntheticCorpus, input_specs, make_batch

__all__ = ["DATASETS", "make_dataset", "make_big_blobs", "SyntheticCorpus",
           "input_specs", "make_batch"]
