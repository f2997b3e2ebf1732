"""The model zoo on PyTorch: plain functions on a params dict of tensors.

The ``dense`` and ``vlm`` families so far (``model.py``), built from
``common.py``, the GQA attention of ``attention.py`` and the dense FFN of
``moe.py``.  The model's products are plain torch, as the reference
computes them outside any Pallas kernel.
"""
