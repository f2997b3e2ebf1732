"""The model zoo on PyTorch: plain functions on a params dict of tensors.

Every family of the reference's ``repro/models``: ``dense`` and ``vlm``,
``moe`` (with MLA and MTP), ``ssm`` (RWKV-6), ``hybrid`` (Mamba2 +
shared attention) and ``audio`` (encoder–decoder), with the decode cache,
``prefill`` and ``decode_step`` (``model.py``), built from ``common.py``,
``attention.py``, ``moe.py``, ``rwkv6.py`` and ``mamba2.py``.  The
model's products are plain torch, as the reference computes them outside
any Pallas kernel.
"""
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.mamba2 import MambaState
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_params, params_from_numpy,
                                      prefill)
from repro_torch.models.rwkv6 import RWKVState

__all__ = ["KVCache", "MLACache", "MambaState", "RWKVState", "decode_step",
           "forward", "init_cache", "init_params", "params_from_numpy",
           "prefill"]
