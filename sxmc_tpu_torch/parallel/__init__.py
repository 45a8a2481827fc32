"""Sharding and fan-out of the PyTorch port (port of ``sxmc_tpu/parallel``):
the sharded ensemble (``ensemble``: every experiment's chains as one
batch, on one device or over a mesh's ``{exp, chain}`` blocks), device
meshes and process groups (``mesh``), the multi-process ensemble over
``torch.distributed`` (``multihost``), the event-sharded NLL and chain
(``nll_sharded``, ``chain_sharded``), the bin-sharded table
(``bin_sharded``) and sharded toy fits (``toys_sharded``).
"""
