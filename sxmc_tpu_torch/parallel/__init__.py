"""The sharded ensemble of the PyTorch port (``--sharded``), on one card.

Port of ``sxmc_tpu/parallel/ensemble.py``: every experiment's chains as
one batch through the experiment-grouped kernels, on the one device the
run is given (the JAX package's 1 x 1 mesh).  Running across cards and
hosts (``torch.distributed``; the JAX package's ``mesh.py``,
``multihost.py`` and the ``*_sharded.py`` modules) is ROADMAP queue A,
item 14.
"""
