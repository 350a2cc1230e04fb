"""Distribution layer, its serving half: mesh-axis collectives
(``collectives.py``, in the place of the JAX package's ``compat.py``,
which only bridges ``shard_map`` across JAX versions), the data-shard
index (``gather.py``), artifact placement (``rules.py``) and the
sharded quantized-table serving gather (``quantized.py``).  Each rank
holds plain local tensors; there is no DTensor and no ambient mesh."""
