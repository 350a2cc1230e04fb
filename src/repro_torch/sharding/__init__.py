"""Distribution layer: mesh-axis collectives (``collectives.py``, in the
place of the JAX package's ``compat.py``, which only bridges
``shard_map`` across JAX versions), the model-parallel row gather with
its batch-sized backward and the data-shard index (``gather.py``),
placement specs for serving artifacts and recsys training state
(``rules.py``) and the sharded quantized-table serving gather
(``quantized.py``).  Each rank holds plain local tensors; there is no
DTensor and no ambient mesh."""
