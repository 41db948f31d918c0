"""The placement engine on the card: the counterpart of the JAX package's
scheduler/packer.py (the batched gang solve and `TPUPacker`, the placer a
scheduling cycle calls) with what it reads: node records (inventory.py), the
snapshot and request types (snapshot.py) and the ICI sub-mesh candidates
(candidates.py); burst.py replays the repo's bench workloads through it.
Importing this package loads nothing but itself; packer.py imports torch and
numpy.
"""
