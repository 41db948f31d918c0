"""The placement engine on the card and the gang scheduler around it: the
counterpart of the JAX package's scheduler/. packer.py holds the batched
gang solve and `TPUPacker`, the placer a scheduling cycle calls, with the
ICI sub-mesh candidates (candidates.py) and the snapshot and request types
it solves over (snapshot.py); gang.py the `GangScheduler` that admits
PodGroups through it and binds their pods, elastic.py the HPA loop and the
re-pack of resized gangs; burst.py runs the repo's bench workloads through
it. Importing this package loads nothing but itself; packer.py imports
torch and numpy.
"""
