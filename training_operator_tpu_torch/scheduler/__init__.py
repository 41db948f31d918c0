"""The placement solver on the card: the counterpart of the JAX package's
scheduler/packer.py batched gang solve (packer.py). Importing this package
loads nothing but itself; packer.py imports torch and numpy.
"""
