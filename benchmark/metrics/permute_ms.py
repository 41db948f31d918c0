"""Device ms per traced step of the dropless expert layer's token
permutation: the kernels under the program's `model.moe.permute` range,
which covers the dispatch and the combine in the forward and the recompute
and their backwards. The range lies inside the layer's (`model.moe`,
`model.moe.grad`), so `moe_ms` counts the same kernels too. None where the
program has no such range."""

from benchmark import moe_spans

# The program's range (training_operator_tpu_torch/observe/spans.py,
# MOE_PERMUTE), copied as moe_spans.py copies the layer's.
PERMUTE = "model.moe.permute"


def read(run):
    return moe_spans.device_ms(run, frozenset((PERMUTE,)))
