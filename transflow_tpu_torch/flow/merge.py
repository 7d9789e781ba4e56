"""Multi-flow merging functions.

Counterpart of transflow_tpu/flow/merge.py (parity reference:
transflow/pipeline.py:149-158 and transflow/utils.py:359-381). Every merge
is elementwise over a list of (H, W, 2) float32 flows, with the JAX
package's order of additions and products, so the two agree bit for bit.
"""
import torch

BINARIZE_THRESHOLD = 0.2  # px — parity: utils.py:368 (binarize_arrays)


def _product(flows):
    out = flows[0]
    for flow in flows[1:]:
        out = out * flow
    return out


def merge_first(flows):
    return flows[0]


def merge_sum(flows):
    return sum(flows[1:], flows[0])


def merge_average(flows):
    return merge_sum(flows) / len(flows)


def merge_difference(flows):
    return flows[0] - sum(flows[2:], flows[1]) if len(flows) > 1 else flows[0]


def merge_product(flows):
    return _product(flows)


def merge_maskbin(flows):
    masks = [(f.abs() > BINARIZE_THRESHOLD).float() for f in flows[1:]]
    return _product([flows[0]] + masks)


def merge_masklin(flows):
    return _product([flows[0]] + [f.abs() for f in flows[1:]])


def merge_absmax(flows):
    """Per-element value with the largest magnitude across all flows (the
    first flow's where several tie, as ``jnp.argmax`` picks)."""
    stack = torch.stack(flows)
    idx = torch.argmax(stack.abs(), dim=0, keepdim=True)
    return torch.take_along_dim(stack, idx, dim=0)[0]


MERGE_FUNCTIONS = {
    "first": merge_first,
    "sum": merge_sum,
    "average": merge_average,
    "difference": merge_difference,
    "product": merge_product,
    "maskbin": merge_maskbin,
    "masklin": merge_masklin,
    "absmax": merge_absmax,
}


def get_merge_function(name: str):
    if name not in MERGE_FUNCTIONS:
        raise ValueError(f"Unknown flows merging function {name!r}")
    return MERGE_FUNCTIONS[name]
