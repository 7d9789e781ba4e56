"""Multi-flow merging. Counterpart of transflow_tpu/flow/merge.py; only
``first`` (the flagship's) is ported."""


def merge_first(flows):
    return flows[0]


MERGE_FUNCTIONS = {"first": merge_first}
_NOT_PORTED = ("sum", "average", "difference", "product", "maskbin",
               "masklin", "absmax")


def get_merge_function(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"flows merging function {name!r} is not ported yet: ROADMAP "
            "Queue 1, item 6 (flow post-processing)")
    if name not in MERGE_FUNCTIONS:
        raise ValueError(f"Unknown flows merging function {name!r}")
    return MERGE_FUNCTIONS[name]
