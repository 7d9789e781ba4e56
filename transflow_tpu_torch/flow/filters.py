"""The flow-filter string's grammar and the constant displacement bound
it guarantees.

Counterpart of the parts of transflow_tpu/flow/filters.py that the
Pipeline's ``--mesh``/``--halo`` setup reads (``FlowFilter.iter_specs``,
``static_clip_bound``). The filters themselves are not ported yet (ROADMAP
Queue 1, item 6): ``flow/transforms.py::make_postprocess`` refuses them.
"""


def iter_specs(filters_string: str | None) -> list[tuple[str, tuple]]:
    """Split 'name=expr;name=expr:expr;...' into (name, args) pairs."""
    if filters_string is None:
        return []
    specs = []
    for part in filters_string.strip().split(";"):
        if not part.strip():
            continue
        eq = part.index("=")
        specs.append((part[:eq].strip(),
                      tuple(part[eq + 1:].strip().split(":"))))
    return specs


def static_clip_bound(filters_string: str | None) -> float | None:
    """The constant displacement bound after the whole filter chain, else
    None: a trailing ``clip=K`` with a numeric K (a later ``threshold``
    keeps it, since it only zeroes vectors; ``scale`` and ``polar`` can
    amplify, and a time-varying K gives no static bound)."""
    bound = None
    for name, args in iter_specs(filters_string):
        if name == "clip":
            try:
                bound = float(args[0])
            except ValueError:
                bound = None
        elif name == "threshold":
            continue
        else:
            bound = None
    return bound
