"""Flow subsystem of the port: estimators, sources, merge and
post-processing.

``Direction`` and ``LockMode`` are the port's own copies of the JAX
package's enums (transflow_tpu/flow/__init__.py): the same names, members
and values, pinned by tests/test_torch_model.py. An enum of one package
never equals the other's; ``from_arg`` also takes a member's name in
lower case or its int value.
"""
import enum


@enum.unique
class Direction(enum.Enum):
    """Flow direction. Parity: transflow/flow/sources/source.py:19-37."""
    FORWARD = 0   # past to present
    BACKWARD = 1  # present to past

    @classmethod
    def from_arg(cls, arg) -> "Direction":
        if arg is None:
            return cls.FORWARD
        if isinstance(arg, Direction):
            return arg
        if isinstance(arg, int):
            return cls(arg)
        if arg == "forward":
            return cls.FORWARD
        if arg == "backward":
            return cls.BACKWARD
        raise ValueError(f"Invalid flow direction: {arg}")


@enum.unique
class LockMode(enum.Enum):
    """Lock behavior. Parity: transflow/flow/sources/source.py:39-56."""
    STAY = 0
    SKIP = 1

    @classmethod
    def from_arg(cls, arg) -> "LockMode":
        if arg is None:
            return cls.STAY
        if isinstance(arg, LockMode):
            return arg
        if isinstance(arg, int):
            return cls(arg)
        if arg == "stay":
            return cls.STAY
        if arg == "skip":
            return cls.SKIP
        raise ValueError(f"Invalid lock mode: {arg}")


__all__ = ["Direction", "LockMode"]
