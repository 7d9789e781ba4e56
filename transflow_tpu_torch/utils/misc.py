"""Host-side parsing helpers. Counterpart of transflow_tpu/utils/misc.py
(``parse_timestamp``, ``parse_size``); the path and file-opening helpers
wait for the Pipeline."""
import re
import warnings

_TS_RE = re.compile(r"(\d\d):(\d\d):(\d\d)(?:\.(\d\d\d))?")


def parse_timestamp(timestamp: str | float | int | None) -> float | None:
    """Parse 'HH:MM:SS[.FFF]' into seconds; pass numbers/None through."""
    if timestamp is None or isinstance(timestamp, (int, float)):
        return timestamp
    m = _TS_RE.match(timestamp)
    if m is None:
        warnings.warn(f"Could not parse timestamp {timestamp}")
        return None
    hours, minutes, seconds = int(m.group(1)), int(m.group(2)), int(m.group(3))
    millis = int(m.group(4)) if m.group(4) is not None else 0
    return 3600 * hours + 60 * minutes + seconds + millis / 1000


def parse_size(size) -> tuple[int, int] | None:
    """Parse a 'WIDTHxHEIGHT' string (or passthrough tuple/list) into (w, h)."""
    if size is None:
        return None
    if isinstance(size, str):
        parts = [p for p in re.split(r"[^\d]+", size) if p]
        if len(parts) != 2:
            raise ValueError(f"Cannot parse size {size!r}, expected WIDTHxHEIGHT")
        return (int(parts[0]), int(parts[1]))
    if isinstance(size, (tuple, list)):
        return (int(size[0]), int(size[1]))
    raise ValueError(f"Cannot parse size {size!r}")
