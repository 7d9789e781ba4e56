"""Host-side helpers: paths, timestamps, sizes, file opening.
Counterpart of transflow_tpu/utils/misc.py, the same functions, and
``require``, the port's import of a library a route needs."""
import importlib
import logging
import os
import re
import subprocess
import sys
import warnings

_TS_RE = re.compile(r"(\d\d):(\d\d):(\d\d)(?:\.(\d\d\d))?")
_SUFFIX_RE = re.compile(r".*\.(\d{3})$")


def require(module: str, what: str):
    """The module ``module``, or an ``ImportError`` that names its library
    and says ``what`` needs it: the port imports cv2, aiohttp, websockets
    and tkinter only where a route runs."""
    try:
        return importlib.import_module(module)
    except ImportError as err:
        raise ImportError(f"{what} needs {module.split('.')[0]}, which does "
                          f"not load here: {err}") from err


def find_unique_path(path: str) -> str:
    """Return ``path`` or a ``.NNN``-suffixed variant that does not exist yet."""
    root, ext = os.path.splitext(path)
    if root.endswith(".flow") or root.endswith(".map"):
        root, pre_ext = os.path.splitext(root)
        ext = pre_ext + ext
    counter = 0
    m = _SUFFIX_RE.match(root)
    if m:
        counter = int(m.group(1)) + 1
        root = root[:-4]
    while os.path.isfile(path):
        path = f"{root}.{counter:03d}{ext}"
        counter += 1
    return path


def startfile(path: str):
    """Open a file with the platform's default application. Best-effort:
    a missing opener (a machine without xdg-open) logs, never raises."""
    try:
        if sys.platform == "win32":
            os.startfile(os.path.realpath(path))  # noqa  (windows only)
        else:
            opener = "open" if sys.platform == "darwin" else "xdg-open"
            subprocess.call([opener, os.path.realpath(path)])
    except OSError as exc:
        logging.getLogger(__name__).warning(
            "could not open %s with the system opener: %s", path, exc)


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
