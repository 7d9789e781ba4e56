"""Probe the webcams cv2 can open (capture indexes 0 to 9).

Counterpart of extra/list_webcams.py: prints each camera's index, size and
frame rate, or "no webcams found". cv2 is imported when it runs, and where
it is missing that raises an ``ImportError`` naming it.

Usage:
  python -m transflow_tpu_torch.tools.list_webcams
"""
import os

from ..utils.misc import require


def main(max_index: int = 10) -> list:
    """[(index, width, height, fps), ...] of the cameras that open."""
    os.environ.setdefault("OPENCV_LOG_LEVEL", "SILENT")
    cv2 = require("cv2", "listing the webcams")
    if hasattr(cv2, "setLogLevel"):
        cv2.setLogLevel(0)
    else:  # OpenCV 5 keeps it in cv2.utils.logging only
        cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
    found = []
    for index in range(max_index):
        capture = cv2.VideoCapture(index)
        if capture.isOpened():
            width = int(capture.get(cv2.CAP_PROP_FRAME_WIDTH))
            height = int(capture.get(cv2.CAP_PROP_FRAME_HEIGHT))
            fps = capture.get(cv2.CAP_PROP_FPS)
            found.append((index, width, height, fps))
            print(f"webcam {index}: {width}x{height} @ {fps:.0f} fps")
        capture.release()
    if not found:
        print("no webcams found")
    return found


if __name__ == "__main__":
    main()
