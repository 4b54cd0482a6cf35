"""init.recover_ms: per blackout in the traced run's untraced window, the
ms from handing the first visible frame after it to the return of the
first frame that is TRACKING again; the sum over the window's completed
recoveries over their count (slambench/window.py)."""

from slambench import window


def read(rec):
    return window.recover_ms(rec["window"])
