"""device_idle_pct: 100 x (1 - the seconds some operation ran on the card /
the traced window's seconds), from a complete traced window."""


def read(data):
    window = data["window"]
    if not window.complete() or window.window_s <= 0:
        return None
    return 100.0 * (1.0 - window.busy_s() / window.window_s)
