"""device.idle_share (%): the share of the traced window in which no
kernel, memcpy or memset ran on the card (1 - busy / window)."""


def read(run):
    tr = run.get("trace") or {}
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
