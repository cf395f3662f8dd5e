"""device.idle_share: the share (%) of the traced window in which the
card ran nothing: 1 - (the union of its device events) / (the window),
the mean over the servers' cards."""


def read(views, ctx):
    vals = [100.0 * (1.0 - v["busy_s"] / v["window_s"])
            for v in views if v["window_s"] > 0]
    return sum(vals) / len(vals) if vals else None
