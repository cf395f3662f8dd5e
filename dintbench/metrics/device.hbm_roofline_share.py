"""device.hbm_roofline_share: the least bytes a step of the cell must
move (`dintbench.hbm.step_bytes`, from the configuration and the mix
alone) over the servers' cards' peak bandwidth, as a share (%) of the
device-busy time a step (the union of device events, the mean over the
cards). Nothing for a card whose peak the table lacks, or for a window
with no device time."""


def read(views, ctx):
    peak = ctx["peak_bytes_s"]
    busy = [v["busy_s"] / v["steps"] for v in views if v["steps"]]
    if peak is None or not busy or sum(busy) <= 0:
        return None
    least_s = ctx["step_bytes"] / (peak * len(views))
    return 100.0 * least_s / (sum(busy) / len(busy))
