"""kernels.device_ms_per_step: device milliseconds a step of the
program's hand-written kernels (its csrc ``__global__`` functions), the
mean over the servers' cards; nothing where none ran."""


def read(views, ctx):
    vals = [1e3 * v["kind_s"]["kernels"] / v["steps"]
            for v in views if v["steps"]]
    if not vals or not any(vals):
        return None
    return sum(vals) / len(vals)
