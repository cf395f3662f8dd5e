"""glue.device_ms_per_step: device milliseconds a step of PyTorch's own
kernels, copies and fills (the step glue around the program's kernels),
the mean over the servers' cards."""


def read(views, ctx):
    vals = [1e3 * v["kind_s"]["glue"] / v["steps"]
            for v in views if v["steps"]]
    return sum(vals) / len(vals) if vals else None
