"""runner.host_ms_per_step: the host's milliseconds a step inside the
runner's ``run_draws`` (the benchmark's own span around each call, over
the traced steps), the mean over the servers' processes."""


def read(views, ctx):
    vals = [1e3 * v["host_s"].get("run_draws", 0.0) / v["steps"]
            for v in views if v["steps"]]
    return sum(vals) / len(vals) if vals else None
