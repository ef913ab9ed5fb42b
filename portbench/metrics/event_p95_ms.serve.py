"""The 95th percentile of the window's event times, in ms: from `run_inference`
taking an event from the test loader to its store write returning (host
clock; ``statistics.quantiles``, inclusive). Every event of the window
counts; a 51 s window holds some 500, about 25 beyond the percentile."""

import statistics


def read(ctx):
    latency = ctx.layer.get("latency_s")
    if ctx.layer.get("entry") != "serve" or not latency or len(latency) < 2:
        return None
    return 1e3 * statistics.quantiles(latency, n=20, method="inclusive")[-1]
