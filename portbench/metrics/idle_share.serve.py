"""Share of the traced serving events' wall time in which the device ran no
kernel, copy or memset: 100 x (1 - busy / wall), from the profiler's trace."""


def read(ctx):
    s = ctx.trace_summary
    if ctx.layer.get("entry") != "serve" or not s or ctx.layer.get("peaks") is None:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
